"""peak_mem_gib (GiB): the program's peak over the measured window:
torch.cuda.max_memory_allocated() (reset at the window's start) less
what the harness holds there, the input pool and the outputs kept for
the check (both fixed by the cell's shapes).  What is left is the
runner's carry, the plans' constants, the calls in flight and what the
program allocates for a call.  A kept output that is still in flight is
subtracted too, so the reading is low by at most the in-flight
outputs among the kept ones."""


def read(w):
    if not w.peak_mem_bytes:
        return None
    return (w.peak_mem_bytes - w.harness_bytes) / 2 ** 30
