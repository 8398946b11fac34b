"""The work a call needs, counted from its shapes, and the least time one
card could take for it.

The counting rule is the one the port's kernel table has always used
for its bound column (PERF.md §6): max(bytes / 3.35 TB/s, ops / peak),
each input read and output written once, f32 products at TF32, the
PFB's FIR at the fp32 pipe, a real input counting DFT columns 0..N/2:

* bytes: each input of the op read once and each output written once,
  whatever the kernels read again or stage in between;
* operations: each at the peak of the pipe the op's precision runs on,
  the seconds of different pipes added;
* the bound is the larger of the bytes' seconds and the operations'.

A count belongs to the op and its shapes, never to the kernels that
implement it: a later kernel that fuses or splits an op is judged on the
same work.  Peaks are in :mod:`counts.peaks`.
"""
from __future__ import annotations

import dataclasses

from counts import peaks


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and operations by pipe (``peaks.PIPES`` names)."""
    bytes: float
    ops: tuple[tuple[str, float], ...] = ()

    def seconds(self) -> float:
        """The least time on one card: max(bytes at HBM, ops at peak)."""
        t_ops = sum(n / peaks.PIPES[pipe] for pipe, n in self.ops)
        return max(self.bytes / peaks.HBM_BYTES_PER_S, t_ops)

    def __add__(self, other: "Work") -> "Work":
        ops: dict[str, float] = dict(self.ops)
        for pipe, n in other.ops:
            ops[pipe] = ops.get(pipe, 0.0) + n
        return Work(self.bytes + other.bytes, tuple(sorted(ops.items())))


__all__ = ["Work", "peaks"]
