"""Elementwise kernels: the fused chain (a whole run of adjacent
elementwise graph nodes in one pass over memory) and the plain binary
x*y / x+y.

The CUDA kernels are in ``csrc/elementwise.cu``: ``tina_chain`` replaces
the JAX reference's ``kernels/elementwise.py:elementwise_chain`` and
``tina_binary`` its ``_binary`` (behind ``elementwise_mult`` and
``elementwise_add``); the source says what bounds them and how.
:func:`elementwise_chain`, :func:`elementwise_mult` and
:func:`elementwise_add` launch them for a CUDA tensor and run their
plain versions for a CPU tensor.  Both kernels share the one
``"elementwise"`` tune space (threads per block), as the reference's
binary and chain kernels share theirs.

``steps`` is a tuple of tags applied in order to an accumulator:
  ("mul",)        acc *= next operand
  ("add",)        acc += next operand
  ("scale", c)    acc *= c
``abs2_head=True``: the chain starts from acc = re² + im² of a complex
head, or x·x of a real one (the reference's re² + 0², bit for bit).
The chain reaches the kernel as data, so a new chain needs no
recompile.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tune

MAX_STEPS = 8                        # csrc/elementwise.cu: MAX_STEPS
_CODES = {"mul": 0, "add": 1, "scale": 2}

LAUNCHES = 0         # chain launches since the last reset (plain excluded)
BINARY_LAUNCHES = 0  # binary (mult / add) launches since the last reset
_BINARY_CODES = {"mul": 0, "add": 1}

# ctx: {"rows", "cols", "n_in"}.  The kernel walks the flat elements in a
# grid-stride loop, so the one tunable is the threads per block: a
# multiple of the warp within the per-block limit.
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="elementwise",
    params=("threads",),
    candidates=lambda ctx: tuple({"threads": t} for t in (128, 256, 512,
                                                           1024)),
    valid=lambda cfg, ctx: (
        0 < cfg["threads"] <= tune.MAX_THREADS
        and cfg["threads"] % tune.WARP == 0),
    default=lambda ctx: {"threads": 256},
))


def _check_steps(steps) -> None:
    if len(steps) > MAX_STEPS:
        raise ValueError(f"elementwise_chain: {len(steps)} steps > "
                         f"{MAX_STEPS}")
    for step in steps:
        if step[0] not in _CODES:
            raise ValueError(f"unknown chain step {step[0]!r}")


def elementwise_chain_plain(head: torch.Tensor, operands, steps, *,
                            abs2_head: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, one rounding per step."""
    _check_steps(steps)
    if abs2_head and head.is_complex():
        v = torch.view_as_real(head)
        re, im = v[..., 0], v[..., 1]
        acc = re * re + im * im
    elif abs2_head:
        acc = head * head
    else:
        acc = head
    k = 0
    for step in steps:
        if step[0] == "mul":
            acc = acc * operands[k]
            k += 1
        elif step[0] == "add":
            acc = acc + operands[k]
            k += 1
        else:
            acc = acc * step[1]
    return acc


def elementwise_chain(head: torch.Tensor, operands=(), steps=(), *,
                      abs2_head: bool = False,
                      threads: int = 256) -> torch.Tensor:
    """Apply a fused chain in one kernel launch.

    ``head``: float32, or complex64 with ``abs2_head``; ``operands``:
    one float32 tensor of the head's shape per mul/add step.  All
    contiguous.
    A CPU tensor runs :func:`elementwise_chain_plain`; a CUDA tensor
    launches the kernel on the current stream or raises."""
    operands = tuple(operands)
    dev = head.device
    if dev.type == "cpu":
        return elementwise_chain_plain(head, operands, steps,
                                       abs2_head=abs2_head)
    if dev.type != "cuda":
        raise ValueError(f"elementwise_chain: no kernel for device {dev}")
    _check_steps(steps)
    if head.dtype == torch.complex64 and abs2_head:
        mode = 1                                  # re² + im²
    elif head.dtype == torch.float32:
        mode = 2 if abs2_head else 0              # x·x, or x
    else:
        raise TypeError(
            f"elementwise_chain: head must be float32"
            f"{' or complex64' if abs2_head else ''}, got {head.dtype}")
    n_ops = sum(1 for s in steps if s[0] in ("mul", "add"))
    if len(operands) != n_ops:
        raise ValueError(f"elementwise_chain: {n_ops} mul/add steps but "
                         f"{len(operands)} operands")
    for t in (head, *operands):
        if not t.is_contiguous():
            raise ValueError("elementwise_chain: inputs must be contiguous")
        if t.device != dev:
            raise ValueError(f"elementwise_chain: input on {t.device}, "
                             f"head on {dev}")
    for o in operands:
        if o.dtype != torch.float32 or o.shape != head.shape:
            raise ValueError(
                f"elementwise_chain: operand {o.dtype}{tuple(o.shape)} must "
                f"be float32{tuple(head.shape)}")
    _check_threads("elementwise_chain", threads)
    out = torch.empty(head.shape, device=dev, dtype=torch.float32)
    n = head.numel()
    codes = (ctypes.c_int * MAX_STEPS)(*(_CODES[s[0]] for s in steps))
    consts = (ctypes.c_float * MAX_STEPS)(
        *(float(s[1]) if s[0] == "scale" else 0.0 for s in steps))
    ptrs = (ctypes.c_void_p * MAX_STEPS)(*(o.data_ptr() for o in operands))
    lib = _build.lib()
    code = lib.tina_chain(
        head.data_ptr(), mode, n, codes, consts, ptrs, len(steps),
        out.data_ptr(), threads, torch.cuda.current_stream(dev).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "elementwise_chain")
    return out


def _check_threads(what: str, threads: int) -> None:
    if not (0 < threads <= tune.MAX_THREADS and threads % tune.WARP == 0):
        raise ValueError(f"{what}: threads={threads}")


def elementwise_binary_plain(x: torch.Tensor, y: torch.Tensor,
                             op: str) -> torch.Tensor:
    """The binary kernel's arithmetic in plain torch: x*y or x+y, with
    y broadcast over x."""
    if op not in _BINARY_CODES:
        raise ValueError(f"unknown binary op {op!r}")
    return x * y if op == "mul" else x + y


def _binary(x: torch.Tensor, y: torch.Tensor, op: str,
            threads: int) -> torch.Tensor:
    """x (..., C) float32, y of x's shape or a 1-D row of C values ->
    x op y; any other y raises on either device (``kernels.ops`` makes
    every broadcast one of these two).  A CPU tensor runs
    :func:`elementwise_binary_plain`; a CUDA tensor launches
    ``tina_binary`` on the current stream or raises.  Both must be
    contiguous: a caller holding a strided view makes it contiguous first
    (``kernels.ops`` does)."""
    cols = x.shape[-1] if x.ndim else 1
    row = tuple(y.shape) != tuple(x.shape)
    if row and (y.ndim != 1 or y.numel() != cols):
        raise ValueError(f"elementwise_{op}: y {tuple(y.shape)} is neither "
                         f"x's shape {tuple(x.shape)} nor a row of {cols}")
    dev = x.device
    if dev.type == "cpu":
        return elementwise_binary_plain(x, y, op)
    if dev.type != "cuda":
        raise ValueError(f"elementwise_{op}: no kernel for device {dev}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"elementwise_{op}: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"elementwise_{op}: {name} on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"elementwise_{op}: {name} must be contiguous")
    _check_threads(f"elementwise_{op}", threads)
    out = torch.empty(x.shape, device=dev, dtype=torch.float32)
    code = _build.lib().tina_binary(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), max(cols, 1),
        int(row), _BINARY_CODES[op], threads,
        torch.cuda.current_stream(dev).cuda_stream)
    global BINARY_LAUNCHES
    BINARY_LAUNCHES += 1
    _build.check(code, f"elementwise_{op}")
    return out


def elementwise_mult(x: torch.Tensor, y: torch.Tensor, *,
                     threads: int = 256) -> torch.Tensor:
    """x * y in one launch of the binary kernel (see :func:`_binary`)."""
    return _binary(x, y, "mul", threads)


def elementwise_add(x: torch.Tensor, y: torch.Tensor, *,
                    threads: int = 256) -> torch.Tensor:
    """x + y in one launch of the binary kernel (see :func:`_binary`)."""
    return _binary(x, y, "add", threads)


__all__ = ["elementwise_chain", "elementwise_chain_plain",
           "elementwise_mult", "elementwise_add", "elementwise_binary_plain",
           "TUNE_SPACE", "LAUNCHES", "BINARY_LAUNCHES", "MAX_STEPS"]
