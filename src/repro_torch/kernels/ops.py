"""Public wrappers around the hand-written kernels: what
:mod:`repro_torch.core` dispatches to for ``lowering="kernel"``.

Each wrapper handles batching and layout and validates an explicit
block config against the kernel's :class:`~repro_torch.kernels.tune.TuneSpace`
*here*, at the kernel boundary: an invalid config raises ValueError
instead of failing at launch.  The kernel wrappers below them take the
plain torch version for a CPU tensor and launch the CUDA kernel for a
CUDA tensor.

The P x P Fourier matrix is built once per (P, device) and kept: under
``jit`` the reference folded it into a constant, and rebuilding it per
call here would be a host-to-device copy of 8 MB at P = 1024.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import elementwise as ew_kernel
from repro_torch.kernels import pfb as pfb_kernel
from repro_torch.kernels import tune


def _resolve(space: tune.TuneSpace, ctx: dict, **explicit) -> dict:
    """Fill missing block params from the space default and validate the
    result (ValueError on an invalid explicit config)."""
    return space.check(
        {k: v for k, v in explicit.items() if v is not None}, ctx)


@functools.lru_cache(maxsize=16)
def _fourier(p: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(fr, fi) of F[l, k] = exp(-2πi l k / p) as float32 on ``device``."""
    lk = np.outer(np.arange(p), np.arange(p))
    f = np.exp(-2j * np.pi * lk / p)
    return (torch.as_tensor(f.real.astype(np.float32), device=device),
            torch.as_tensor(f.imag.astype(np.float32), device=device))


@functools.lru_cache(maxsize=16)
def _eye(p: int, device: str) -> torch.Tensor:
    return torch.eye(p, dtype=torch.float32, device=device)


def _frames(x: torch.Tensor, p: int) -> torch.Tensor:
    """(..., n_samples) -> contiguous (rows, n_samples / P, P) frames."""
    return x.reshape((-1, x.shape[-1] // p, p)).contiguous()


def pfb_fir(frames: torch.Tensor, taps: torch.Tensor, *,
            bt: int | None = None, bn: int | None = None) -> torch.Tensor:
    """Frontend only: (..., T, P), (M, P) -> (..., T - M + 1, P).
    Runs the fused kernel with the identity 'DFT' (F = I) so the FIR
    path is exercised."""
    m, p = taps.shape
    batch = frames.shape[:-2]
    t = frames.shape[-2]
    cfg = _resolve(pfb_kernel.TUNE_SPACE, {"m": m, "p": p, "t": t},
                   bt=bt, bn=bn)
    f3 = frames.reshape((-1, t, p)).contiguous()
    eye = _eye(p, str(f3.device))
    y = pfb_kernel.pfb_fused(f3, taps.flip(0).to(f3.dtype).contiguous(), eye,
                             None, **cfg)
    return y.reshape(batch + (t - m + 1, p))


def pfb(x: torch.Tensor, taps: torch.Tensor, *, variant: str = "4mult",
        bt: int | None = None, bn: int | None = None) -> torch.Tensor:
    """Full fused PFB: (..., n_samples), (M, P) -> complex64
    (..., n_frames - M + 1, P).  ``variant`` is accepted for the
    reference's signature: a real input needs two real products, so
    3mult and 4mult are the same kernel."""
    del variant
    m, p = taps.shape
    if x.shape[-1] % p:
        raise ValueError(f"n_samples {x.shape[-1]} not divisible by P={p}")
    batch = x.shape[:-1]
    frames = _frames(x, p)
    t = frames.shape[1]
    cfg = _resolve(pfb_kernel.TUNE_SPACE, {"m": m, "p": p, "t": t},
                   bt=bt, bn=bn)
    fr, fi = _fourier(p, str(frames.device))
    z = pfb_kernel.pfb_fused(frames, taps.flip(0).to(frames.dtype).contiguous(),
                             fr, fi, **cfg)
    return z.reshape(batch + (t - m + 1, p))


def fused_elementwise(x: torch.Tensor, operands: tuple, steps: tuple, *,
                      threads: int | None = None) -> torch.Tensor:
    """Fused elementwise chain -- the planner's entry point (one kernel
    launch for a whole run of adjacent elementwise graph nodes).

    ``steps``, in order:
      ("abs2",)     only as first step; x must be complex, out = re²+im²
      ("mul",) / ("add",) -- consumes the next array from ``operands``
      ("scale", c)  multiply by a python scalar
    Operands are broadcast to x's shape."""
    abs2_head = bool(steps) and steps[0][0] == "abs2"
    rest = tuple(steps[1:] if abs2_head else steps)
    if abs2_head:
        if not x.is_complex():
            raise ValueError("fused_elementwise: abs2 head needs a complex "
                             "input")
        shape = x.shape
        head = x.contiguous()
    else:
        if x.is_complex():
            raise ValueError("fused_elementwise: complex input requires an "
                             "abs2 head step")
        shape = torch.broadcast_shapes(x.shape, *(o.shape for o in operands))
        head = x.expand(shape).contiguous()
    ops = tuple(o.expand(shape).contiguous() for o in operands)
    ctx = {"rows": tune.leading_rows(shape),
           "cols": shape[-1] if len(shape) else 1,
           "n_in": (2 if abs2_head else 1) + len(ops)}
    cfg = _resolve(ew_kernel.TUNE_SPACE, ctx, threads=threads)
    return ew_kernel.elementwise_chain(head, ops, rest, abs2_head=abs2_head,
                                       **cfg)


def abs2(x: torch.Tensor, *, threads: int | None = None) -> torch.Tensor:
    """|x|² of a complex tensor in one fused kernel (re² + im²)."""
    return fused_elementwise(x, (), (("abs2",),), threads=threads)


__all__ = ["pfb_fir", "pfb", "fused_elementwise", "abs2"]
