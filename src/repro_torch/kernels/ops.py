"""Public wrappers around the hand-written kernels: what
:mod:`repro_torch.core` dispatches to for ``lowering="kernel"``.

Each wrapper handles batching and layout and validates an explicit
block config against the kernel's :class:`~repro_torch.kernels.tune.TuneSpace`
*here*, at the kernel boundary: an invalid config raises ValueError
instead of failing at launch.  The kernel wrappers below them take the
plain torch version for a CPU tensor and launch the CUDA kernel for a
CUDA tensor.

The P x P Fourier matrix is built once per (P, device) and kept, with
the TF32 planes the PFB's DFT stage reads: under ``jit`` the reference
folded it into a constant, and rebuilding it per call here would be a
host-to-device copy of 8 MB at P = 1024.

The int8 wrappers (:func:`qmatmul`, :func:`qdft`, :func:`qfir`,
:func:`qpfb`) quantize activations with the same
:func:`~repro_torch.core.quantize.quantize_symmetric` as the torch
integer path (or inside the kernel, per window), so every one of them is
bit-identical to it; the int8 Fourier matrix is quantized once per
(n, inverse) and uploaded once per device, with the K-major copies the
int8 GEMM and DFT take.

Unlike the reference's wrappers these do not pad to block multiples:
the kernels mask their own ragged edges (the f32 DFT's F planes are
padded once, with the DFM, and the f32 GEMM's y planes once per plan
const; an x whose rows TMA cannot read is copied into padded rows by the
kernel wrapper).  A kernel takes contiguous inputs, so a wrapper handed
a strided view (``frame_decimate`` after ``unfold``, ``real`` after
``idft``, ``downsample`` before a FIR or a PFB) makes it contiguous
first, a copy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import made_once
from repro_torch.core import quantize
from repro_torch.kernels import dft as dft_kernel
from repro_torch.kernels import elementwise as ew_kernel
from repro_torch.kernels import fir as fir_kernel
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.kernels import pfb as pfb_kernel
from repro_torch.kernels import tune
from repro_torch.kernels import unfold as unfold_kernel


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


@made_once(16)
def _fourier_planes(p: int, device: str) -> torch.Tensor:
    """The PFB's DFT stage's F side: ``dft.tf32_planes`` of
    :func:`_fourier`'s own (fr, fi) at 4mult, made once per (P, device)
    and read from any stream."""
    return dft_kernel.tf32_planes(*_fourier(p, device), "4mult")


def _frames(x: torch.Tensor, p: int) -> torch.Tensor:
    """(..., n_samples) -> contiguous (rows, n_samples / P, P) frames."""
    return x.reshape((-1, x.shape[-1] // p, p)).contiguous()


def pfb_fir(frames: torch.Tensor, taps: torch.Tensor, *,
            bt: int | None = None, bn: int | None = None) -> torch.Tensor:
    """Frontend only: (..., T, P), (M, P) -> (..., T - M + 1, P), one
    launch of the PFB's frontend kernel.  ``bt`` / ``bn`` are checked
    against the pfb space (the reference's signature) and unused: the
    frontend has no tile."""
    m, p = taps.shape
    batch = frames.shape[:-2]
    t = frames.shape[-2]
    _resolve(pfb_kernel.TUNE_SPACE, {"m": m, "p": p, "t": t}, bt=bt, bn=bn)
    f3 = frames.reshape((-1, t, p)).contiguous()
    y = pfb_kernel.pfb_frontend(f3, taps.flip(0).to(f3.dtype).contiguous())
    return y.reshape(batch + (t - m + 1, p))


def pfb(x: torch.Tensor, taps: torch.Tensor, *, variant: str = "4mult",
        bt: int | None = None, bn: int | None = None) -> torch.Tensor:
    """Full PFB: (..., n_samples), (M, P) -> complex64
    (..., n_frames - M + 1, P), one call of the PFB kernels (the
    frontend, then the DFT stage against the DFM's TF32 planes, made once
    per (P, device), computing half the columns and conjugating the
    rest; at an even P past 32 over P/2 folded pairs of mirrored
    branches, ``pfb_kernel.folds``).  ``variant`` is accepted for the
    reference's signature: a real y needs two real products, so 3mult and
    4mult are the same kernel."""
    del variant
    m, p = taps.shape
    if x.shape[-1] % p:
        raise ValueError(f"n_samples {x.shape[-1]} not divisible by P={p}")
    batch = x.shape[:-1]
    frames = _frames(x, p)
    t = frames.shape[1]
    cfg = _resolve(pfb_kernel.TUNE_SPACE, {"m": m, "p": p, "t": t},
                   bt=bt, bn=bn)
    dev = str(frames.device)
    fr, fi = _fourier(p, dev)
    planes = _fourier_planes(p, dev) if frames.is_cuda else None
    z = pfb_kernel.pfb_fused(frames, taps.flip(0).to(frames.dtype).contiguous(),
                             fr, fi, planes=planes, hermitian=True, **cfg)
    return z.reshape(batch + (t - m + 1, p))


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           yt_planes: torch.Tensor | None = None,
           yt: torch.Tensor | None = None, bm: int | None = None,
           bn: int | None = None, bk: int | None = None,
           order: str | None = None) -> torch.Tensor:
    """x (..., M, L) @ y (L, N) through the GEMM kernel of their dtype,
    the leading dims of x flattened into rows: the fp32 kernel (its tile
    from its tune space) or, for bfloat16 operands, the bf16 kernel (its
    one compiled tile).  ``yt_planes`` (fp32): y's TF32 planes
    (``mm_kernel.tf32_planes``); ``yt`` (bf16): y's K-major copy (N, L);
    each made once by a caller whose y is a constant, or None to make it
    per call."""
    if x.ndim < 2 or y.ndim != 2:
        raise ValueError(f"matmul: x {tuple(x.shape)} must be (..., M, L) "
                         f"and y {tuple(y.shape)} (L, N)")
    m, l = x.shape[-2], x.shape[-1]
    n = y.shape[1]
    x2 = x.reshape((-1, l)).contiguous()
    if x.dtype == torch.bfloat16 and y.dtype == torch.bfloat16:
        order = order or "mn"
        bm, bn, bk = mm_kernel.bf16_tile(bm, bn, bk, order)
        out = mm_kernel.matmul(x2, y, yt=yt, bm=bm, bn=bn, bk=bk,
                               order=order)
    else:
        cfg = _resolve(mm_kernel.TUNE_SPACE,
                       {"m": tune.leading_rows(x.shape), "n": n, "k": l},
                       bm=bm, bn=bn, bk=bk, order=order)
        out = mm_kernel.matmul(x2, y.contiguous(), yt_planes=yt_planes,
                               **cfg)
    return out.reshape(x.shape[:-2] + (m, n))


def fir(x: torch.Tensor, kern: torch.Tensor, *, pad_left: int = 0,
        pad_right: int = 0, flip: bool = False, bn: int | None = None,
        threads: int | None = None) -> torch.Tensor:
    """Cross-correlation of the rows of x (..., N) with ``kern`` (K), or
    with ``kern`` reversed for ``flip`` (a true convolution), between
    ``pad_left`` and ``pad_right`` zeros, through the FIR kernel.  The
    padding and the reversal are implicit in the kernel: no padded copy
    of x and no reversed copy of the taps is made."""
    n = x.shape[-1]
    cfg = _resolve(fir_kernel.TUNE_SPACE,
                   {"k": kern.shape[0], "n": n,
                    "rows": tune.leading_rows(x.shape)},
                   bn=bn, threads=threads)
    out = fir_kernel.fir_valid(x.reshape((-1, n)).contiguous(),
                               kern.contiguous(), pad_left=pad_left,
                               pad_right=pad_right, flip=flip, **cfg)
    return out.reshape(x.shape[:-1] + (out.shape[-1],))


def _binary(x: torch.Tensor, y: torch.Tensor, op: str,
            threads: int | None) -> torch.Tensor:
    """x op y with y broadcast to x's shape: y either of the result's
    shape or one row along the last axis goes to the kernel as it is;
    any other broadcast is materialised first."""
    shape = torch.broadcast_shapes(x.shape, y.shape)
    cols = shape[-1] if len(shape) else 1
    cfg = _resolve(ew_kernel.TUNE_SPACE,
                   {"rows": tune.leading_rows(shape), "cols": cols,
                    "n_in": 2}, threads=threads)
    x = x.expand(shape).contiguous()
    if (tuple(y.shape) != tuple(shape) and y.ndim
            and y.shape[-1] == cols and y.numel() == cols):
        y = y.reshape(cols).contiguous()          # a row: the kernel's i % C
    else:
        y = y.expand(shape).contiguous()
    fn = (ew_kernel.elementwise_mult if op == "mul"
          else ew_kernel.elementwise_add)
    return fn(x, y, **cfg)


def elementwise_mult(x: torch.Tensor, y: torch.Tensor, *,
                     threads: int | None = None) -> torch.Tensor:
    """x * y (broadcast) in one launch of the binary kernel."""
    return _binary(x, y, "mul", threads)


def elementwise_add(x: torch.Tensor, y: torch.Tensor, *,
                    threads: int | None = None) -> torch.Tensor:
    """x + y (broadcast) in one launch of the binary kernel."""
    return _binary(x, y, "add", threads)


def fused_elementwise(x: torch.Tensor, operands: tuple, steps: tuple, *,
                      threads: int | None = None) -> torch.Tensor:
    """Fused elementwise chain -- the planner's entry point (one kernel
    launch for a whole run of adjacent elementwise graph nodes).

    ``steps``, in order:
      ("abs2",)     only as first step: re² + im² of a complex x, x·x of
                    a real one
      ("mul",) / ("add",) -- consumes the next array from ``operands``
      ("scale", c)  multiply by a python scalar
    Operands are broadcast to x's shape."""
    abs2_head = bool(steps) and steps[0][0] == "abs2"
    rest = tuple(steps[1:] if abs2_head else steps)
    if abs2_head:
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
           "n_in": (2 if x.is_complex() else 1) + len(ops)}
    cfg = _resolve(ew_kernel.TUNE_SPACE, ctx, threads=threads)
    return ew_kernel.elementwise_chain(head, ops, rest, abs2_head=abs2_head,
                                       **cfg)


def abs2(x: torch.Tensor, *, threads: int | None = None) -> torch.Tensor:
    """|x|² in one fused kernel: re² + im² of a complex x, x·x of a real
    one."""
    return fused_elementwise(x, (), (("abs2",),), threads=threads)


def dft(x: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor, *,
        variant: str = "3mult", bm: int | None = None,
        bn: int | None = None,
        planes: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L) complex or real signal rows through the blocked DFT kernel
    against fr + i fi (L, N) -> complex64 (B, N).  The reference's
    ``ops.dft`` takes and returns (re, im) planes; here a complex64 input
    is read interleaved and a real one has no imaginary plane at all.
    ``planes``: the kernel's TF32 split of (fr, fi), made once by the
    caller (``dft_kernel.tf32_planes``), or None to split per call."""
    b, l = x.shape
    n = fr.shape[1]
    cfg = _resolve(dft_kernel.TUNE_SPACE, {"m": b, "n": n, "k": l},
                   bm=bm, bn=bn)
    return dft_kernel.dft(x.contiguous(), fr, fi, variant=variant,
                          planes=planes, **cfg)


def unfold(x: torch.Tensor, window: int, *, bt: int | None = None,
           bj: int | None = None) -> torch.Tensor:
    """(..., N) -> (..., N − J + 1, J), y[.., t, j] = x[.., t + j]: the
    whole window tensor written by the unfold kernel."""
    batch = x.shape[:-1]
    n = x.shape[-1]
    cfg = _resolve(unfold_kernel.TUNE_SPACE,
                   {"j": window, "n": n, "rows": tune.leading_rows(x.shape)},
                   bt=bt, bj=bj)
    out = unfold_kernel.unfold(x.reshape((-1, n)).contiguous(), window,
                               **cfg)
    return out.reshape(batch + (n - window + 1, window))


def overlap_add(frames: torch.Tensor, hop: int, *,
                threads: int | None = None) -> torch.Tensor:
    """frames (..., T, J) with hop | J -> (..., (T − J/hop + 1) · hop)
    through the overlap-add kernel (unfold's adjoint)."""
    t, j = frames.shape[-2], frames.shape[-1]
    batch = frames.shape[:-2]
    rows = tune.leading_rows(frames.shape[:-1])   # prod(batch)
    cfg = _resolve(unfold_kernel.OLA_TUNE_SPACE,
                   {"j": j, "hop": hop, "k": j // hop, "t": t, "rows": rows},
                   threads=threads)
    out = unfold_kernel.overlap_add(frames.reshape((-1, t, j)).contiguous(),
                                    hop, **cfg)
    return out.reshape(batch + (out.shape[-1],))


# ---------------------------------------------------------------------------
# int8 wrappers: the qimpl lowering targets
# ---------------------------------------------------------------------------
def qmatmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, *,
            wt: torch.Tensor | None = None, bm: int | None = None,
            bn: int | None = None, bk: int | None = None) -> torch.Tensor:
    """x (..., L) float against an int8 (L, N) weight with per-column
    scales: per-row activation quantization (quantize.qmatmul's
    convention), then one launch of the int8 GEMM.  ``wt``: the weight's
    K-major copy (N, L) where it was made once (the qprep pack), else
    None and the kernel wrapper makes it per call."""
    l = x.shape[-1]
    n = wq.shape[1]
    cfg = _resolve(mm_kernel.TUNE_SPACE_INT8,
                   {"m": tune.leading_rows(x.shape), "n": n, "k": l},
                   bm=bm, bn=bn, bk=bk)
    xq, sx = quantize.quantize_symmetric(x.reshape((-1, l)), axis=-1)
    out = mm_kernel.matmul_int8(xq, wq.contiguous(), sx.reshape(-1),
                                w_scale.reshape(-1).contiguous(), yt=wt,
                                **cfg)
    return out.reshape(x.shape[:-1] + (n,))


def qdft(x: torch.Tensor, *, inverse: bool = False, bm: int | None = None,
         bn: int | None = None, bk: int | None = None) -> torch.Tensor:
    """(I)DFT with the int8-quantized Fourier matrix: a real signal runs
    the shared-x dft_int8 kernel (one launch, both matrices); a complex
    one expands to the 4-real-matmul form through four launches of
    matmul_int8, its real and imaginary rows quantized once each.  Both
    kernels take the DFM's K-major copies, made once per device.  Each
    product is rounded to f32 before the cross-term combine.  The tile
    comes from the space of the kernel that runs: dft_int8's for a real
    x, matmul_int8's for a complex one."""
    n = x.shape[-1]
    qr, sr, qi, si = quantize._qdfm_tensors(n, inverse, str(x.device))
    qrt, qit = quantize._qdfm_kmajor(n, inverse, str(x.device))
    ctx = {"m": tune.leading_rows(x.shape), "n": n, "k": n}
    x2 = x.reshape((-1, n))
    if x2.is_complex():
        cfg = _resolve(mm_kernel.TUNE_SPACE_INT8, ctx, bm=bm, bn=bn, bk=bk)
        zrq, szr = quantize.quantize_symmetric(
            x2.real.to(torch.float32), axis=-1)
        ziq, szi = quantize.quantize_symmetric(
            x2.imag.to(torch.float32), axis=-1)
        szr, szi = szr.reshape(-1), szi.reshape(-1)

        def mm(xq, sx, wq, sw, wt):
            return mm_kernel.matmul_int8(xq, wq, sx, sw, yt=wt, **cfg)

        out = torch.complex(
            mm(zrq, szr, qr, sr, qrt) - mm(ziq, szi, qi, si, qit),
            mm(zrq, szr, qi, si, qit) + mm(ziq, szi, qr, sr, qrt))
    else:
        cfg = _resolve(dft_kernel.TUNE_SPACE_INT8, ctx, bm=bm, bn=bn, bk=bk)
        xq, sx = quantize.quantize_symmetric(x2, axis=-1)
        out = dft_kernel.dft_int8(xq, qr, qi, sx.reshape(-1), sr, si,
                                  frt=qrt, fit=qit, **cfg)
    return out.reshape(x.shape[:-1] + (n,))


def qfir(x: torch.Tensor, tq: torch.Tensor, ts: torch.Tensor, *,
         bn: int | None = None, threads: int | None = None) -> torch.Tensor:
    """'valid' FIR against a quantize_fir_taps pack ((K, 1) int8 taps,
    already reversed for a true FIR, and their (1, 1) scale); each window
    is quantized inside the kernel."""
    k = tq.shape[0]
    n = x.shape[-1]
    cfg = _resolve(fir_kernel.TUNE_SPACE_INT8,
                   {"k": k, "n": n, "rows": tune.leading_rows(x.shape)},
                   bn=bn, threads=threads)
    out = fir_kernel.fir_valid_int8(
        x.reshape((-1, n)).contiguous(), tq.reshape(-1).contiguous(),
        ts.reshape(1).contiguous(), **cfg)
    return out.reshape(x.shape[:-1] + (n - k + 1,))


def qpfb(x: torch.Tensor, tq: torch.Tensor, ts: torch.Tensor, *,
         bt: int | None = None, bn: int | None = None) -> torch.Tensor:
    """Full fused int8 PFB against a quantize_pfb_taps pack ((M, P) int8
    reversed prototype and its (1, P) scales): (..., n_samples) ->
    complex64 (..., n_frames − M + 1, P), one call of the fused kernel
    (its frontend and its s8 DFT, fed the int8 DFM's K-major copies)."""
    m, p = tq.shape
    if x.shape[-1] % p:
        raise ValueError(f"n_samples {x.shape[-1]} not divisible by P={p}")
    batch = x.shape[:-1]
    frames = _frames(x.to(torch.float32), p)
    t = frames.shape[1]
    cfg = _resolve(pfb_kernel.TUNE_SPACE_INT8, {"m": m, "p": p, "t": t},
                   bt=bt, bn=bn)
    qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(frames.device))
    qrt, qit = quantize._qdfm_kmajor(p, False, str(frames.device))
    z = pfb_kernel.pfb_fused_int8(frames, tq.contiguous(),
                                  ts.reshape(-1).contiguous(), qr, qi, sr, si,
                                  frt=qrt, fit=qit, **cfg)
    return z.reshape(batch + (t - m + 1, p))


__all__ = ["matmul", "fir", "pfb_fir", "pfb", "fused_elementwise", "abs2",
           "elementwise_mult", "elementwise_add", "dft", "unfold",
           "overlap_add", "qmatmul", "qdft", "qfir", "qpfb"]
