"""Fused polyphase filter bank kernel: the FIR bank over frames feeding
the DFT across branches, with the subfiltered signal kept on chip.

The CUDA kernel is ``csrc/pfb.cu`` (it replaces the JAX reference's
``kernels/pfb.py:pfb_fused``; the source says what bounds it and how).
:func:`pfb_fused` launches it for a CUDA tensor and runs
:func:`pfb_fused_plain`, the same arithmetic in plain torch, for a CPU
tensor.  Unlike the TPU kernel it needs no padded frame axis, no halo
constraint between taps and the frame block, and no column blocking
that divides N: the kernel loads its own halo rows and masks every
ragged edge.

:func:`pfb_fused_int8` is the int8 tier's fused PFB: ``csrc/qpfb.cu``
(``tina_pfb_int8``) replaces the reference's ``kernels/pfb.py:
pfb_fused_int8``.  A block computes the subfiltered frames of its frame
block across ALL P branches (each frame is requantized over P before the
DFT), so its shared memory grows with P and the wrapper raises on a P
that does not fit.  :func:`pfb_fused_int8_plain` is the same function in
plain torch, equal bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantize
from repro_torch.kernels import _build, tune
from repro_torch.kernels import matmul as mm_kernel

# Compiled tile shapes of csrc/pfb.cu (frames x columns per block).
TILES = ((64, 64), (64, 32), (32, 64), (32, 32))
BK = 16          # branches per K chunk, fixed in the kernel

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
INT8_LAUNCHES = 0   # the same for pfb_fused_int8


def smem_bytes(bt: int, bn: int, m: int, complex_out: bool = True) -> int:
    """Dynamic shared memory one block of the kernel asks for."""
    return 4 * (BK * (bt + 4) + BK * bn * (2 if complex_out else 1)
                + (bt + m - 1) * BK)


# ctx: {"m": taps per branch, "p": branches, "t": frames}.  Hard limits:
# a compiled tile shape, and the halo rows plus the y / F chunks within
# the shared memory a block may have.
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="pfb",
    params=("bt", "bn"),
    candidates=lambda ctx: tuple({"bt": bt, "bn": bn} for bt, bn in TILES),
    valid=lambda cfg, ctx: (
        (cfg["bt"], cfg["bn"]) in TILES
        and smem_bytes(cfg["bt"], cfg["bn"], ctx["m"]) <= tune.SMEM_BUDGET),
    default=lambda ctx: {"bt": 64, "bn": 32 if ctx["p"] <= 32 else 64},
))


def pfb_fused_plain(frames: torch.Tensor, taps_rev: torch.Tensor,
                    fr: torch.Tensor, fi: torch.Tensor | None) -> torch.Tensor:
    """The kernel's function in plain torch: y = FIR bank, then y @ F.
    Returns complex (B, T-M+1, N) when ``fi`` is given, else real y @ fr."""
    m = taps_rev.shape[0]
    tout = frames.shape[1] - m + 1
    y = taps_rev[0] * frames[:, 0:tout]
    for k in range(1, m):
        y = y + taps_rev[k] * frames[:, k:k + tout]
    zr = torch.matmul(y, fr)
    if fi is None:
        return zr
    return torch.complex(zr, torch.matmul(y, fi))


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"pfb_fused: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"pfb_fused: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"pfb_fused: {name} on {t.device}, frames on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"pfb_fused: {name} must be contiguous")


def pfb_fused(frames: torch.Tensor, taps_rev: torch.Tensor,
              fr: torch.Tensor, fi: torch.Tensor | None = None, *,
              bt: int = 64, bn: int = 64) -> torch.Tensor:
    """frames (B, T, P), taps_rev (M, P) pre-reversed taps, fr/fi (P, N)
    Fourier matrix -> complex64 (B, T-M+1, N) = FIR(frames) @ (fr + i fi);
    with ``fi=None`` the real float32 FIR(frames) @ fr.

    A CPU tensor runs :func:`pfb_fused_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    b, t, p = frames.shape
    m = taps_rev.shape[0]
    n = fr.shape[1]
    dev = frames.device
    if dev.type == "cpu":
        return pfb_fused_plain(frames, taps_rev, fr, fi)
    if dev.type != "cuda":
        raise ValueError(f"pfb_fused: no kernel for device {dev}")
    _check("frames", frames, (b, t, p), dev)
    _check("taps_rev", taps_rev, (m, p), dev)
    _check("fr", fr, (p, n), dev)
    if fi is not None:
        _check("fi", fi, (p, n), dev)
    tout = t - m + 1
    if tout <= 0:
        raise ValueError(f"pfb_fused: {t} frames < {m} taps")
    if (bt, bn) not in TILES:
        raise ValueError(f"pfb_fused: tile ({bt}, {bn}) not compiled; "
                         f"have {TILES}")
    cplx = fi is not None
    out = torch.empty((b, tout, n), device=dev,
                      dtype=torch.complex64 if cplx else torch.float32)
    lib = _build.lib()
    code = lib.tina_pfb(
        frames.data_ptr(), taps_rev.data_ptr(), fr.data_ptr(),
        fi.data_ptr() if cplx else None, out.data_ptr(), b, t, p, n, m,
        bt, bn, int(cplx), torch.cuda.current_stream(dev).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "pfb_fused")
    return out


# -- int8 ------------------------------------------------------------------
# Compiled tiles of csrc/qpfb.cu (frames x columns per block; 256 and
# 128 threads, a 4 x 4 micro-tile of each of zr, zi per thread).
TILES_INT8 = ((32, 128), (16, 128))
KW_INT8 = 8      # packed DFM words (32 branches) staged per chunk


def int8_smem_bytes(bt: int, bn: int, p: int) -> int:
    """Dynamic shared memory of one block of csrc/qpfb.cu: the packed yq
    ((P/4) x (bt + 4) words), two DFM chunks (8 x bn words each), y
    (bt x P f32) and the bt frame scales."""
    pw = -(-p // 4)
    return 4 * (pw * (bt + 4) + 2 * KW_INT8 * bn) + 4 * (bt * p + bt)


def _valid_int8(cfg: dict, ctx: dict) -> bool:
    return ((cfg["bt"], cfg["bn"]) in TILES_INT8
            and max(ctx["p"], ctx["m"]) <= mm_kernel.MAX_INT8_K
            and int8_smem_bytes(cfg["bt"], cfg["bn"], ctx["p"])
            <= tune.SMEM_BUDGET)


def _default_int8(ctx: dict) -> dict:
    fits = [t for t in TILES_INT8
            if int8_smem_bytes(t[0], t[1], ctx["p"]) <= tune.SMEM_BUDGET]
    bt, bn = fits[0] if fits else TILES_INT8[-1]
    return {"bt": bt, "bn": bn}


# ctx: {"m": taps per branch, "p": branches, "t": frames}.  Hard limits: a
# compiled tile whose y rows over all P fit the 227 KB of shared memory
# (P <= 2,669 at bt = 16).  The TPU formulas for VMEM do not apply.
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="pfb_int8",
    params=("bt", "bn"),
    candidates=lambda ctx: tuple({"bt": bt, "bn": bn}
                                 for bt, bn in TILES_INT8),
    valid=_valid_int8,
    default=_default_int8,
))


def pfb_fused_int8_plain(frames: torch.Tensor, tq: torch.Tensor,
                         ts: torch.Tensor, qr: torch.Tensor,
                         qi: torch.Tensor, sr: torch.Tensor,
                         si: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch (quantize.qpfb's decisions and
    exact integer sums, without the windowed copy): each (frame, branch)
    M-window quantized on its own, int32 MAC against tq, y = (acc * s) *
    ts; each frame's y requantized over P; the exact int32 products with
    qr and qi and ``(acc * ys) * sr`` / ``* si`` -> complex64."""
    m = tq.shape[0]
    tout = frames.shape[-2] - m + 1
    amax = frames[..., :tout, :].abs()
    for k in range(1, m):
        amax = torch.maximum(amax, frames[..., k:k + tout, :].abs())
    scale = quantize.scale_of(amax)
    acc = torch.zeros(amax.shape, dtype=torch.int32, device=frames.device)
    for k in range(m):
        acc += (quantize.quantize_with(frames[..., k:k + tout, :], scale)
                .to(torch.int32) * tq[k].to(torch.int32))
    y = acc.to(torch.float32) * scale * ts.reshape(-1)
    yq, ys = quantize.quantize_symmetric(y, axis=-1)
    zr = quantize.int8_dot(yq, qr).to(torch.float32) * ys * sr.reshape(-1)
    zi = quantize.int8_dot(yq, qi).to(torch.float32) * ys * si.reshape(-1)
    return torch.complex(zr, zi)


def pfb_fused_int8(frames: torch.Tensor, tq: torch.Tensor, ts: torch.Tensor,
                   qr: torch.Tensor, qi: torch.Tensor, sr: torch.Tensor,
                   si: torch.Tensor, *, bt: int = 32,
                   bn: int = 128) -> torch.Tensor:
    """frames (B, T, P) float32; tq (M, P) int8 reversed prototype and ts
    (P,) its per-branch scales (quantize_pfb_taps); qr / qi (P, N) the
    int8 Fourier matrix with per-column scales sr / si (N,) -> complex64
    (B, T - M + 1, N).

    A CPU tensor runs :func:`pfb_fused_int8_plain`; a CUDA tensor
    launches the kernel on the current stream or raises -- also when the
    tile's rows over all P do not fit the shared memory of a block."""
    if frames.ndim != 3 or tq.ndim != 2 or qr.ndim != 2:
        raise ValueError(f"pfb_fused_int8: frames {tuple(frames.shape)}, "
                         f"taps {tuple(tq.shape)}, DFM {tuple(qr.shape)}")
    b, t, p = frames.shape
    m = tq.shape[0]
    n = qr.shape[1]
    dev = frames.device
    if dev.type == "cpu":
        return pfb_fused_int8_plain(frames, tq, ts, qr, qi, sr, si)
    if dev.type != "cuda":
        raise ValueError(f"pfb_fused_int8: no kernel for device {dev}")
    mm_kernel.check_int8_args(
        "pfb_fused_int8", dev, frames=(frames, torch.float32, (b, t, p)),
        tq=(tq, torch.int8, (m, p)), ts=(ts, torch.float32, (p,)),
        qr=(qr, torch.int8, (p, n)), qi=(qi, torch.int8, (p, n)),
        sr=(sr, torch.float32, (n,)), si=(si, torch.float32, (n,)))
    tout = t - m + 1
    if tout <= 0:
        raise ValueError(f"pfb_fused_int8: {t} frames < {m} taps")
    if not 0 < b <= 65535:
        raise ValueError(f"pfb_fused_int8: batch {b} outside 1..65535")
    if not _valid_int8({"bt": bt, "bn": bn}, {"p": p, "m": m}):
        raise ValueError(
            f"pfb_fused_int8: tile ({bt}, {bn}) at P={p} does not fit the "
            f"kernel (compiled tiles {TILES_INT8}; a block holds its frames "
            f"over all P: {int8_smem_bytes(bt, bn, p)} B of shared memory, "
            f"{tune.SMEM_BUDGET} B allowed)")
    out = torch.empty((b, tout, n), device=dev, dtype=torch.complex64)
    if out.numel() == 0:
        return out
    code = _build.lib().tina_pfb_int8(
        frames.data_ptr(), tq.data_ptr(), ts.data_ptr(), qr.data_ptr(),
        qi.data_ptr(), sr.data_ptr(), si.data_ptr(), out.data_ptr(), b, t,
        p, n, m, bt, bn, torch.cuda.current_stream(dev).cuda_stream)
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "pfb_fused_int8")
    return out


__all__ = ["pfb_fused", "pfb_fused_plain", "TUNE_SPACE", "TILES",
           "LAUNCHES", "smem_bytes", "pfb_fused_int8", "pfb_fused_int8_plain",
           "TUNE_SPACE_INT8", "TILES_INT8", "INT8_LAUNCHES",
           "int8_smem_bytes"]
