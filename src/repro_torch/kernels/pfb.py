"""Polyphase filter bank kernel: the FIR bank over frames, then the DFT
across branches.

The CUDA kernels are ``csrc/pfb.cu`` (they replace the JAX reference's
``kernels/pfb.py:pfb_fused``; the source says what bounds them and how).
:func:`pfb_fused` is one call of two kernels: a frontend that writes the
FIR bank's output y as rows whose stride is P rounded up to 4 (zero past
P), then the 3xTF32 tensor-core DFT of ``csrc/dft.cu`` on those rows.
:func:`pfb_frontend` launches the frontend alone.  For a CPU tensor each
runs its plain torch twin, :func:`pfb_fused_plain` and
:func:`pfb_frontend_plain`; the frontend's y equals its twin bit for bit.
Unlike the TPU kernel there is no padded frame axis and no halo rule
between the taps and a frame block: the frontend reads any window.

:func:`pfb_fused_int8` is the int8 tier's fused PFB: ``csrc/qpfb.cu``
(``tina_pfb_int8``) replaces the reference's ``kernels/pfb.py:
pfb_fused_int8``.  Each frame is requantized over all P branches before
the DFT, so one call launches two kernels: a frontend that writes each
frame's int8 row yq (its stride P rounded up to 16) and its scale ys,
then the s8 tensor-core DFT of ``csrc/s8_gemm.cuh`` over yq (IGMMA).
:func:`pfb_fused_int8_plain` is the same function in plain torch, equal
bit for bit; :func:`pfb_frontend_int8_plain` is the frontend's twin.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantize
from repro_torch.kernels import _build, tune
from repro_torch.kernels import dft as dft_kernel
from repro_torch.kernels import matmul as mm_kernel

# Compiled tiles of the DFT stage (frames x columns of a tile): those of
# csrc/dft.cu, whose kernel the stage is: 128 x 64, and 128 x 16 where
# N = P <= 16.  The frontend has no tile.
TILES = dft_kernel.TILES
Y_ALIGN = 4      # y's row stride: P rounded up to 4 floats (16 bytes)

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
FRONTEND_LAUNCHES = 0   # the same for pfb_frontend
INT8_LAUNCHES = 0   # the same for pfb_fused_int8


def y_stride(p: int) -> int:
    """The row stride of the y rows the DFT stage reads: P rounded up to
    a multiple of 4 floats, so that TMA reads the rows directly."""
    return -(-p // Y_ALIGN) * Y_ALIGN


# ctx: {"m": taps per branch, "p": branches, "t": frames}.  Hard limit: a
# compiled tile of the DFT stage.  Neither the taps nor P is bounded by
# shared memory: the frontend stages nothing, and the DFT stage's ring
# holds 32-deep chunks of y.
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="pfb",
    params=("bt", "bn"),
    candidates=lambda ctx: tuple({"bt": bt, "bn": bn} for bt, bn in TILES),
    valid=lambda cfg, ctx: (cfg["bt"], cfg["bn"]) in TILES,
    default=lambda ctx: {"bt": 128, "bn": dft_kernel.default_bn(ctx["p"])},
))


def pfb_frontend_plain(frames: torch.Tensor,
                       taps_rev: torch.Tensor) -> torch.Tensor:
    """The frontend's function in plain torch: frames (B, T, P), taps_rev
    (M, P) -> y (B, T-M+1, P) = taps_rev[0] x[t], then + taps_rev[m]
    x[t+m] in ascending m, each product and sum rounded on its own."""
    m = taps_rev.shape[0]
    tout = frames.shape[1] - m + 1
    y = taps_rev[0] * frames[:, 0:tout]
    for k in range(1, m):
        y = y + taps_rev[k] * frames[:, k:k + tout]
    return y


def pfb_frontend_rows_plain(frames: torch.Tensor,
                            taps_rev: torch.Tensor) -> torch.Tensor:
    """What the frontend writes inside :func:`pfb_fused`: y as
    (B (T-M+1), y_stride(P)) rows, zero past column P."""
    y = pfb_frontend_plain(frames, taps_rev)
    p = y.shape[-1]
    rows = torch.zeros((y.shape[0] * y.shape[1], y_stride(p)),
                       dtype=y.dtype, device=y.device)
    rows[:, :p] = y.reshape(-1, p)
    return rows


def pfb_fused_plain(frames: torch.Tensor, taps_rev: torch.Tensor,
                    fr: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain torch: y = the FIR bank
    (:func:`pfb_frontend_plain`), then complex (B, T-M+1, N) =
    y fr + i y fi."""
    y = pfb_frontend_plain(frames, taps_rev)
    return torch.complex(torch.matmul(y, fr), torch.matmul(y, fi))


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


def _frontend_args(frames, taps_rev):
    """(b, t, p, m, tout) of a CUDA call, its inputs checked."""
    if frames.ndim != 3 or taps_rev.ndim != 2:
        raise ValueError(f"pfb_fused: frames {tuple(frames.shape)}, taps "
                         f"{tuple(taps_rev.shape)}")
    b, t, p = frames.shape
    m = taps_rev.shape[0]
    _check("frames", frames, (b, t, p), frames.device)
    _check("taps_rev", taps_rev, (m, p), frames.device)
    tout = t - m + 1
    if tout <= 0:
        raise ValueError(f"pfb_fused: {t} frames < {m} taps")
    if b * tout > 2 ** 31 - 1:
        raise ValueError(f"pfb_fused: {b * tout} frame rows > 2**31 - 1")
    return b, t, p, m, tout


def pfb_frontend(frames: torch.Tensor, taps_rev: torch.Tensor, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """frames (B, T, P), taps_rev (M, P) pre-reversed taps -> float32 y
    (B, T-M+1, P), the FIR bank alone.  ``out``: a contiguous
    (B (T-M+1), y_stride(P)) float32 buffer that receives y as the rows
    :func:`pfb_fused`'s DFT stage reads, zero past column P
    (:func:`pfb_frontend_rows_plain` is their twin), and is returned.

    A CPU tensor runs :func:`pfb_frontend_plain`; a CUDA tensor launches
    the frontend kernel on the current stream or raises."""
    dev = frames.device
    if dev.type == "cpu":
        if out is None:
            return pfb_frontend_plain(frames, taps_rev)
        return out.copy_(pfb_frontend_rows_plain(frames, taps_rev))
    if dev.type != "cuda":
        raise ValueError(f"pfb_fused: no kernel for device {dev}")
    b, t, p, m, tout = _frontend_args(frames, taps_rev)
    if out is None:
        y, cols = torch.empty((b, tout, p), device=dev,
                              dtype=torch.float32), p
    else:
        y, cols = out, y_stride(p)
        _check("out", y, (b * tout, cols), dev)
    code = _build.lib().tina_pfb_frontend(
        frames.data_ptr(), taps_rev.data_ptr(), y.data_ptr(), b, t, p, m,
        cols, _build.stream(dev))
    global FRONTEND_LAUNCHES
    FRONTEND_LAUNCHES += 1
    _build.check(code, "pfb_frontend")
    return y


def pfb_fused(frames: torch.Tensor, taps_rev: torch.Tensor,
              fr: torch.Tensor, fi: torch.Tensor, *,
              planes: torch.Tensor | None = None, hermitian: bool = False,
              bt: int = 128, bn: int = 64) -> torch.Tensor:
    """frames (B, T, P), taps_rev (M, P) pre-reversed taps, fr/fi (P, N)
    Fourier matrix -> complex64 (B, T-M+1, N) = FIR(frames) @ (fr + i fi).
    ``planes``: ``dft.tf32_planes(fr, fi, "4mult")``, made once by a
    caller whose matrix is a constant; None splits fr and fi here, per
    call.  ``hermitian``: the caller vouches that fr + i fi is the P-point
    DFM (N = P), whose symmetry lets the DFT stage compute columns
    0 .. P/2 and write the rest as their conjugates where that saves
    column tiles (ops.pfb, the plan's path, vouches).  The frontend's y
    rows go through a buffer made per call (:func:`pfb_frontend` with
    ``out`` writes the same rows).

    A CPU tensor runs :func:`pfb_fused_plain`; a CUDA tensor launches the
    frontend and the DFT stage on the current stream (one call, two
    kernels) or raises."""
    dev = frames.device
    if dev.type == "cpu":
        return pfb_fused_plain(frames, taps_rev, fr, fi)
    if dev.type != "cuda":
        raise ValueError(f"pfb_fused: no kernel for device {dev}")
    b, t, p, m, tout = _frontend_args(frames, taps_rev)
    n = fr.shape[1]
    _check("fr", fr, (p, n), dev)
    _check("fi", fi, (p, n), dev)
    if (bt, bn) not in TILES:
        raise ValueError(f"pfb_fused: tile ({bt}, {bn}) not compiled; "
                         f"have {TILES}")
    if hermitian and n != p:
        raise ValueError(f"pfb_fused: hermitian needs the P-point DFM, got "
                         f"N = {n} for P = {p}")
    if planes is None:
        planes = dft_kernel.tf32_planes(fr, fi, "4mult")
    n_pad = -(-n // dft_kernel.N_ALIGN) * dft_kernel.N_ALIGN
    l_pad = -(-p // dft_kernel.BK) * dft_kernel.BK
    _check("planes", planes, (4, n_pad, l_pad), dev)
    cols = y_stride(p)
    y = torch.empty((b * tout, cols), device=dev, dtype=torch.float32)
    out = torch.empty((b, tout, n), device=dev, dtype=torch.complex64)
    code = _build.lib().tina_pfb(
        frames.data_ptr(), taps_rev.data_ptr(), planes.data_ptr(), n_pad,
        l_pad, y.data_ptr(), cols, out.data_ptr(), b, t, p, n, m,
        int(hermitian), bt, bn, _build.stream(dev))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "pfb_fused")
    return out


# -- int8 ------------------------------------------------------------------
# Compiled tiles of the DFT stage of csrc/qpfb.cu (frames x columns of a
# tile, on the s8 ring of csrc/s8_gemm.cuh): 128 x 128 and 128 x 64.
# 128 x 64 is the default at every N: at N <= 64 the wide tile computes
# and skips half its columns, and at the pfb full width (65,424 frames,
# N = 1024) it measured faster too (chip_smoke.py, int8_main's
# ms_per_tile).
TILES_INT8 = ((128, 128), (128, 64))
FRONTEND_THREADS = 256   # csrc/qpfb.cu: FT, threads of a frontend block
FRONTEND_TPF_MAX = 64    # csrc/qpfb.cu: TPF_MAX, threads of one frame
FRONTEND_WORK = 8192     # csrc/qpfb.cu: FB_WORK, padded branches a block


def padded_width(p: int) -> int:
    """P_pad: the row stride of yq, P rounded up to a multiple of 16 so
    that the TMA reads yq's rows directly."""
    return -(-p // mm_kernel.INT8_K_ALIGN) * mm_kernel.INT8_K_ALIGN


def frontend_shape(p: int) -> dict:
    """The frontend's launch shape in csrc/qpfb.cu for P branches: a
    frame on ``tpf`` threads (a power of two: as many as its groups of
    four branches, up to 64, or more, up to the block, where the y slots
    of 256 / 64 frames would not fit: P past 14,336), ``frames_per_pass``
    frames at a time, ``frames_per_block`` frames a block (about 8,192
    padded branches), and ``smem_bytes``: one 16-byte y slot per group of
    each frame of a pass and the eight warps' amax words."""
    p_pad = padded_width(p)
    g = p_pad // 4

    def smem(tpf):
        return (FRONTEND_THREADS // tpf) * -(-g // tpf) * tpf * 16 \
            + 4 * (FRONTEND_THREADS // 32)

    tpf = 1
    while tpf < g and tpf < FRONTEND_TPF_MAX:
        tpf *= 2
    while smem(tpf) > tune.SMEM_BUDGET and tpf < FRONTEND_THREADS:
        tpf *= 2
    fpb = FRONTEND_THREADS // tpf
    return {"tpf": tpf, "frames_per_pass": fpb,
            "frames_per_block": max(FRONTEND_WORK // p_pad // fpb, 1) * fpb,
            "smem_bytes": smem(tpf)}


def frontend_smem_bytes(p: int) -> int:
    """Shared memory of one frontend block (:func:`frontend_shape`)."""
    return frontend_shape(p)["smem_bytes"]


def int8_smem_bytes(bt: int, bn: int, p: int) -> int:
    """Shared memory the larger of the two kernels of csrc/qpfb.cu asks
    for: the DFT stage's ring (per stage a bt x 128 chunk of yq and a
    bn x 128 chunk of each of Fr^T and Fi^T) or the frontend's y slots."""
    ring = mm_kernel.INT8_STAGES * (bt + 2 * bn) * 128 \
        + 2 * mm_kernel.INT8_STAGES * 8 + 1024
    return max(ring, frontend_smem_bytes(p))


def _valid_int8(cfg: dict, ctx: dict) -> bool:
    return ((cfg["bt"], cfg["bn"]) in TILES_INT8
            and max(padded_width(ctx["p"]), ctx["m"]) <= mm_kernel.MAX_INT8_K
            and int8_smem_bytes(cfg["bt"], cfg["bn"], ctx["p"])
            <= tune.SMEM_BUDGET)


# ctx: {"m": taps per branch, "p": branches, "t": frames}.  Hard limits: a
# compiled DFT tile, P_pad and M within MAX_INT8_K (the int32 sums), and
# the frontend's y slots within the 227 KB of a block (P <= 57,344).  The
# TPU formulas for VMEM do not apply.
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="pfb_int8",
    params=("bt", "bn"),
    candidates=lambda ctx: tuple({"bt": bt, "bn": bn}
                                 for bt, bn in TILES_INT8),
    valid=_valid_int8,
    default=lambda ctx: {"bt": 128, "bn": 64},
))


def _subfiltered_int8(frames: torch.Tensor, tq: torch.Tensor,
                      ts: torch.Tensor) -> torch.Tensor:
    """y (..., T-M+1, P) float32 of the int8 frontend: each (frame,
    branch) M-window quantized on its own, the int32 MAC against tq,
    y = (acc * s) * ts."""
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
    return acc.to(torch.float32) * scale * ts.reshape(-1)


def pfb_frontend_int8_plain(frames: torch.Tensor, tq: torch.Tensor,
                            ts: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The frontend kernel's function in plain torch: each frame's y
    requantized over its P branches -> yq (B (T-M+1), P_pad) int8, zero
    past column P, and ys (B (T-M+1),) float32."""
    p = tq.shape[1]
    yq, ys = quantize.quantize_symmetric(
        _subfiltered_int8(frames, tq, ts).reshape(-1, p), axis=-1)
    pad = torch.zeros((yq.shape[0], padded_width(p)), dtype=torch.int8,
                      device=frames.device)
    pad[:, :p] = yq
    return pad, ys.reshape(-1)


def pfb_fused_int8_plain(frames: torch.Tensor, tq: torch.Tensor,
                         ts: torch.Tensor, qr: torch.Tensor,
                         qi: torch.Tensor, sr: torch.Tensor,
                         si: torch.Tensor) -> torch.Tensor:
    """The function of both kernels in plain torch (quantize.qpfb's
    decisions and exact integer sums, without the windowed copy): the
    frontend's y, each frame's y requantized over P, the exact int32
    products with qr and qi and ``(acc * ys) * sr`` / ``* si`` ->
    complex64."""
    yq, ys = quantize.quantize_symmetric(_subfiltered_int8(frames, tq, ts),
                                         axis=-1)
    zr = quantize.int8_dot(yq, qr).to(torch.float32) * ys * sr.reshape(-1)
    zi = quantize.int8_dot(yq, qi).to(torch.float32) * ys * si.reshape(-1)
    return torch.complex(zr, zi)


def _kmajor(ft: torch.Tensor | None, f: torch.Tensor,
            p_pad: int) -> torch.Tensor:
    """The DFT stage's B operand: f's K-major copy (N, P_pad), zero past
    column P and 16-byte aligned; ``ft`` is the (N, P) copy the caller
    made once, or None."""
    if ft is None:
        ft = f.t().contiguous()
    if ft.shape[1] != p_pad or ft.data_ptr() % 16:
        ft = mm_kernel.pad_k(ft, p_pad)
    return ft


def pfb_fused_int8(frames: torch.Tensor, tq: torch.Tensor, ts: torch.Tensor,
                   qr: torch.Tensor, qi: torch.Tensor, sr: torch.Tensor,
                   si: torch.Tensor, *, frt: torch.Tensor | None = None,
                   fit: torch.Tensor | None = None, bt: int = 128,
                   bn: int = 64, scratch: tuple | None = None
                   ) -> torch.Tensor:
    """frames (B, T, P) float32; tq (M, P) int8 reversed prototype and ts
    (P,) its per-branch scales (quantize_pfb_taps); qr / qi (P, N) the
    int8 Fourier matrix with per-column scales sr / si (N,) -> complex64
    (B, T - M + 1, N).  ``frt`` / ``fit``: the K-major (N, P) copies of
    qr and qi, the tensor cores' B operands, where the caller made them
    once (the int8 DFM: ``quantize._qdfm_kmajor``); None transposes here,
    per call.  Where P is not a multiple of 16 they are copied into
    zero-padded rows per call.  ``scratch``: (yq, ys) buffers of
    :func:`pfb_frontend_int8_plain`'s shapes for the frontend to write,
    which the caller may read afterwards; None allocates them.

    A CPU tensor runs :func:`pfb_fused_int8_plain`; a CUDA tensor
    launches the frontend and the DFT stage on the current stream (one
    call, two kernels) or raises."""
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
    mm_kernel.check_args(
        "pfb_fused_int8", dev, frames=(frames, torch.float32, (b, t, p)),
        tq=(tq, torch.int8, (m, p)), ts=(ts, torch.float32, (p,)),
        qr=(qr, torch.int8, (p, n)), qi=(qi, torch.int8, (p, n)),
        sr=(sr, torch.float32, (n,)), si=(si, torch.float32, (n,)))
    tout = t - m + 1
    if tout <= 0:
        raise ValueError(f"pfb_fused_int8: {t} frames < {m} taps")
    rows = b * tout
    if rows > 2 ** 31 - 1:
        raise ValueError(f"pfb_fused_int8: {rows} frame rows > 2**31 - 1")
    if not _valid_int8({"bt": bt, "bn": bn}, {"p": p, "m": m}):
        raise ValueError(
            f"pfb_fused_int8: tile ({bt}, {bn}) at P={p}, M={m} does not "
            f"fit the kernels (compiled tiles {TILES_INT8}; "
            f"{int8_smem_bytes(bt, bn, p)} B of shared memory, "
            f"{tune.SMEM_BUDGET} B allowed; P_pad and M <= "
            f"{mm_kernel.MAX_INT8_K})")
    p_pad = padded_width(p)
    frt, fit = _kmajor(frt, qr, p_pad), _kmajor(fit, qi, p_pad)
    mm_kernel.check_args(
        "pfb_fused_int8", dev, frt=(frt, torch.int8, (n, p_pad)),
        fit=(fit, torch.int8, (n, p_pad)))
    if scratch is None:
        scratch = (torch.empty((rows, p_pad), dtype=torch.int8, device=dev),
                   torch.empty((rows,), dtype=torch.float32, device=dev))
    yq, ys = scratch
    mm_kernel.check_args(
        "pfb_fused_int8", dev, yq=(yq, torch.int8, (rows, p_pad)),
        ys=(ys, torch.float32, (rows,)))
    if yq.data_ptr() % 16:
        raise ValueError("pfb_fused_int8: yq must start 16-byte aligned")
    out = torch.empty((b, tout, n), device=dev, dtype=torch.complex64)
    code = _build.lib().tina_pfb_int8(
        frames.data_ptr(), tq.data_ptr(), ts.data_ptr(), frt.data_ptr(),
        fit.data_ptr(), sr.data_ptr(), si.data_ptr(), yq.data_ptr(),
        ys.data_ptr(), out.data_ptr(), b, t, p, n, m, p_pad, bt, bn,
        _build.stream(dev))
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "pfb_fused_int8")
    return out


__all__ = ["pfb_fused", "pfb_fused_plain", "pfb_frontend",
           "pfb_frontend_plain", "pfb_frontend_rows_plain", "y_stride",
           "TUNE_SPACE", "TILES", "LAUNCHES", "FRONTEND_LAUNCHES",
           "pfb_fused_int8", "pfb_fused_int8_plain",
           "pfb_frontend_int8_plain", "TUNE_SPACE_INT8", "TILES_INT8",
           "INT8_LAUNCHES", "int8_smem_bytes", "frontend_smem_bytes",
           "frontend_shape", "padded_width"]
