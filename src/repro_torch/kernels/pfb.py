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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tune

# Compiled tile shapes of csrc/pfb.cu (frames x columns per block).
TILES = ((64, 64), (64, 32), (32, 64), (32, 32))
BK = 16          # branches per K chunk, fixed in the kernel

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)


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


__all__ = ["pfb_fused", "pfb_fused_plain", "TUNE_SPACE", "TILES",
           "LAUNCHES", "smem_bytes"]
