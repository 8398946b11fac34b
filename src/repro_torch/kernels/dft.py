"""Blocked complex DFT kernel: TINA §4.1/§4.2, the (inverse) Fourier
matrix product of signal rows.

The CUDA kernel is ``csrc/dft.cu`` (it replaces the JAX reference's
``kernels/dft.py:dft``; the source says what bounds it and how).
:func:`dft` launches it for a CUDA tensor and runs :func:`dft_plain`,
the same arithmetic in plain torch, for a CPU tensor.  Two variants:

  * ``4mult``  Zr = Xr Fr − Xi Fi ; Zi = Xr Fi + Xi Fr
  * ``3mult``  Karatsuba: k1 = (Xr+Xi) Fr, k2 = Xr (Fi−Fr),
               k3 = Xi (Fr+Fi); Zr = k1 − k3, Zi = k1 + k2

The signal is complex64, read as interleaved pairs, or real float32,
whose imaginary plane is never formed ("null xi"): the real forward DFT
of an STFT does half the work of a complex one.  The result is complex64.
Unlike the TPU kernel there is no padding to block multiples: the kernel
masks its ragged edges.

:func:`dft_int8` is the int8 tier's real-signal DFT: ``tina_dft_int8`` in
``csrc/qmatmul.cu`` replaces the reference's ``kernels/dft.py:dft_int8``
(one int8 x block against the int8 Fr and Fi, two int32 accumulators);
:func:`dft_int8_plain` is its function in plain torch, equal bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tune
from repro_torch.kernels import matmul as mm_kernel

# Compiled tile shapes of csrc/dft.cu (rows x columns per block): the two
# the default picks.  Others are added when a measured shape prefers them.
TILES = ((64, 64), (64, 32))
VARIANTS = ("4mult", "3mult")

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
INT8_LAUNCHES = 0   # the same for dft_int8

# ctx: {"m": rows, "n": out cols, "k": inner}.  Hard limit: a compiled
# tile shape (the shared-memory chunks are fixed at 25 KB at most).
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="dft",
    params=("bm", "bn"),
    candidates=lambda ctx: tuple({"bm": bm, "bn": bn} for bm, bn in TILES),
    valid=lambda cfg, ctx: (cfg["bm"], cfg["bn"]) in TILES,
    default=lambda ctx: {"bm": 64, "bn": 64 if ctx["n"] > 32 else 32},
))


def dft_plain(x: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
              variant: str = "3mult") -> torch.Tensor:
    """The kernel's products in plain torch: x (B, L) complex or real,
    fr/fi (L, N) -> complex (B, N).  A real x has no imaginary plane."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown dft variant {variant!r}")
    xr, xi = (x.real, x.imag) if x.is_complex() else (x, None)
    if variant == "4mult":
        zr, zi = xr @ fr, xr @ fi
        if xi is not None:
            zr = zr - xi @ fi
            zi = zi + xi @ fr
    else:
        k1 = (xr if xi is None else xr + xi) @ fr
        zr = k1 if xi is None else k1 - xi @ (fr + fi)
        zi = k1 + xr @ (fi - fr)
    return torch.complex(zr, zi)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"dft: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"dft: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"dft: {name} on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"dft: {name} must be contiguous")


def dft(x: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor, *,
        variant: str = "3mult", bm: int = 64, bn: int = 64) -> torch.Tensor:
    """x (B, L) complex64 or float32, fr/fi (L, N) float32 (the forward
    or inverse Fourier matrix) -> complex64 (B, N) = x (fr + i fi).

    A CPU tensor runs :func:`dft_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    dev = x.device
    if dev.type == "cpu":
        return dft_plain(x, fr, fi, variant)
    if dev.type != "cuda":
        raise ValueError(f"dft: no kernel for device {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown dft variant {variant!r}")
    b, l = x.shape
    n = fr.shape[1]
    cplx = x.is_complex()
    _check("x", x, torch.complex64 if cplx else torch.float32, (b, l), dev)
    _check("fr", fr, torch.float32, (l, n), dev)
    _check("fi", fi, torch.float32, (l, n), dev)
    if (bm, bn) not in TILES:
        raise ValueError(f"dft: tile ({bm}, {bn}) not compiled; have "
                         f"{TILES}")
    out = torch.empty((b, n), device=dev, dtype=torch.complex64)
    if out.numel() == 0:
        return out
    code = _build.lib().tina_dft(
        x.data_ptr(), int(cplx), fr.data_ptr(), fi.data_ptr(),
        out.data_ptr(), b, l, n, int(variant == "3mult"), bm, bn,
        torch.cuda.current_stream(dev).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "dft")
    return out


# -- int8 ------------------------------------------------------------------
# Compiled tile of tina_dft_int8 (bm, bn, bk): 256 threads, a 4 x 4 int32
# micro-tile per thread for each of Fr and Fi, L in chunks of 32 int8.
TILES_INT8 = ((64, 64, 32),)

# ctx: {"m": rows, "n": out cols, "k": inner}.  Hard limits: the compiled
# tile (6.1 KB of static shared memory, far inside the 227 KB a block may
# have) and L <= MAX_INT8_K.  ops.qdft runs a complex input's four
# products through matmul_int8 at the same tile.
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="dft_int8",
    params=("bm", "bn", "bk"),
    candidates=lambda ctx: tuple({"bm": bm, "bn": bn, "bk": bk}
                                 for bm, bn, bk in TILES_INT8),
    valid=lambda cfg, ctx: ((cfg["bm"], cfg["bn"], cfg["bk"]) in TILES_INT8
                            and ctx["k"] <= mm_kernel.MAX_INT8_K),
    default=lambda ctx: {"bm": 64, "bn": 64, "bk": 32},
))


def dft_int8_plain(xq: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
                   sx: torch.Tensor, sr: torch.Tensor,
                   si: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: complex64 (B, N) =
    (xq @ fr · sx) · sr + i (xq @ fi · sx) · si, exact int32 sums."""
    return torch.complex(mm_kernel.matmul_int8_plain(xq, fr, sx, sr),
                         mm_kernel.matmul_int8_plain(xq, fi, sx, si))


def dft_int8(xq: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
             sx: torch.Tensor, sr: torch.Tensor, si: torch.Tensor, *,
             bm: int = 64, bn: int = 64, bk: int = 32) -> torch.Tensor:
    """Real-signal int8 DFT: xq (B, L) int8 rows with per-row scales sx
    (B,); fr / fi (L, N) the int8 Fourier matrix with per-column scales
    sr / si (N,) -> complex64 (B, N).

    A CPU tensor runs :func:`dft_int8_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    if xq.ndim != 2 or fr.ndim != 2 or xq.shape[1] != fr.shape[0]:
        raise ValueError(f"dft_int8: shapes {tuple(xq.shape)} @ "
                         f"{tuple(fr.shape)}")
    b, l = xq.shape
    n = fr.shape[1]
    dev = xq.device
    if dev.type == "cpu":
        return dft_int8_plain(xq, fr, fi, sx, sr, si)
    if dev.type != "cuda":
        raise ValueError(f"dft_int8: no kernel for device {dev}")
    mm_kernel.check_int8_args(
        "dft_int8", dev, xq=(xq, torch.int8, (b, l)),
        fr=(fr, torch.int8, (l, n)), fi=(fi, torch.int8, (l, n)),
        sx=(sx, torch.float32, (b,)), sr=(sr, torch.float32, (n,)),
        si=(si, torch.float32, (n,)))
    if (bm, bn, bk) not in TILES_INT8:
        raise ValueError(f"dft_int8: tile {(bm, bn, bk)} not compiled; "
                         f"have {TILES_INT8}")
    if not 0 < l <= mm_kernel.MAX_INT8_K:
        raise ValueError(f"dft_int8: L = {l} outside "
                         f"1..{mm_kernel.MAX_INT8_K}")
    out = torch.empty((b, n), device=dev, dtype=torch.complex64)
    if out.numel() == 0:
        return out
    code = _build.lib().tina_dft_int8(
        xq.data_ptr(), fr.data_ptr(), fi.data_ptr(), sx.data_ptr(),
        sr.data_ptr(), si.data_ptr(), out.data_ptr(), b, l, n, bm, bn, bk,
        torch.cuda.current_stream(dev).cuda_stream)
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "dft_int8")
    return out


__all__ = ["dft", "dft_plain", "TUNE_SPACE", "TILES", "VARIANTS",
           "LAUNCHES", "dft_int8", "dft_int8_plain", "TUNE_SPACE_INT8",
           "TILES_INT8", "INT8_LAUNCHES"]
