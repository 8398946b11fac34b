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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tune

# Compiled tile shapes of csrc/dft.cu (rows x columns per block): the two
# the default picks.  Others are added when a measured shape prefers them.
TILES = ((64, 64), (64, 32))
VARIANTS = ("4mult", "3mult")

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)

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


__all__ = ["dft", "dft_plain", "TUNE_SPACE", "TILES", "VARIANTS",
           "LAUNCHES"]
