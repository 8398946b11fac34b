"""TINA function mappings (paper §3 arithmetic + §4 signal processing),
the part of them the PFB reaches.

Each function expresses a non-NN operation through the building blocks
of :mod:`repro_torch.core.blocks` (Table 1 of the paper) and takes
``lowering=``: ``"conv"`` (paper-faithful NN layer) or ``"native"``
(matmul / elementwise form).  The ``kernel`` lowering of these single
ops (the reference's Pallas matmul, DFT and elementwise kernels) is not
ported yet and raises.  ``fir``, ``unfold``, ``overlap_add`` and
``summation`` come with their slice.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import blocks

Tensor = torch.Tensor
LOWERINGS = ("native", "conv")


def _check_lowering(fn: str, lowering: str) -> None:
    if lowering == "kernel":
        raise ValueError(f"{fn}: the kernel lowering is not yet ported")
    if lowering not in LOWERINGS:
        raise ValueError(f"{fn}: unknown lowering {lowering!r}")


# ---------------------------------------------------------------------------
# §3.1 elementwise multiplication -- depthwise conv, Eq. (6)
# ---------------------------------------------------------------------------
def elementwise_mult(x: Tensor, y: Tensor, *, lowering: str = "native",
                     block: Optional[dict] = None) -> Tensor:
    """Elementwise x*y of same-shape tensors via a depthwise conv whose
    H = W = 1 and C_out = H*W (paper Eq. 6).  Batched over x.shape[:-2]."""
    del block
    if x.shape[-2:] != y.shape[-2:]:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    _check_lowering("elementwise_mult", lowering)
    h, w = x.shape[-2:]
    batch = x.shape[:-2]
    c = h * w
    xi = x.reshape((-1, c, 1, 1))
    if y.ndim > 2:   # batched kernel: one depthwise conv per sample
        ys = y.reshape(-1, c, 1, 1).expand(xi.shape[0], c, 1, 1)
        out = torch.stack([
            blocks.depthwise_conv(a[None], k, lowering=lowering)[0]
            for a, k in zip(xi, ys)])
    else:
        out = blocks.depthwise_conv(xi, y.reshape(c, 1, 1), lowering=lowering)
    return out.reshape(batch + (h, w))


# ---------------------------------------------------------------------------
# §3.3 elementwise addition -- depthwise conv, ones kernel, addend as bias,
# Eq. (10)
# ---------------------------------------------------------------------------
def elementwise_add(x: Tensor, y: Tensor, *, lowering: str = "native",
                    block: Optional[dict] = None) -> Tensor:
    del block
    if x.shape[-2:] != y.shape[-2:]:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    _check_lowering("elementwise_add", lowering)
    h, w = x.shape[-2:]
    batch = x.shape[:-2]
    c = h * w
    xi = x.reshape((-1, c, 1, 1))
    ones = torch.ones((c, 1, 1), dtype=x.dtype, device=x.device)
    if y.ndim > 2:
        out = torch.stack([
            blocks.depthwise_conv(a[None], ones, bias=b, lowering=lowering)[0]
            for a, b in zip(xi, y.reshape(-1, c))])
    else:
        out = blocks.depthwise_conv(xi, ones, bias=y.reshape(c),
                                    lowering=lowering)
    return out.reshape(batch + (h, w))


# ---------------------------------------------------------------------------
# §3.2 matrix-matrix multiplication -- pointwise conv, Eq. (9)
# ---------------------------------------------------------------------------
def matmul(x: Tensor, y: Tensor, *, lowering: str = "native",
           block: Optional[dict] = None) -> Tensor:
    """Z = X @ Y via pointwise conv: X (.., M, L) becomes the conv input
    (T, C_in=L, 1, W=M); the kernel is Y (L, N) (paper Eq. 9)."""
    del block
    _check_lowering("matmul", lowering)
    if y.ndim != 2:
        raise ValueError("TINA matmul kernel (conv weight) must be 2-D")
    if lowering == "native":
        return torch.matmul(x, y)
    m, l = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    xi = x.reshape((-1, m, l)).transpose(1, 2)[:, :, None, :]   # (T, L, 1, M)
    out = blocks.pointwise_conv(xi, y, lowering=lowering)
    out = out[:, :, 0, :].transpose(1, 2)                        # (T, M, N)
    return out.reshape(batch + (m, y.shape[1]))


# ---------------------------------------------------------------------------
# §4.1 / §4.2 DFT and IDFT -- pointwise conv with (inverse) Fourier matrix
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _dfm(n: int, inverse: bool, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """Discrete Fourier Matrix: F[l, k] = exp(-2πi l k / n); inverse adds
    the conjugate and the 1/n normalization."""
    lk = np.outer(np.arange(n), np.arange(n))
    sign = 2j if inverse else -2j
    f = np.exp(sign * np.pi * lk / n)
    if inverse:
        f = f / n
    return f.real.astype(dtype), f.imag.astype(dtype)


def _split(x: Tensor) -> tuple[Tensor, Tensor]:
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def dft(x: Tensor, *, inverse: bool = False, lowering: str = "native",
        variant: str = "4mult", block: Optional[dict] = None) -> Tensor:
    """(I)DFT over the last axis as a TINA matmul with the (I)DFM kernel
    (paper Eq. 12-14).  Complex arithmetic is the real/imag block matmul:

      4mult (paper-faithful):  Zr = Xr Fr - Xi Fi ; Zi = Xr Fi + Xi Fr
      3mult (beyond-paper):    Karatsuba -- 3 real matmuls instead of 4.
    """
    del block
    _check_lowering("dft", lowering)
    n = x.shape[-1]
    rdt = _REAL_OF.get(x.dtype, x.dtype)
    fr_np, fi_np = _dfm(n, inverse, str(rdt).removeprefix("torch."))
    fr = torch.as_tensor(fr_np, device=x.device)
    fi = torch.as_tensor(fi_np, device=x.device)
    xr, xi = _split(x)
    shp = xr.shape
    xr = xr.reshape((-1, n))
    xi = xi.reshape((-1, n))
    mm = functools.partial(matmul, lowering=lowering)
    if variant == "4mult":
        zr = mm(xr, fr) - mm(xi, fi)
        zi = mm(xr, fi) + mm(xi, fr)
    elif variant == "3mult":
        # k1 = Fr (Xr + Xi); k2 = Xr (Fi - Fr); k3 = Xi (Fr + Fi)
        k1 = mm(xr + xi, fr)
        k2 = mm(xr, fi - fr)
        k3 = mm(xi, fr + fi)
        zr = k1 - k3
        zi = k1 + k2
    else:
        raise ValueError(f"unknown dft variant {variant!r}")
    return torch.complex(zr, zi).reshape(shp[:-1] + (n,))


def idft(z: Tensor, *, lowering: str = "native", variant: str = "4mult",
         block: Optional[dict] = None) -> Tensor:
    return dft(z, inverse=True, lowering=lowering, variant=variant,
               block=block)


# ---------------------------------------------------------------------------
# per-channel FIR over time -- depthwise conv
# ---------------------------------------------------------------------------
def depthwise_fir(x: Tensor, taps: Tensor, *, causal: bool = True,
                  lowering: str = "native") -> Tensor:
    """Per-channel FIR over time: x (..., T, C), taps (K, C).  Causal
    left-padding keeps length T.  Maps to the TINA depthwise conv."""
    k, c = taps.shape
    if x.shape[-1] != c:
        raise ValueError(f"depthwise_fir: x {tuple(x.shape)} vs taps "
                         f"{tuple(taps.shape)}")
    batch = x.shape[:-2]
    t = x.shape[-2]
    xi = x.reshape((-1, t, c)).transpose(1, 2)[:, :, None, :]   # (B,C,1,T)
    if causal:
        xi = torch.nn.functional.pad(xi, (k - 1, 0))
    kern = taps.T[:, None, :]                                   # (C,1,K)
    out = blocks.depthwise_conv(xi, kern, lowering=lowering)    # (B,C,1,T)
    return out[:, :, 0, :].transpose(1, 2).reshape(batch + (t, c))


__all__ = ["elementwise_mult", "elementwise_add", "matmul", "dft", "idft",
           "depthwise_fir"]
