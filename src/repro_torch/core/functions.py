"""TINA function mappings (paper §3 arithmetic + §4 signal processing),
the part of them the ported pipelines reach.

Each function expresses a non-NN operation through the building blocks
of :mod:`repro_torch.core.blocks` (Table 1 of the paper) and takes
``lowering=``: ``"conv"`` (paper-faithful NN layer), ``"native"``
(matmul / elementwise / data-movement form) or ``"kernel"`` (the
hand-written CUDA kernels of :mod:`repro_torch.kernels.ops`, the
reference's ``pallas``).  ``elementwise_mult``, ``elementwise_add``,
``matmul``, ``dft``, ``idft``, ``fir``, ``unfold`` and ``overlap_add``
have all three; ``summation`` is one fully connected layer whatever
the lowering, and ``depthwise_fir`` has ``native`` and ``conv``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import made_once
from repro_torch.core import blocks

Tensor = torch.Tensor
LOWERINGS = ("native", "conv", "kernel")


def _kops():
    # deferred import: core must not hard-depend on kernels at import time
    from repro_torch.kernels import ops
    return ops


def _check_lowering(fn: str, lowering: str) -> None:
    if lowering not in LOWERINGS:
        raise ValueError(f"{fn}: unknown lowering {lowering!r}")


# ---------------------------------------------------------------------------
# §3.1 elementwise multiplication -- depthwise conv, Eq. (6)
# ---------------------------------------------------------------------------
def elementwise_mult(x: Tensor, y: Tensor, *, lowering: str = "native",
                     block: Optional[dict] = None) -> Tensor:
    """Elementwise x*y of same-shape tensors via a depthwise conv whose
    H = W = 1 and C_out = H*W (paper Eq. 6).  Batched over x.shape[:-2].

    ``block``: optional kernel block-size overrides (``{"threads": 512}``)
    forwarded to :mod:`repro_torch.kernels.ops`; ignored by the other
    lowerings.  Same for every ``block=`` below."""
    if x.shape[-2:] != y.shape[-2:]:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    _check_lowering("elementwise_mult", lowering)
    if lowering == "kernel":
        return _kops().elementwise_mult(x, y, **(block or {}))
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
    if x.shape[-2:] != y.shape[-2:]:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    _check_lowering("elementwise_add", lowering)
    if lowering == "kernel":
        return _kops().elementwise_add(x, y, **(block or {}))
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
           block: Optional[dict] = None,
           yt_planes: Optional[Tensor] = None,
           yt: Optional[Tensor] = None) -> Tensor:
    """Z = X @ Y via pointwise conv: X (.., M, L) becomes the conv input
    (T, C_in=L, 1, W=M); the kernel is Y (L, N) (paper Eq. 9).  ``kernel``
    runs the GEMM kernel of the operands' dtype (fp32 or bf16); that
    lowering only: ``yt_planes`` are an fp32 y's TF32 planes and ``yt`` a
    bf16 y's K-major copy, where a caller made them once."""
    _check_lowering("matmul", lowering)
    if y.ndim != 2:
        raise ValueError("TINA matmul kernel (conv weight) must be 2-D")
    if lowering == "kernel":
        return _kops().matmul(x, y, yt_planes=yt_planes, yt=yt,
                              **(block or {}))
    if lowering == "native":
        return torch.matmul(x, y)
    m, l = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    xi = x.reshape((-1, m, l)).transpose(1, 2)[:, :, None, :]   # (T, L, 1, M)
    out = blocks.pointwise_conv(xi, y, lowering=lowering)
    out = out[:, :, 0, :].transpose(1, 2)                        # (T, M, N)
    return out.reshape(batch + (m, y.shape[1]))


# ---------------------------------------------------------------------------
# §3.4 summation -- fully connected, ones weights, Eq. (11)
# ---------------------------------------------------------------------------
def summation(x: Tensor, *, lowering: str = "native") -> Tensor:
    """sum(x) over the last axis via a dense layer with all-ones weights,
    zero bias, C_out = 1 (paper Eq. 11).  Leading dims are batch; the one
    layer is the same code whatever the lowering."""
    _check_lowering("summation", lowering)
    ones = torch.ones((x.shape[-1], 1), dtype=x.dtype, device=x.device)
    return blocks.fully_connected(x, ones, lowering=lowering)[..., 0]


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


@functools.lru_cache(maxsize=64)
def _dfm_tensors(n: int, inverse: bool, dtype: torch.dtype,
                 device: str) -> tuple[Tensor, Tensor]:
    """The (I)DFM as tensors on ``device``, made once per (n, inverse,
    dtype, device): under ``jit`` the reference folds it into a
    constant, and uploading it per call would copy 8 MB at n = 1024."""
    fr, fi = _dfm(n, inverse, str(dtype).removeprefix("torch."))
    return (torch.as_tensor(fr, device=device),
            torch.as_tensor(fi, device=device))


@made_once(64)
def _dfm_tf32_tensors(n: int, inverse: bool, variant: str,
                      device: str) -> Tensor:
    """The f32 DFT kernel's F side: the hi and lo TF32 parts of the
    (I)DFM's planes, K-major and zero-padded
    (``kernels/dft.py:tf32_planes``), made once per (n, inverse, variant,
    device) beside :func:`_dfm_tensors`, and read from any stream
    (:func:`repro_torch.made_once`)."""
    from repro_torch.kernels import dft as dft_kernel
    fr, fi = _dfm_tensors(n, inverse, torch.float32, device)
    return dft_kernel.tf32_planes(fr, fi, variant)


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
    _check_lowering("dft", lowering)
    n = x.shape[-1]
    rdt = _REAL_OF.get(x.dtype, x.dtype)
    fr, fi = _dfm_tensors(n, inverse, rdt, str(x.device))
    if lowering == "kernel":
        # a real signal goes in as it is: the kernel forms no zero plane;
        # the card's kernel takes the DFM's TF32 planes, made once
        planes = (_dfm_tf32_tensors(n, inverse, variant, str(x.device))
                  if x.device.type == "cuda" and rdt == torch.float32
                  else None)
        z = _kops().dft(x.reshape((-1, n)), fr, fi, variant=variant,
                        planes=planes, **(block or {}))
        return z.reshape(x.shape[:-1] + (n,))
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
# §4.3 FIR filter -- standard conv with taps as weights, Eq. (16)
# ---------------------------------------------------------------------------
def mode_pads(k: int, mode: str, flip: bool = True) -> tuple[int, int]:
    """(pad_left, pad_right) of a K-tap filter in scipy's ``mode``:
    'valid' none, 'full' K − 1 each side, 'same' (K − 1) in all, its
    extra sample at an even K on the left for a true convolution
    (``flip``, as ``np.convolve``) and on the right for a correlation.
    These are the reference's native/conv pads; its Pallas wrapper pads
    every 'same' as a correlation, one sample off for an even-K
    convolution, and the port does not copy that."""
    if mode == "valid":
        return 0, 0
    if mode == "same":
        return (k // 2, (k - 1) // 2) if flip else ((k - 1) // 2, k // 2)
    if mode == "full":
        return k - 1, k - 1
    raise ValueError(f"unknown mode {mode!r}")


def fir(x: Tensor, taps: Tensor, *, mode: str = "valid",
        lowering: str = "native", flip: bool = True,
        block: Optional[dict] = None) -> Tensor:
    """FIR filter y(i) = Σ_k a(k) x(i−k) over the last axis.

    The paper's Eq. (16) is a cross-correlation; a true FIR convolution
    needs the taps reversed, which ``flip=True`` (default) does --
    ``flip=False`` is the literal Eq. (16).  ``mode`` follows scipy:
    "valid" (paper), "same", "full", with the pads of :func:`mode_pads`
    on every lowering.  ``kernel`` pads and reverses the taps implicitly
    inside the FIR kernel; ``native`` and ``conv`` reverse and pad, then
    run the TINA standard conv."""
    _check_lowering("fir", lowering)
    k = taps.shape[-1]
    pad_left, pad_right = mode_pads(k, mode, flip)
    if lowering == "kernel":
        return _kops().fir(x, taps, pad_left=pad_left, pad_right=pad_right,
                           flip=flip, **(block or {}))
    kern = taps.flip(-1) if flip else taps
    w = x.shape[-1]
    xi = x.reshape((-1, 1, 1, w))                          # (T, 1, 1, W)
    k4 = kern.reshape(1, 1, 1, k)                          # OIHW
    pad = ("VALID" if mode == "valid"
           else ((0, 0), (pad_left, pad_right)))
    out = blocks.standard_conv(xi, k4, padding=pad, lowering=lowering)
    return out.reshape(x.shape[:-1] + (out.shape[-1],))


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


# ---------------------------------------------------------------------------
# overlap-add synthesis -- transposed conv with identity kernel
# (beyond paper: the inverse of §4.4 unfolding, what ISTFT needs)
# ---------------------------------------------------------------------------
def overlap_add(frames: Tensor, hop: int, *, lowering: str = "native",
                block: Optional[dict] = None) -> Tensor:
    """Valid-mode overlap-add: frames (..., T, J) at stride ``hop`` back
    onto the time axis, emitting only the output samples covered by all
    K = J/hop overlapping frames.  Returns (..., (T − K + 1)·hop); output
    sample s is Σ_m frames[s//hop + m, J − (m+1)·hop + s%hop].

    ``conv`` is a transposed standard conv whose identity kernel scatters
    each frame at its hop offset, sliced to the valid region; ``native``
    sums the K diagonal sub-blocks directly; ``kernel`` is the CUDA
    kernel's form of the same sum, bit-identical to ``native`` (the adds
    run in the same ascending-m order).  Complex frames go through
    ``kernel`` and ``conv`` as real and imaginary parts (pure adds: the
    recombination is exact)."""
    t, j = frames.shape[-2], frames.shape[-1]
    h = int(hop)
    if h <= 0 or j % h:
        raise ValueError(f"hop {h} must divide the frame length {j}")
    k = j // h
    if t < k:
        raise ValueError(f"overlap_add needs >= {k} frames of length {j} "
                         f"at hop {h}, got {t}")
    _check_lowering("overlap_add", lowering)
    nt = t - k + 1
    batch = frames.shape[:-2]
    if lowering != "native" and frames.is_complex():
        return torch.complex(
            overlap_add(frames.real, h, lowering=lowering, block=block),
            overlap_add(frames.imag, h, lowering=lowering, block=block))
    if lowering == "kernel":
        return _kops().overlap_add(frames, h, **(block or {}))
    if lowering == "conv":
        xi = frames.reshape((-1, t, j))
        eye = torch.eye(j, dtype=frames.dtype,
                        device=frames.device)[:, :, None]   # (K=J, I=J, O=1)
        full = blocks.transposed_conv(xi, eye, stride=h, lowering="conv")
        out = full[:, (k - 1) * h:(k - 1) * h + nt * h, 0]
        return out.reshape(batch + (nt * h,))
    # native: o_t = Σ_m f_{t+m}[(K−1−m)·h : (K−m)·h], ascending m
    fk = frames.reshape(batch + (t, k, h))
    acc = fk[..., 0:nt, k - 1, :]
    for m in range(1, k):
        acc = acc + fk[..., m:m + nt, k - 1 - m, :]
    return acc.reshape(batch + (nt * h,))


# ---------------------------------------------------------------------------
# §4.4 unfolding -- standard conv with identity kernel, Eq. (19)
# ---------------------------------------------------------------------------
def unfold(x: Tensor, window: int, *, lowering: str = "native",
           block: Optional[dict] = None) -> Tensor:
    """Y(i, j) = X(i + j): (.., N) -> (.., N-J+1, J).

    ``conv`` is the paper-faithful identity-kernel conv (N·J² MACs);
    ``native`` is a strided view of the input, the way XLA fuses the
    reference's gather into its consumer; ``kernel`` writes the whole
    window tensor with the CUDA kernel, as the reference's Pallas kernel
    does."""
    n = x.shape[-1]
    j = int(window)
    if not 1 <= j <= n:
        raise ValueError(f"window {j} outside [1, length {n}]")
    _check_lowering("unfold", lowering)
    if lowering == "kernel":
        return _kops().unfold(x, j, **(block or {}))
    batch = x.shape[:-1]
    if lowering == "native":
        xc = x.contiguous()
        return xc.as_strided(batch + (n - j + 1, j),
                             tuple(xc.stride()[:-1]) + (1, 1))
    xi = x.reshape((-1, 1, 1, n))
    eye = torch.eye(j, dtype=x.dtype, device=x.device).reshape(j, 1, 1, j)
    out = blocks.standard_conv(xi, eye, lowering=lowering)  # (T, J, 1, N-J+1)
    return out[:, :, 0, :].transpose(1, 2).reshape(batch + (n - j + 1, j))


__all__ = ["elementwise_mult", "elementwise_add", "matmul", "summation",
           "dft", "idft", "fir", "depthwise_fir", "overlap_add", "unfold"]
