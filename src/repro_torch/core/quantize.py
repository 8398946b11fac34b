"""Quantization for TINA ops (paper §1 claim: mapping non-NN algorithms
onto NN layers lets them inherit NN-ecosystem tooling such as
quantization; the "TINA 16 bit" column of the paper's Fig. 3 is this
idea at fp16).

Symmetric int8 post-training quantization of the TINA *kernels* (the
conv/dense weights that carry the DFM, FIR taps, PFB prototype):

    W_q = round(W / s),  s = max|W| / 127        (per output channel)
    y  = (X_q W_q) · s_x · s_w                   (int32 accumulate)

These are the ``native`` int8 lowering of the port, in plain torch, and
the numeric contract the CUDA int8 kernels are held to bit for bit:
the same quantize decisions, an exact integer contraction, and one
left-associated f32 rescale ``(acc · s_x) · s_w`` at the epilogue.

Engines (:func:`int8_dot` / :func:`int8_einsum`, switched with
:func:`engine_override`; the planner keys its plan cache on
:func:`engine`):

  * ``"int"`` (default): the int8 operands are widened to float64 and
    contracted with ``torch.matmul`` / ``torch.einsum``, then cast to
    int32.  Every product is an integer of magnitude <= 127² and every
    partial sum stays below K·127² < 2⁵³, so float64 holds each one
    exactly whatever the summation order: the result is the exact int32
    sum.  This route runs on both devices (torch's integer GEMM exists
    on the CPU only; ``torch.matmul`` of int32 raises on CUDA).
  * ``"ref"``: the reference's int-upcast substrate -- the operands
    widened to int64 and contracted with torch's integer
    ``matmul`` / ``einsum``.  torch has those on the CPU only, so on a
    CUDA tensor this engine raises; it is the CPU oracle the ``int``
    engine is tested against (the two are bit-identical).

Streaming note: activation quantization uses per-row / per-window
scales over axes a streamed chunk carries whole (``axis=-1`` rows,
per-window scales for FIR, per-(frame, branch) scales for the PFB
frontend), so a frame's quantized values depend only on that frame.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

Tensor = torch.Tensor

_ENGINES = ("int", "ref")
_ENGINE = "int"
QMAX = 127


def engine() -> str:
    """The active integer-contraction engine: ``"int"`` or ``"ref"``."""
    return _ENGINE


@contextlib.contextmanager
def engine_override(name: str):
    """Temporarily switch the contraction engine.  Plans compiled inside
    the context run that engine and get their own plan-cache slot."""
    global _ENGINE
    if name not in _ENGINES:
        raise ValueError(f"unknown quantize engine {name!r}; "
                         f"expected one of {_ENGINES}")
    prev, _ENGINE = _ENGINE, name
    try:
        yield
    finally:
        _ENGINE = prev


def _check_ref(*ts: Tensor) -> None:
    for t in ts:
        if t.device.type != "cpu":
            raise RuntimeError(
                "quantize engine 'ref' contracts with torch's integer GEMM, "
                f"which exists on the CPU only (got a {t.device} tensor); "
                "use the default 'int' engine on a card")


def int8_dot(xq: Tensor, wq: Tensor) -> Tensor:
    """int8 × int8 -> int32 contraction of ``xq``'s last axis with
    ``wq``'s first (matmul shape rules; leading ``xq`` axes are free)."""
    if _ENGINE == "ref":
        _check_ref(xq, wq)
        return torch.matmul(xq.to(torch.int64),
                            wq.to(torch.int64)).to(torch.int32)
    return torch.matmul(xq.to(torch.float64),
                        wq.to(torch.float64)).to(torch.int32)


def int8_einsum(spec: str, xq: Tensor, wq: Tensor) -> Tensor:
    """int8 × int8 -> int32 einsum (same engine switch as
    :func:`int8_dot`)."""
    if _ENGINE == "ref":
        _check_ref(xq, wq)
        return torch.einsum(spec, xq.to(torch.int64),
                            wq.to(torch.int64)).to(torch.int32)
    return torch.einsum(spec, xq.to(torch.float64),
                        wq.to(torch.float64)).to(torch.int32)


def scale_of(amax: Tensor) -> Tensor:
    """Symmetric int8 scale of an amax: ``max(amax, 1e-12) · (1/127)``.
    One IEEE multiply by the f32 reciprocal, NOT a divide by 127: the
    CUDA kernels compute per-window scales with exactly this formula
    (``csrc/int8.cuh:scale_of``), and the reference does the same."""
    return torch.clamp(amax, min=1e-12) * (1.0 / QMAX)


def quantize_with(x: Tensor, scale: Tensor) -> Tensor:
    """``clip(round(x / scale), ±127)`` as int8: a correctly rounded
    division, rounded half to even (``torch.round``, as ``jnp.round``
    and the kernels' ``rintf``)."""
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)


def quantize_symmetric(x: Tensor, *, axis=None):
    """Returns (q int8, scale f32).  ``axis``: per-channel scales along
    that axis, kept as a size-1 dim (None = per-tensor)."""
    if axis is None:
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = scale_of(amax)
    return quantize_with(x, scale), scale.to(torch.float32)


def dequantize(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def qmatmul(x: Tensor, wq: Tensor, w_scale: Tensor, *,
            quantize_activations: bool = True) -> Tensor:
    """TINA matmul (pointwise-conv mapping) with an int8 kernel.

    ``quantize_activations=True`` is the full-int8 path (per-row
    activation scales, int8 × int8 -> int32 through :func:`int8_dot`,
    ``(acc · s_x) · s_w``); False keeps activations in float
    (weight-only quantization, not used by the int8 tier)."""
    if quantize_activations:
        xq, x_scale = quantize_symmetric(x, axis=-1)
        acc = int8_dot(xq, wq)
        return (acc.to(torch.float32) * x_scale
                * w_scale.reshape((1,) * (acc.ndim - 1) + (-1,)))
    return torch.matmul(x.to(torch.float32),
                        dequantize(wq, w_scale.reshape(1, -1)))


# ---------------------------------------------------------------------------
# weight/tap quantization (done ONCE at plan build; packs ride the Plan)
# ---------------------------------------------------------------------------
def quantize_weights(w: Tensor):
    """Per-output-channel int8 pack for a dense (k, n) matmul weight."""
    return quantize_symmetric(w.to(torch.float32), axis=0)


def quantize_fir_taps(taps: Tensor, *, flip: bool = True):
    """int8 pack of FIR taps as the (k, 1) unfold-matmul kernel column.
    ``flip=True`` reverses the taps (true convolution); ``flip=False``
    keeps the literal cross-correlation form (the paper's Eq. 16)."""
    taps = taps.to(torch.float32)
    kern = taps.flip(0) if flip else taps
    return quantize_symmetric(kern.reshape(-1, 1), axis=0)


def quantize_pfb_taps(taps: Tensor):
    """int8 pack of a (M, P) PFB prototype, per-branch scales, stored in
    the (reversed-window) orientation the frontend contraction consumes."""
    return quantize_symmetric(taps.to(torch.float32).flip(0), axis=0)


# ---------------------------------------------------------------------------
# quantized TINA signal ops
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _qdfm(n: int, inverse: bool = False):
    """int8-quantized (inverse) Discrete Fourier Matrix, per-column
    scales.  The inverse matrix carries the 1/n factor; per-column
    scales absorb it, so quantization error stays relative.

    Pure numpy, line for line the reference's: it divides by ``qmax``
    (it is a weight built once, not a per-window scale), which is how it
    gets the reference's bits."""
    lk = np.outer(np.arange(n), np.arange(n))
    sign = 1j if inverse else -1j
    f = np.exp(sign * 2 * np.pi * lk / n)
    if inverse:
        f = f / n
    qmax = 127

    def qnp(a):
        scale = np.maximum(np.max(np.abs(a), axis=0, keepdims=True),
                           1e-12) / qmax
        q = np.clip(np.round(a / scale), -qmax, qmax).astype(np.int8)
        return q, scale.reshape(-1).astype(np.float32)

    qr, sr = qnp(f.real.astype(np.float32))
    qi, si = qnp(f.imag.astype(np.float32))
    return (qr, sr), (qi, si)


@functools.lru_cache(maxsize=16)
def _qdfm_tensors(n: int, inverse: bool, device: str
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(qr, sr, qi, si) of :func:`_qdfm` on ``device``, uploaded once per
    (n, inverse, device) and kept (1 MB each at n = 1024)."""
    (qr, sr), (qi, si) = _qdfm(n, inverse)
    return tuple(torch.as_tensor(a, device=device) for a in (qr, sr, qi, si))


def qdft(x: Tensor, *, inverse: bool = False,
         quantize_activations: bool = True) -> Tensor:
    """(I)DFT with an int8 Fourier-matrix kernel (paper §4.1/§4.2
    mapping + §1 quantization claim).

    Real input runs the 2-real-matmul form; complex input expands to
    the 4-real-matmul form ``z·W = (zr·Wr − zi·Wi) + i(zr·Wi + zi·Wr)``,
    each part an int8 x int8 -> int32 matmul.  Each term is rounded to
    f32 before the cross-term combine (no FMA across it)."""
    n = x.shape[-1]
    qr, sr, qi, si = _qdfm_tensors(n, inverse, str(x.device))
    shp = x.shape
    x2 = x.reshape(-1, n)
    mm = functools.partial(qmatmul, quantize_activations=quantize_activations)
    if x2.is_complex():
        zr = x2.real.to(torch.float32)
        zi = x2.imag.to(torch.float32)
        out = torch.complex(mm(zr, qr, sr) - mm(zi, qi, si),
                            mm(zr, qi, si) + mm(zi, qr, sr))
    else:
        out = torch.complex(mm(x2, qr, sr), mm(x2, qi, si))
    return out.reshape(shp[:-1] + (n,))


def qidft(x: Tensor, *, quantize_activations: bool = True) -> Tensor:
    """Inverse DFT with an int8 inverse-DFM kernel."""
    return qdft(x, inverse=True, quantize_activations=quantize_activations)


def qfir(x: Tensor, taps: Tensor | None = None, *, flip: bool = True,
         quantize_activations: bool = True,
         qtaps: tuple[Tensor, Tensor] | None = None) -> Tensor:
    """'valid' FIR with int8 taps via the unfold + matmul form of the
    standard conv.  Activations quantize per WINDOW (each unfold row its
    own scale), so the contraction stays int8.  ``qtaps``: a pre-built
    :func:`quantize_fir_taps` pack (the plan-build path)."""
    if qtaps is None:
        qtaps = quantize_fir_taps(taps, flip=flip)
    tq, ts = qtaps
    k = tq.shape[0]
    n = x.shape[-1]
    idx = (torch.arange(n - k + 1, device=x.device)[:, None]
           + torch.arange(k, device=x.device)[None, :])
    w2 = x[..., idx].reshape(-1, k)                   # (..., n-k+1, k)
    y = qmatmul(w2, tq, ts, quantize_activations=quantize_activations)
    return y.reshape(x.shape[:-1] + (n - k + 1,))


def qpfb_frontend(x: Tensor, taps: Tensor | None = None, *,
                  qtaps: tuple[Tensor, Tensor] | None = None) -> Tensor:
    """PFB frontend (polyphase FIR bank) with int8 prototype taps
    (per-branch scales) and int8 activations: each (frame t, branch p)
    window quantizes over its M-tap extent (``axis=-2``), so the branch
    contraction is a true int8 × int8 -> int32 einsum."""
    if qtaps is None:
        qtaps = quantize_pfb_taps(taps)
    tq, ts = qtaps
    m, p = tq.shape
    frames = x.reshape(x.shape[:-1] + (-1, p))
    nfr = frames.shape[-2]
    idx = (torch.arange(nfr - m + 1, device=x.device)[:, None]
           + torch.arange(m, device=x.device)[None, :])
    windows = frames[..., idx, :]                     # (..., t, m, p)
    wq, w_scale = quantize_symmetric(windows, axis=-2)
    acc = int8_einsum("...tmp,mp->...tp", wq, tq)     # int32, exact
    return acc.to(torch.float32) * w_scale[..., 0, :] * ts


def qpfb(x: Tensor, taps: Tensor | None = None, *,
         qtaps: tuple[Tensor, Tensor] | None = None) -> Tensor:
    """Full PFB with int8 prototype taps + int8 DFM (paper §5.2 under
    the §1 quantization claim), integer end to end: the frontend runs
    the int8 einsum and the DFT stage re-quantizes the subfiltered
    frames per row for the int8 DFM matmul."""
    y = qpfb_frontend(x, taps, qtaps=qtaps)
    return qdft(y, quantize_activations=True)


__all__ = ["quantize_symmetric", "dequantize", "qmatmul", "qdft", "qidft",
           "qfir", "qpfb_frontend", "qpfb", "quantize_weights",
           "quantize_fir_taps", "quantize_pfb_taps", "int8_dot",
           "int8_einsum", "engine", "engine_override", "scale_of",
           "quantize_with"]
