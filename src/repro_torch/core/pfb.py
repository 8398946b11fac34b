"""Polyphase filter bank (paper §5.2, Eq. 20) built from TINA blocks.

A PFB channelizes a time-domain signal into P frequency channels:

  1. decompose x(n) into P branches  x_p(n') = x(n'·P + p)
  2. subfilter each branch with its taps  y_p(n') = Σ_m h_p(m) x_p(n'−m)
  3. DFT across the branch axis.

Step 2 is the TINA FIR mapping (depthwise conv); step 3 the TINA DFT
(pointwise conv with the Fourier matrix).  ``lowering="kernel"`` runs
the fused CUDA kernel (``csrc/pfb.cu``): the FIR accumulates in shared
memory and feeds the DFT product, so the intermediate y_p never goes to
device memory -- the round trip the paper names as TINA's main
limitation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import functions

Tensor = torch.Tensor


def pfb_window(n_branches: int, n_taps: int,
               kind: str = "hamming") -> np.ndarray:
    """Prototype low-pass filter, sinc-windowed, split across P branches
    [Price 2021].  Returns taps of shape (M, P): taps[m, p] = h(m·P + p)."""
    p, m = n_branches, n_taps
    n = np.arange(p * m, dtype=np.float64)
    x = n / p - m / 2.0
    sinc = np.sinc(x)
    if kind == "hamming":
        win = np.hamming(p * m)
    elif kind == "hanning":
        win = np.hanning(p * m)
    elif kind == "rect":
        win = np.ones(p * m)
    else:
        raise ValueError(f"unknown window {kind!r}")
    return (sinc * win).reshape(m, p)


def pfb_frontend(x: Tensor, taps: Tensor, *, lowering: str = "native",
                 block: Optional[dict] = None) -> Tensor:
    """Subfiltered signals y_p(n') (paper Fig. 3 "left column").

    x: (..., n_samples) with n_samples divisible by P; taps: (M, P).
    Returns (..., n_frames − M + 1, P).  ``block``: block-size overrides
    for the kernel ({"bt", "bn"}); ignored by the other lowerings."""
    m, p = taps.shape
    if x.shape[-1] % p:
        raise ValueError(f"n_samples {x.shape[-1]} not divisible by P={p}")
    batch = x.shape[:-1]
    frames = x.reshape(batch + (-1, p))            # (..., n', P)
    if lowering == "kernel":
        from repro_torch.kernels import ops
        return ops.pfb_fir(frames, taps, **(block or {}))
    if lowering == "conv":
        # per-branch standard conv: correlation with time-reversed taps
        y = functions.depthwise_fir(frames, taps.flip(0), causal=True,
                                    lowering="conv")
        return y[..., m - 1:, :]
    if lowering != "native":
        raise ValueError(f"unknown lowering {lowering!r}")
    nfr = frames.shape[-2]
    dev = x.device
    idx = (torch.arange(nfr - m + 1, device=dev)[:, None]
           + torch.arange(m, device=dev)[None, :])
    windows = frames[..., idx, :]                  # (..., n'-M+1, M, P)
    return torch.einsum("...tmp,mp->...tp", windows, taps.flip(0))


def pfb(x: Tensor, taps: Tensor, *, lowering: str = "native",
        variant: str = "4mult", block: Optional[dict] = None) -> Tensor:
    """Full PFB: frontend + DFT across branches (paper Fig. 3 "right
    column").  Returns complex spectra (..., n_frames − M + 1, P)."""
    if lowering == "kernel":
        from repro_torch.kernels import ops
        return ops.pfb(x, taps, variant=variant, **(block or {}))
    y = pfb_frontend(x, taps, lowering=lowering)
    return functions.dft(y, lowering=lowering, variant=variant)


__all__ = ["pfb_window", "pfb_frontend", "pfb"]
