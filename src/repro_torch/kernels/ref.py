"""Plain torch oracles for the kernels of this package.

Each ``ref_*`` matches the signature of its twin in the JAX reference's
``kernels/ref.py``; kernel tests hold kernel against oracle.
"""
from __future__ import annotations

import torch


def ref_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, y)


def ref_elementwise_mult(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x * y


def ref_elementwise_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def ref_dft(xr: torch.Tensor, xi: torch.Tensor, fr: torch.Tensor,
            fi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex matmul (Xr + iXi)(Fr + iFi) as the real/imag pair."""
    return xr @ fr - xi @ fi, xr @ fi + xi @ fr


def ref_fir_valid(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Cross-correlation, 'valid': out[.., t] = sum_k x[.., t+k] kern[k]."""
    k = kern.shape[0]
    n = x.shape[-1]
    idx = (torch.arange(n - k + 1, device=x.device)[:, None]
           + torch.arange(k, device=x.device)[None, :])
    return torch.einsum("...tk,k->...t", x[..., idx], kern)


def ref_unfold(x: torch.Tensor, window: int) -> torch.Tensor:
    n = x.shape[-1]
    idx = (torch.arange(n - window + 1, device=x.device)[:, None]
           + torch.arange(window, device=x.device)[None, :])
    return x[..., idx]


def ref_pfb_fir(frames: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """frames (..., n', P), taps (M, P) -> (..., n'-M+1, P):
    y[.., t, p] = sum_m taps[M-1-m, p] * frames[.., t+m, p]  (true FIR)."""
    m = taps.shape[0]
    nfr = frames.shape[-2]
    dev = frames.device
    idx = (torch.arange(nfr - m + 1, device=dev)[:, None]
           + torch.arange(m, device=dev)[None, :])
    return torch.einsum("...tmp,mp->...tp", frames[..., idx, :],
                        taps.flip(0))


def ref_pfb(x: torch.Tensor, taps: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full PFB: branch decompose + FIR + DFT over branches.
    Returns (real, imag) of shape (..., n'-M+1, P)."""
    m, p = taps.shape
    frames = x.reshape(x.shape[:-1] + (-1, p))
    y = ref_pfb_fir(frames, taps)
    z = torch.fft.fft(y.to(torch.float32), dim=-1)
    return z.real, z.imag


__all__ = ["ref_matmul", "ref_elementwise_mult", "ref_elementwise_add",
           "ref_dft", "ref_fir_valid", "ref_unfold", "ref_pfb_fir",
           "ref_pfb"]
