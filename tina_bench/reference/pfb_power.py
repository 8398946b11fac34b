"""Plain reference of the ``pfb_power`` pipeline: a polyphase filter bank
(an M-tap FIR per branch over frames of P samples, then a P-point DFT
across the branches) followed by the power |z|^2 of every channel.

Plain PyTorch only: it imports nothing of the program.  The taps come
from :func:`taps`, a frozen copy of the windowed-sinc prototype filter
[Price 2021], which the benchmark hands to the program and to this
reference alike.

Semantics, for x of shape (rows, n) with n a multiple of P, frames
f[t, p] = x[t P + p]:

    y[t, p] = sum_{m=0}^{M-1} f[t + m, p] * taps[M - 1 - m, p]
    z[t, k] = sum_p y[t, p] exp(-2 pi i k p / P)
    power[t, k] = |z[t, k]|^2,   t = 0 .. n / P - M

so one output step (a frame of P channels) reads M P samples and steps
by P: the stream's receptive field and block.
"""
from __future__ import annotations

import math

import numpy as np
import torch

WINDOWS = {"hamming": np.hamming, "hann": np.hanning}


def taps(n_branches: int, n_taps: int, window: str) -> np.ndarray:
    """The prototype low-pass filter split across the branches: a sinc of
    P M points, one zero crossing a branch count, times a Hamming or Hann
    window, as float32 of shape (M, P): taps[m, p] = h(m P + p)."""
    p, m = n_branches, n_taps
    n = np.arange(p * m, dtype=np.float64)
    h = np.sinc(n / p - m / 2.0) * WINDOWS[window](p * m)
    return h.reshape(m, p).astype(np.float32)


def stream_reach(n_branches: int, n_taps: int) -> tuple[int, int]:
    """(block, receptive) of one output step, in input samples."""
    return n_branches, n_branches * n_taps


def frontend(x: torch.Tensor, taps_mp: torch.Tensor) -> torch.Tensor:
    """The FIR bank: x (rows, n) -> y (rows, n / P - M + 1, P), in the
    dtype of x (the taps are cast to it)."""
    m, p = taps_mp.shape
    frames = x.reshape(x.shape[0], -1, p)
    t_out = frames.shape[1] - m + 1
    rev = taps_mp.to(x.dtype).flip(0)
    y = rev[0] * frames[:, 0:t_out]
    for k in range(1, m):
        y = y + rev[k] * frames[:, k:k + t_out]
    return y


def power(x: torch.Tensor, taps_mp: torch.Tensor,
          rows_per_block: int = 8) -> torch.Tensor:
    """|PFB(x)|^2 in float64, worked out in blocks of rows so that it fits
    beside the outputs it judges; returns float64 (rows, T, P)."""
    outs = []
    for r0 in range(0, x.shape[0], rows_per_block):
        y = frontend(x[r0:r0 + rows_per_block].to(torch.float64),
                     taps_mp.to(x.device))
        z = torch.fft.fft(y, dim=-1)
        outs.append(z.real.square() + z.imag.square())
        del y, z
    return torch.cat(outs)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as a tensor core reads an operand in TF32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def power_tf32(x: torch.Tensor, taps_mp: torch.Tensor,
               rows_per_block: int = 8) -> torch.Tensor:
    """The control: the same pipeline in float32 with its DFT taken as one
    TF32 pass (operands rounded to TF32, products summed in float32), the
    step below float32 that a faster DFT would take.  Returns float32."""
    p = taps_mp.shape[1]
    k = torch.arange(p, dtype=torch.float64, device=x.device)
    ang = (-2.0 * math.pi / p) * torch.outer(k, k).remainder(p)
    fr = tf32_round(torch.cos(ang).to(torch.float32))
    fi = tf32_round(torch.sin(ang).to(torch.float32))
    outs = []
    for r0 in range(0, x.shape[0], rows_per_block):
        y = tf32_round(frontend(x[r0:r0 + rows_per_block].to(torch.float32),
                                taps_mp.to(x.device)))
        re, im = y @ fr, y @ fi          # F is symmetric: y F == y F^T
        outs.append(re.square() + im.square())
        del y, re, im
    return torch.cat(outs)


__all__ = ["taps", "stream_reach", "frontend", "power", "tf32_round",
           "power_tf32", "WINDOWS"]
