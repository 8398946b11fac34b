"""Built-in pipelines: whole signal-processing workloads as graphs,
registered in :data:`repro_torch.core.registry.PIPELINES`.

  * ``spectrogram``      unfold -> window mult -> DFT -> |·|² -> 1/J scale
  * ``pfb_power``        polyphase filter bank -> |·|² (paper §5.2 + power)
  * ``stft_overlap_add`` windowed STFT analysis -> ISTFT overlap-add
                         synthesis (unfold -> hop -> window -> DFT ->
                         IDFT -> window -> overlap-add)

Each entry carries a pure-numpy oracle over the same baked constants.
The reference's other three pipelines (``fir_decimate``, ``correlate``,
``cascaded_channelizer``) come with the FIR slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import opdefs
from repro_torch.core import pfb as pfb_lib
from repro_torch.core.registry import TinaPipeline, register_pipeline
from repro_torch.graph.graph import Graph


def _sliding(x: np.ndarray, j: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(x, j, axis=-1)


# ---------------------------------------------------------------------------
# spectrogram
# ---------------------------------------------------------------------------
def build_spectrogram(window: int = 64, kind: str = "hanning") -> Graph:
    win = (np.hanning(window) if kind == "hanning"
           else np.ones(window)).astype(np.float32)
    g = Graph(f"spectrogram_j{window}")
    x = g.input("x")
    w = g.const(win, "win")
    frames = g.apply("unfold", x, window=window)
    windowed = g.apply("window", frames, w)
    spec = g.apply("dft", windowed)
    power = g.apply("abs2", spec)
    out = g.apply("scale", power, factor=1.0 / window)
    g.output(out)
    return g


def spectrogram_oracle(window: int = 64, kind: str = "hanning"):
    win = (np.hanning(window) if kind == "hanning"
           else np.ones(window)).astype(np.float32)

    def oracle(x):
        frames = _sliding(np.asarray(x, np.float32), window) * win
        z = np.fft.fft(frames, axis=-1)
        return (np.abs(z) ** 2) / window
    return oracle


# ---------------------------------------------------------------------------
# PFB power spectrum
# ---------------------------------------------------------------------------
def build_pfb_power(n_branches: int = 16, n_taps: int = 8) -> Graph:
    taps = pfb_lib.pfb_window(n_branches, n_taps).astype(np.float32)
    g = Graph(f"pfb_power_p{n_branches}m{n_taps}")
    x = g.input("x")
    t = g.const(taps, "taps")
    z = g.apply("pfb", x, t)
    out = g.apply("abs2", z)
    g.output(out)
    return g


def pfb_power_oracle(n_branches: int = 16, n_taps: int = 8):
    taps = pfb_lib.pfb_window(n_branches, n_taps).astype(np.float32)

    def oracle(x):
        x = np.asarray(x, np.float32)
        return np.abs(opdefs._np_pfb(x, taps)) ** 2   # canonical PFB oracle
    return oracle


# ---------------------------------------------------------------------------
# STFT analysis -> overlap-add synthesis (windowed resynthesis)
# ---------------------------------------------------------------------------
def _sqrt_hann(j: int) -> np.ndarray:
    """sqrt of the *periodic* Hann: the same window on analysis and
    synthesis sides is an exact COLA pair at 50% overlap (the symmetric
    ``np.hanning`` is not -- its shifted squares sum to ~0.98..1.0)."""
    return np.sqrt(np.hanning(j + 1)[:-1]).astype(np.float32)


def build_stft_overlap_add(window: int = 64, hop: int = 32) -> Graph:
    if window % hop:
        raise ValueError(f"hop {hop} must divide window {window}")
    win = _sqrt_hann(window)
    g = Graph(f"stft_ola_j{window}h{hop}")
    x = g.input("x")
    w = g.const(win, "win")
    frames = g.apply("unfold", x, window=window)
    frames = g.apply("frame_decimate", frames, factor=hop)
    fw = g.apply("window", frames, w)           # analysis window
    z = g.apply("dft", fw)
    zi = g.apply("idft", z)
    r = g.apply("real", zi)
    rw = g.apply("window", r, w)                # synthesis window
    y = g.apply("overlap_add", rw, hop=hop, window=window)
    g.output(y)
    return g


def stft_overlap_add_oracle(window: int = 64, hop: int = 32):
    win = _sqrt_hann(window)

    def oracle(x):
        x = np.asarray(x, np.float32)
        frames = _sliding(x, window)[..., ::hop, :] * win
        z = np.fft.fft(frames, axis=-1)
        r = np.real(np.fft.ifft(z, axis=-1)).astype(np.float32) * win
        return opdefs._np_overlap_add(r, hop)   # the canonical OLA oracle
    return oracle


# ---------------------------------------------------------------------------
# registration, in the reference's order
# ---------------------------------------------------------------------------
register_pipeline(TinaPipeline(
    "spectrogram", "4.4+4.1",
    build=build_spectrogram, oracle=spectrogram_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (rng.standard_normal(n).astype(np.float32),)))

register_pipeline(TinaPipeline(
    "pfb_power", "5.2",
    build=build_pfb_power, oracle=pfb_power_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (
        rng.standard_normal(16 * max(16, n // 16)).astype(np.float32),),
    round_len=lambda n: 16 * max(16, n // 16)))

register_pipeline(TinaPipeline(
    "stft_overlap_add", "4.4+4.1+4.2",
    build=build_stft_overlap_add, oracle=stft_overlap_add_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (
        rng.standard_normal(max(n, 128)).astype(np.float32),),
    round_len=lambda n: max(n, 128)))      # >= receptive field 2J - H


BUILTINS = ("spectrogram", "pfb_power", "stft_overlap_add")

__all__ = ["BUILTINS", "build_spectrogram", "spectrogram_oracle",
           "build_pfb_power", "pfb_power_oracle", "build_stft_overlap_add",
           "stft_overlap_add_oracle"]
