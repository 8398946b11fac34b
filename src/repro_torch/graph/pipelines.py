"""Built-in pipelines: whole signal-processing workloads as graphs,
registered in :data:`repro_torch.core.registry.PIPELINES`.

  * ``spectrogram``      unfold -> window mult -> DFT -> |·|² -> 1/J scale
  * ``pfb_power``        polyphase filter bank -> |·|² (paper §5.2 + power)
  * ``fir_decimate``     FIR -> ↓2 -> FIR -> ↓2 multi-stage decimation chain
  * ``stft_overlap_add`` windowed STFT analysis -> ISTFT overlap-add
                         synthesis (unfold -> hop -> window -> DFT ->
                         IDFT -> window -> overlap-add)
  * ``correlate``        matched filter: cross-correlation with a baked
                         template -> |·|² power, energy-normalized
  * ``cascaded_channelizer`` two-stage channelizer: half-band FIR ↓2
                         stage cascaded into a polyphase filter bank
                         -> |·|²

Each entry carries a pure-numpy oracle over the same baked constants.
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
# multi-stage FIR decimation chain
# ---------------------------------------------------------------------------
def _lowpass(k: int) -> np.ndarray:
    """Windowed-sinc half-band lowpass (cutoff 0.25 fs) for decimate-by-2."""
    n = np.arange(k) - (k - 1) / 2.0
    h = np.sinc(n / 2.0) * np.hamming(k)
    return (h / h.sum()).astype(np.float32)


def build_fir_decimate(taps1: int = 31, taps2: int = 15) -> Graph:
    g = Graph(f"fir_decimate_k{taps1}_{taps2}")
    x = g.input("x")
    t1 = g.const(_lowpass(taps1), "taps1")
    t2 = g.const(_lowpass(taps2), "taps2")
    y = g.apply("fir", x, t1)
    y = g.apply("downsample", y, factor=2)
    y = g.apply("fir", y, t2)
    y = g.apply("downsample", y, factor=2)
    g.output(y)
    return g


def _conv_rows(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """np.convolve(row, h, 'valid') of every row of x."""
    out = np.stack([np.convolve(r, h, mode="valid") for r in np.atleast_2d(x)])
    return out.reshape(x.shape[:-1] + (out.shape[-1],))


def fir_decimate_oracle(taps1: int = 31, taps2: int = 15):
    h1, h2 = _lowpass(taps1), _lowpass(taps2)

    def oracle(x):
        x = np.asarray(x, np.float32)
        y = _conv_rows(x, h1)[..., ::2]
        return _conv_rows(y, h2)[..., ::2]
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
# matched filter: cross-correlation power against a baked template
# ---------------------------------------------------------------------------
def _template(k: int) -> np.ndarray:
    """Gaussian-windowed chirp -- a deterministic matched-filter target."""
    n = np.arange(k, dtype=np.float64)
    t = (n - (k - 1) / 2.0) / (k / 4.0)
    tmpl = np.exp(-0.5 * t * t) * np.cos(2 * np.pi * (0.05 + 0.15 * n / k) * n)
    return tmpl.astype(np.float32)


def build_correlate(taps: int = 63) -> Graph:
    tmpl = _template(taps)
    energy = float(np.sum(tmpl.astype(np.float64) ** 2))
    g = Graph(f"correlate_k{taps}")
    x = g.input("x")
    t = g.const(tmpl, "template")
    # flip=False: the paper's literal Eq. (16) cross-correlation, the
    # matched-filter form
    y = g.apply("fir", x, t, flip=False)
    p = g.apply("abs2", y)                      # correlation power ...
    out = g.apply("scale", p, factor=1.0 / (energy * energy))
    g.output(out)                               # ... normalized to ‖h‖⁴
    return g


def correlate_oracle(taps: int = 63):
    tmpl = _template(taps)
    energy = float(np.sum(tmpl.astype(np.float64) ** 2))

    def oracle(x):
        x2 = np.atleast_2d(np.asarray(x, np.float32))
        c = np.stack([np.correlate(r, tmpl, mode="valid") for r in x2])
        c = c.reshape(np.asarray(x).shape[:-1] + (c.shape[-1],))
        return (c * c) / (energy * energy)
    return oracle


# ---------------------------------------------------------------------------
# cascaded two-stage channelizer: half-band decimation -> PFB power
# ---------------------------------------------------------------------------
def _chan_len(n: int, taps1: int, n_branches: int, n_taps: int) -> int:
    """Smallest valid signal length >= ~n: the stage-1 (FIR k1 + ↓2)
    output must split into whole PFB frames with at least one output
    frame."""
    p = n_branches
    t = max(n_taps + 1, -(-(n - taps1 + 2) // (2 * p)))   # ceil-div
    return taps1 - 2 + 2 * p * t


def build_cascaded_channelizer(taps1: int = 31, n_branches: int = 16,
                               n_taps: int = 4) -> Graph:
    taps = pfb_lib.pfb_window(n_branches, n_taps).astype(np.float32)
    g = Graph(f"cascaded_chan_k{taps1}_p{n_branches}m{n_taps}")
    x = g.input("x")
    h = g.const(_lowpass(taps1), "lowpass")
    t = g.const(taps, "taps")
    y = g.apply("fir", x, h)                    # stage 1: anti-alias FIR
    y = g.apply("downsample", y, factor=2)      #          ↓2
    z = g.apply("pfb", y, t)                    # stage 2: polyphase bank
    out = g.apply("abs2", z)
    g.output(out)
    return g


def cascaded_channelizer_oracle(taps1: int = 31, n_branches: int = 16,
                                n_taps: int = 4):
    h1 = _lowpass(taps1)
    taps = pfb_lib.pfb_window(n_branches, n_taps).astype(np.float32)

    def oracle(x):
        x = np.asarray(x, np.float32)
        y = _conv_rows(x, h1)[..., ::2]
        return np.abs(opdefs._np_pfb(y, taps)) ** 2   # canonical PFB oracle
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
    "fir_decimate", "4.3",
    build=build_fir_decimate, oracle=fir_decimate_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (rng.standard_normal(n).astype(np.float32),)))

register_pipeline(TinaPipeline(
    "stft_overlap_add", "4.4+4.1+4.2",
    build=build_stft_overlap_add, oracle=stft_overlap_add_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (
        rng.standard_normal(max(n, 128)).astype(np.float32),),
    round_len=lambda n: max(n, 128)))      # >= receptive field 2J - H

register_pipeline(TinaPipeline(
    "correlate", "4.3",
    build=build_correlate, oracle=correlate_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (
        rng.standard_normal(max(n, 128)).astype(np.float32),),
    round_len=lambda n: max(n, 128)))      # >= template length 63

register_pipeline(TinaPipeline(
    "cascaded_channelizer", "4.3+5.2",
    build=build_cascaded_channelizer, oracle=cascaded_channelizer_oracle(),
    lowerings=("native", "conv", "kernel"),
    make_args=lambda rng, n: (
        rng.standard_normal(_chan_len(n, 31, 16, 4)).astype(np.float32),),
    round_len=lambda n: _chan_len(n, 31, 16, 4)))


BUILTINS = ("spectrogram", "pfb_power", "fir_decimate",
            "stft_overlap_add", "correlate", "cascaded_channelizer")

__all__ = ["BUILTINS", "build_spectrogram", "build_pfb_power",
           "build_fir_decimate", "build_stft_overlap_add",
           "build_correlate", "build_cascaded_channelizer",
           "spectrogram_oracle", "pfb_power_oracle", "fir_decimate_oracle",
           "stft_overlap_add_oracle", "correlate_oracle",
           "cascaded_channelizer_oracle"]
