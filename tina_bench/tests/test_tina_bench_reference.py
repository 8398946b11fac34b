"""The plain reference against a float64 NumPy PFB written here from the
definition, at small P and M, whole and across two chunks (the carry)."""
import numpy as np
import pytest
import torch

from harness import drive
from reference import pfb_power as ref


def numpy_pfb_power(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """float64: y[t, p] = sum_m x[(t + m) P + p] taps[M-1-m, p], then the
    P-point DFT of each frame, then |.|^2."""
    m, p = taps.shape
    t_out = x.shape[-1] // p - m + 1
    y = np.zeros(x.shape[:-1] + (t_out, p))
    for t in range(t_out):
        for k in range(m):
            y[..., t, :] += (x[..., (t + k) * p:(t + k + 1) * p]
                             * taps[m - 1 - k].astype(np.float64))
    return np.abs(np.fft.fft(y, axis=-1)) ** 2


@pytest.mark.parametrize("p,m,window", [(8, 2, "hamming"), (16, 4, "hann"),
                                        (32, 3, "hamming")])
def test_reference_matches_numpy(p, m, window):
    rng = np.random.default_rng(p * 10 + m)
    x = rng.standard_normal((3, p * 20)).astype(np.float32)
    taps = ref.taps(p, m, window)
    want = numpy_pfb_power(x, taps)
    got = ref.power(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * want.max())


def test_taps_are_the_windowed_sinc():
    taps = ref.taps(16, 4, "hann")
    n = np.arange(64)
    h = np.sinc(n / 16 - 2.0) * np.hanning(64)
    np.testing.assert_allclose(taps.reshape(-1), h.astype(np.float32))
    assert taps.shape == (4, 16) and taps.dtype == np.float32


def test_carry_window_equals_the_whole_signal():
    """A push's steps worked out from the stream slice its window covers
    (the carry's samples, then its chunk's) equal those steps of the PFB
    over the whole concatenated signal."""
    p, m, n = 16, 4, 256
    g = torch.Generator().manual_seed(3)
    pool = torch.randn((2, 3, n), generator=g)
    taps = ref.taps(p, m, "hamming")
    whole = numpy_pfb_power(torch.cat([pool[0], pool[1]], -1).numpy(), taps)
    block, receptive = ref.stream_reach(p, m)
    first = (n - receptive) // block + 1           # steps of push 0
    steps = (2 * n - receptive) // block + 1 - first
    x = drive.stream_slice(pool, first * block,
                           first * block + (steps - 1) * block + receptive)
    got = ref.power(x, torch.from_numpy(taps)).numpy()
    np.testing.assert_allclose(got, whole[:, first:first + steps],
                               rtol=1e-12, atol=1e-12 * whole.max())


def test_stream_slice_wraps_the_pool():
    pool = torch.arange(2 * 1 * 5, dtype=torch.float32).reshape(2, 1, 5)
    got = drive.stream_slice(pool, 3, 14)
    assert got.tolist() == [[3, 4, 5, 6, 7, 8, 9, 0, 1, 2, 3]]


def test_control_is_one_tf32_pass():
    """The control rounds its DFT's operands to TF32 and nothing else:
    its gap from the float64 reference is far above float32's."""
    p, m = 64, 4
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, p * 40), generator=g)
    taps = torch.from_numpy(ref.taps(p, m, "hamming"))
    want = ref.power(x, taps)
    ctl = ref.power_tf32(x, taps).double()
    gap = ((ctl - want).abs().amax() / want.abs().amax()).item()
    assert 1e-5 < gap < 1e-2
    halfway = torch.tensor([1.0 + 2 ** -11])
    assert ref.tf32_round(halfway).item() == 1.0 + 2 ** -10
