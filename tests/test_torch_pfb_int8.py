"""The int8 PFB's two kernels on the CPU, against the JAX package.

``csrc/qpfb.cu`` runs the int8 PFB as a frontend (each (frame, branch)
window quantized on its own, the int32 MAC with the reversed taps, each
frame's y requantized over P into an int8 row of stride P_pad, P rounded
up to 16, and its scale) and then the s8 tensor-core DFT over those rows
against the K-major copies of the int8 Fourier planes, zero-padded to
P_pad.  Here the frontend's plain twin followed by the int8 DFT's plain
version on those padded K-major operands is held bit for bit against the
fused plain version, the JAX Pallas kernel (``kernels/pfb.py:
pfb_fused_int8`` in interpret mode) and the JAX ``quantize.qpfb``, at
P = 16, 20, 48 and 64 (20 and 48 not multiples of 16 or of the DFT's
64-wide tile), M = 3, 4 and 8, and on inputs whose x / scale quotients
are exact half-integers.  Inputs are made with numpy from a fixed seed
and handed to both packages.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels import pfb as jpfb
from repro_torch.core import quantize
from repro_torch.core.pfb import pfb_window
from repro_torch.kernels import dft as dftk
from repro_torch.kernels import elementwise as ewk
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops, tune
from repro_torch.kernels import pfb as pfbk

PS = [16, 20, 48, 64]
MS = [3, 4, 8]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    assert np.array_equal(got, want), float(np.max(np.abs(got - want)))


def half_integer_frames(shape, period, seed):
    """f32 frames (B, T, P) every M-window along T of which holds one ±a,
    so each window's scale is s = 9/1024, and whose other samples are
    exact half-integer multiples of s: x / s is exactly k + 0.5, the case
    round half to even decides."""
    a, s = np.float32(1.1162109375), np.float32(9 / 1024)
    assert np.float32(a * (np.float32(1) / np.float32(127))) == s
    rng = np.random.default_rng(seed)
    x = ((rng.integers(-100, 100, shape) + 0.5) * s).astype(np.float32)
    signs = np.where(rng.random(shape) < 0.5, -a, a).astype(np.float32)
    x[:, ::period] = signs[:, ::period]
    q = x[np.abs(x) != a] / s
    assert np.all(q - np.floor(q) == np.float32(0.5))
    return x


def _packs(p, m, seed):
    """(tq, ts) of a PFB prototype, and the int8 DFM (qr, sr, qi, si)."""
    taps = (pfb_window(p, m).astype(np.float32) if seed is None else
            _rng("taps", p, m, seed).standard_normal((m, p)).astype(
                np.float32))
    tq, ts = quantize.quantize_pfb_taps(torch.from_numpy(taps))
    return tq, ts.reshape(-1), quantize._qdfm_tensors(p, False, "cpu")


def _two_stage(frames, tq, ts, qr, sr, qi, si):
    """The frontend twin, then dft_int8_plain on the padded K-major
    operands the DFT kernel reads: complex64 (B, Tout, N)."""
    b, t, p = frames.shape
    p_pad = pfbk.padded_width(p)
    yq, ys = pfbk.pfb_frontend_int8_plain(frames, tq, ts)
    assert yq.shape == (b * (t - tq.shape[0] + 1), p_pad)
    assert yq.dtype == torch.int8 and ys.dtype == torch.float32
    assert not yq[:, p:].any()                     # the pad bytes are zero
    qrt, qit = quantize._qdfm_kmajor(p, False, "cpu")
    frt, fit = mmk.pad_k(qrt, p_pad), mmk.pad_k(qit, p_pad)
    z = dftk.dft_int8_plain(yq, frt.t(), fit.t(), ys, sr, si)
    return z.reshape(b, -1, qr.shape[1])


def _jax_kernel(frames, tq, ts, qr, sr, qi, si):
    """The JAX Pallas kernel in interpret mode: (zr, zi), each (B, Tout,
    N) float32."""
    b, t, p = frames.shape
    m = tq.shape[0]
    bt = 8
    xp = np.pad(frames.numpy(), ((0, 0), (0, (-t) % bt), (0, 0)))
    j = [jnp.asarray(a.numpy()) for a in (tq, qr, qi)]
    zr, zi = jpfb.pfb_fused_int8(
        jnp.asarray(xp), j[0], jnp.asarray(ts.numpy()).reshape(1, p), j[1],
        j[2], jnp.asarray(sr.numpy()).reshape(1, -1),
        jnp.asarray(si.numpy()).reshape(1, -1), bt=bt, bn=qr.shape[1],
        interpret=True)
    tout = t - m + 1
    return np.asarray(zr)[:, :tout], np.asarray(zi)[:, :tout]


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("p", PS)
def test_frontend_then_dft_equals_fused_plain_and_jax(p, m):
    rng = _rng("qpfb2", p, m)
    x = rng.standard_normal((2, 37 * p)).astype(np.float32)
    tq, ts, (qr, sr, qi, si) = _packs(p, m, seed=1)
    frames = torch.from_numpy(x).reshape(2, 37, p)
    got = _two_stage(frames, tq, ts, qr, sr, qi, si)
    _bitwise(got, pfbk.pfb_fused_int8_plain(frames, tq, ts, qr, qi, sr, si))
    # the CPU wrapper is that plain version
    _bitwise(pfbk.pfb_fused_int8(frames, tq, ts, qr, qi, sr, si), got)
    # JAX's integer path on the same taps
    want = np.asarray(jq.qpfb(jnp.asarray(x), qtaps=(
        jnp.asarray(tq.numpy()), jnp.asarray(ts.numpy()).reshape(1, p))))
    _bitwise(got.reshape(want.shape), want)


@pytest.mark.parametrize("p,m", list(zip(PS, [4, 8, 3, 8])))
def test_frontend_then_dft_equals_jax_pallas_kernel(p, m):
    rng = _rng("qpfb_pallas", p, m)
    frames = torch.from_numpy(
        rng.standard_normal((2, 30, p)).astype(np.float32))
    tq, ts, (qr, sr, qi, si) = _packs(p, m, seed=2)
    got = _two_stage(frames, tq, ts, qr, sr, qi, si)
    zr, zi = _jax_kernel(frames, tq, ts, qr, sr, qi, si)
    _bitwise(got.real.contiguous(), zr)
    _bitwise(got.imag.contiguous(), zi)


@pytest.mark.parametrize("p", PS)
def test_frontend_half_integer_quotients(p):
    m = 8
    frames = torch.from_numpy(half_integer_frames((2, 40, p), m, p))
    tq, ts, (qr, sr, qi, si) = _packs(p, m, seed=None)
    got = _two_stage(frames, tq, ts, qr, sr, qi, si)
    _bitwise(got, pfbk.pfb_fused_int8_plain(frames, tq, ts, qr, qi, sr, si))
    zr, zi = _jax_kernel(frames, tq, ts, qr, sr, qi, si)
    _bitwise(got.real.contiguous(), zr)
    _bitwise(got.imag.contiguous(), zi)


def test_frontend_twin_rows_and_scales():
    """Frame row r = (b, t) of the twin: its scale is scale_of(max |y|)
    over the P branches and its int8 values quantize y with it."""
    p, m = 20, 4
    frames = torch.from_numpy(
        _rng("rows").standard_normal((3, 11, p)).astype(np.float32))
    tq, ts, _ = _packs(p, m, seed=3)
    yq, ys = pfbk.pfb_frontend_int8_plain(frames, tq, ts)
    y = quantize.qpfb_frontend(frames.reshape(3, -1), qtaps=(tq, ts))
    y = y.reshape(-1, p)
    _bitwise(ys, quantize.scale_of(y.abs().amax(dim=-1)))
    _bitwise(yq[:, :p], quantize.quantize_with(y, ys[:, None]))
    assert yq.shape == (3 * 8, 32)


def test_int8_pfb_tiles_and_limits():
    """The DFT stage's two tiles, 128 x 64 the default at every width;
    the shared memory of both kernels within a block's; P_pad a multiple
    of 16 and the K-major operands padded to it."""
    sp = pfbk.TUNE_SPACE_INT8
    assert sp.check({}, {"m": 8, "p": 1024, "t": 4096}) == {"bt": 128,
                                                           "bn": 64}
    assert sp.configs({"m": 8, "p": 1024, "t": 4096}) == (
        {"bt": 128, "bn": 64}, {"bt": 128, "bn": 128})
    assert sp.check({}, {"m": 4, "p": 16, "t": 65536}) == {"bt": 128,
                                                          "bn": 64}
    assert set(pfbk.TILES_INT8) == {(t[0], t[1]) for t in dftk.TILES_INT8}
    for bt, bn in pfbk.TILES_INT8:
        assert pfbk.int8_smem_bytes(bt, bn, 1024) == dftk.int8_smem_bytes(
            bt, bn, 128) <= tune.SMEM_BUDGET
    assert [pfbk.padded_width(p) for p in (1, 16, 20, 48, 1000, 1024)] == \
        [16, 16, 32, 48, 1008, 1024]
    # a frame on as many threads as its groups of four branches, up to 64;
    # more only where the y slots would not fit otherwise
    assert pfbk.frontend_shape(16) == {"tpf": 4, "frames_per_pass": 64,
                                       "frames_per_block": 512,
                                       "smem_bytes": 4128}
    assert pfbk.frontend_shape(1024) == {"tpf": 64, "frames_per_pass": 4,
                                         "frames_per_block": 8,
                                         "smem_bytes": 16416}
    assert pfbk.frontend_shape(14_336)["tpf"] == 64
    assert pfbk.frontend_shape(20_000)["tpf"] == 128
    qr = torch.arange(20 * 7, dtype=torch.int8).reshape(20, 7)
    ft = pfbk._kmajor(None, qr, 32)
    assert ft.shape == (7, 32) and torch.equal(ft[:, :20], qr.t())
    assert not ft[:, 20:].any()
    with pytest.raises(ValueError, match="invalid block config"):
        ops.qpfb(torch.zeros(1024 * 10), torch.zeros(8, 1024, dtype=torch.int8),
                 torch.ones(1, 1024), bn=96)


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("cols", [1, 3, 4, 64])
def test_binary_writes_into_an_offset_out(op, cols):
    """``out=`` takes a view at any offset: the CPU wrapper writes the
    plain result into it and returns it."""
    rng = _rng("binary_out", op, cols)
    x = torch.from_numpy(rng.standard_normal((7, cols)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(cols).astype(np.float32))
    buf = torch.zeros(7 * cols + 1)
    out = buf[1:].view(7, cols)
    fn = ewk.elementwise_mult if op == "mul" else ewk.elementwise_add
    got = fn(x, y, out=out)
    assert got.data_ptr() == out.data_ptr() and buf[0] == 0
    _bitwise(got, ewk.elementwise_binary_plain(x, y, op))
    with pytest.raises(ValueError, match="must be float32"):
        fn(x, y, out=torch.zeros(7, cols + 1))
