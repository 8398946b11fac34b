"""The f32 PFB's two stages, on the CPU: the frontend (the FIR bank) and
the DFT stage of ``kernels/pfb.py:pfb_fused``.

The port's ``ops.pfb`` and ``ops.pfb_fir`` take their kernels' plain
twins for CPU tensors; they are held against the JAX package's Pallas
kernels (interpret mode, as the JAX suite runs them) and the torch
``ref_*`` oracles, with the JAX suite's tolerances
(``tests/test_kernels.py``: 1e-4 for the frontend, 1e-3 for the PFB).
The frontend's twin is held bit for bit against the identity-DFT route it
replaced, the y rows' stride rule is checked at P = 37, and the DFT
stage's 3xTF32 arithmetic is emulated with f32 sums against float64 at
P = 1024.  The folded route's two stages (pairs of mirrored branches,
then the product over P/2 of them) are held to the frontend's y bit for
bit and to ``pfb_fused_plain``, its 3xTF32 arithmetic emulated at
P = 1024 and 2048, and its route rule checked.  The CUDA kernels
themselves run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dft as dftk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pfb as pfbk

SHAPES = [(p, m) for p in (16, 37, 64) for m in (4, 8)]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(p, m, nframes=40, b=2):
    rng = _rng("pfb_f32", p, m, nframes)
    x = rng.standard_normal((b, p * nframes)).astype(np.float32)
    taps = rng.standard_normal((m, p)).astype(np.float32)
    return x, taps


@pytest.mark.parametrize("p,m", SHAPES)
def test_pfb_matches_jax_and_ref(p, m):
    x, taps = _inputs(p, m)
    got = ops.pfb(_t(x), _t(taps)).numpy()
    want = np.asarray(jops.pfb(jnp.asarray(x), jnp.asarray(taps)))
    wr, wi = ref.ref_pfb(_t(x), _t(taps))
    assert got.shape == want.shape == (2, 40 - m + 1, p)
    assert got.dtype == np.complex64
    for w in (want, wr.numpy() + 1j * wi.numpy()):
        np.testing.assert_allclose(got.real, w.real, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got.imag, w.imag, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("p,m", SHAPES)
def test_pfb_fir_matches_jax_and_ref(p, m):
    x, taps = _inputs(p, m)
    frames = x.reshape(2, -1, p)
    got = ops.pfb_fir(_t(frames), _t(taps)).numpy()
    want = np.asarray(jops.pfb_fir(jnp.asarray(frames), jnp.asarray(taps)))
    assert got.shape == want.shape == (2, 40 - m + 1, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, ref.ref_pfb_fir(_t(frames), _t(taps)).numpy(), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jref.ref_pfb_fir(jnp.asarray(frames),
                                         jnp.asarray(taps))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p,m", SHAPES)
def test_frontend_twin_is_the_fused_plain_y_bit_for_bit(p, m):
    """The frontend's twin is pfb_fused_plain's y: bit for bit the
    identity-DFT route it replaced (y @ I + i y @ 0), and the ascending-m
    sum of separately rounded float32 products and sums."""
    x, taps = _inputs(p, m)
    frames = _t(x.reshape(2, -1, p))
    taps_rev = _t(taps).flip(0).contiguous()
    y = pfbk.pfb_frontend_plain(frames, taps_rev)
    eye, zero = torch.eye(p), torch.zeros(p, p)
    z = pfbk.pfb_fused_plain(frames, taps_rev, eye, zero)
    assert torch.equal(z.real, y) and not z.imag.any()
    f = x.reshape(2, -1, p)
    tr = taps[::-1]
    tout = f.shape[1] - m + 1
    acc = tr[0] * f[:, :tout]
    for k in range(1, m):
        acc = (acc + tr[k] * f[:, k:k + tout]).astype(np.float32)
    np.testing.assert_array_equal(y.numpy(), acc)
    assert torch.equal(pfbk.pfb_frontend(frames, taps_rev), y)


@pytest.mark.parametrize("p,stride", [(1, 4), (16, 16), (37, 40), (64, 64),
                                      (1023, 1024)])
def test_y_stride_pads_to_four_floats(p, stride):
    assert pfbk.y_stride(p) == stride


def test_frontend_rows_pad_p37_to_40_with_zero_columns():
    x, taps = _inputs(37, 5)
    frames = _t(x.reshape(2, -1, 37))
    taps_rev = _t(taps).flip(0).contiguous()
    rows = pfbk.pfb_frontend_rows_plain(frames, taps_rev)
    y = pfbk.pfb_frontend_plain(frames, taps_rev)
    assert rows.shape == (2 * (40 - 5 + 1), 40) and rows.is_contiguous()
    assert torch.equal(rows[:, :37], y.reshape(-1, 37))
    assert not rows[:, 37:].any()
    out = torch.full_like(rows, float("nan"))
    assert pfbk.pfb_frontend(frames, taps_rev, out=out) is out
    assert torch.equal(out, rows)


def _tf32_dft(y, planes, p, passes):
    """y (rows, P) against the DFT stage's F planes (dft.tf32_planes at
    4mult: Fr hi, Fr lo, Fi hi, Fi lo, K-major) as the kernel multiplies
    them: passes 3 is yhi Fhi + yhi Flo + ylo Fhi (each product of two
    TF32 values exact in f32), 1 a single TF32 pass; each 32-deep chunk
    summed apart and added into the result in f32, as dft.cu promotes."""
    yh, yl = dftk.tf32_split(y)
    out = []
    for q in (0, 1):
        fh, fl = planes[2 * q, :p, :p].t(), planes[2 * q + 1, :p, :p].t()
        acc = torch.zeros((y.shape[0], p), dtype=torch.float32)
        for k0 in range(0, p, dftk.BK):
            c = slice(k0, k0 + dftk.BK)
            part = yh[:, c] @ fh[c]
            if passes == 3:
                part = yl[:, c] @ fh[c] + yh[:, c] @ fl[c] + part
            acc = acc + part
        out.append(acc)
    return torch.complex(*out)


def test_3xtf32_dft_stage_emulation_within_float64_at_1024():
    """At P = 1024 the DFT stage's 3xTF32 products with per-chunk
    promotion (emulated with f32 sums) on the frontend's y stay within
    1e-5 of max of a float64 product, as chip_smoke.py requires on the
    card; a single TF32 pass does not."""
    p, m = 1024, 8
    x, taps = _inputs(p, m, nframes=40, b=1)
    frames = _t(x.reshape(1, -1, p))
    y = pfbk.pfb_frontend_plain(frames, _t(taps).flip(0).contiguous())
    y = y.reshape(-1, p)
    fr, fi = ops._fourier(p, "cpu")
    planes = dftk.tf32_planes(fr, fi, "4mult")
    assert planes.shape == (4, p, p)
    want = torch.complex(y.double() @ fr.double(), y.double() @ fi.double())
    scale = float(torch.view_as_real(want).abs().max())
    errs = {n: float((torch.view_as_real(_tf32_dft(y, planes, p, n))
                      .double() - torch.view_as_real(want)).abs().max())
            / scale for n in (3, 1)}
    assert errs[3] <= 1e-5
    assert errs[1] > 1e-4 > 10 * errs[3]


def test_fourier_planes_are_made_once_from_the_plain_matrices():
    """The DFT stage's planes come from the same ops._fourier tensors
    the plain version multiplies, once per (P, device)."""
    ops._fourier_planes.cache_clear()
    planes = ops._fourier_planes(16, "cpu")
    assert ops._fourier_planes(16, "cpu") is planes
    fr, fi = ops._fourier(16, "cpu")
    assert torch.equal(planes, dftk.tf32_planes(fr, fi, "4mult"))


@pytest.mark.parametrize("p", [64, 1024, 2048])
@pytest.mark.parametrize("m", [4, 16])
def test_folded_rows_twin_is_s_and_d_of_y_bit_for_bit(p, m):
    """The folded route's rows: pairs (y_n + y_{P-n}, y_n - y_{P-n}) of
    n = 1 .. P/2 - 1 of the frontend's y, each one f32 add or subtract,
    pair 0 (y_0, y_{P/2}), interleaved and zero past pair P/2 - 1."""
    x, taps = _inputs(p, m, nframes=24, b=2)
    frames = _t(x.reshape(2, -1, p))
    taps_rev = _t(taps).flip(0).contiguous()
    rows = pfbk.pfb_folded_rows_plain(frames, taps_rev)
    y = pfbk.pfb_frontend_plain(frames, taps_rev).reshape(-1, p).numpy()
    h = p // 2
    assert rows.shape == (2 * (24 - m + 1), pfbk.y_stride(p))
    s, d = rows[:, 0:2 * h:2].numpy(), rows[:, 1:2 * h:2].numpy()
    np.testing.assert_array_equal(s[:, 0], y[:, 0])
    np.testing.assert_array_equal(d[:, 0], y[:, h])
    for n in (1, 2, 3, h // 2, h - 1):
        np.testing.assert_array_equal(s[:, n], y[:, n] + y[:, p - n])
        np.testing.assert_array_equal(d[:, n], y[:, n] - y[:, p - n])
    np.testing.assert_array_equal(s[:, 1:], y[:, 1:h] + y[:, :h:-1])
    np.testing.assert_array_equal(d[:, 1:], y[:, 1:h] - y[:, :h:-1])
    assert not rows[:, 2 * h:].any()


@pytest.mark.parametrize("p", [38, 64, 1024, 2048])
def test_folded_dft_stage_matches_fused_plain(p):
    """The folded stage's product over P/2 pairs against the DFM's
    planes is y (fr + i fi): pfb_fused_plain within f32 rounding."""
    x, taps = _inputs(p, 4, nframes=24, b=2)
    frames = _t(x.reshape(2, -1, p))
    taps_rev = _t(taps).flip(0).contiguous()
    fr, fi = ops._fourier(p, "cpu")
    got = pfbk.pfb_folded_dft_plain(
        pfbk.pfb_folded_rows_plain(frames, taps_rev), fr, fi)
    want = torch.view_as_real(
        pfbk.pfb_fused_plain(frames, taps_rev, fr, fi).reshape(-1, p))
    assert got.shape == (2 * 21, p) and got.dtype == torch.complex64
    assert (torch.view_as_real(got) - want).abs().max() \
        <= 2e-6 * want.abs().max()


def _tf32_folded_dft(rows, planes, p, passes):
    """The folded DFT stage as the kernel multiplies: s against the Fr
    planes and d against the Fi planes over K = P/2 (the planes' first
    P/2 K-rows), passes 3 or 1 as in :func:`_tf32_dft`, each 32-deep
    chunk promoted in f32, then (-1)^k y_{P/2} added to Zr in f32."""
    h = p // 2
    s, d = rows[:, 0:2 * h:2], rows[:, 1:2 * h:2]
    out = []
    for q, a in ((0, s), (1, d)):
        ah, al = dftk.tf32_split(a.contiguous())
        fh, fl = planes[2 * q, :p, :h].t(), planes[2 * q + 1, :p, :h].t()
        acc = torch.zeros((rows.shape[0], p), dtype=torch.float32)
        for k0 in range(0, h, dftk.BK):
            c = slice(k0, k0 + dftk.BK)
            part = ah[:, c] @ fh[c]
            if passes == 3:
                part = al[:, c] @ fh[c] + ah[:, c] @ fl[c] + part
            acc = acc + part
        out.append(acc)
    sign = 1.0 - 2.0 * (torch.arange(p) % 2)
    return torch.complex(out[0] + d[:, :1] * sign, out[1])


@pytest.mark.parametrize("p", [1024, 2048])
def test_3xtf32_folded_dft_stage_emulation_within_float64(p):
    """The folded stage's 3xTF32 products with per-chunk promotion
    (emulated with f32 sums) stay within 1e-5 of max of a float64
    product of the frontend's y, as the unfolded stage does at 1024; a
    single TF32 pass does not."""
    m = 8
    x, taps = _inputs(p, m, nframes=40, b=1)
    frames = _t(x.reshape(1, -1, p))
    taps_rev = _t(taps).flip(0).contiguous()
    y = pfbk.pfb_frontend_plain(frames, taps_rev).reshape(-1, p)
    rows = pfbk.pfb_folded_rows_plain(frames, taps_rev)
    fr, fi = ops._fourier(p, "cpu")
    planes = dftk.tf32_planes(fr, fi, "4mult")
    want = torch.complex(y.double() @ fr.double(), y.double() @ fi.double())
    scale = float(torch.view_as_real(want).abs().max())
    errs = {n: float((torch.view_as_real(_tf32_folded_dft(rows, planes, p, n))
                      .double() - torch.view_as_real(want)).abs().max())
            / scale for n in (3, 1)}
    assert errs[3] <= 1e-5
    assert errs[1] > 1e-4 > 10 * errs[3]


@pytest.mark.parametrize("p,hermitian,bn,folded", [
    (1024, True, 64, True), (2048, True, 64, True), (64, True, 64, True),
    (34, True, 64, True), (16, True, 16, False), (16, True, 64, False),
    (32, True, 64, False), (1023, True, 64, False), (37, True, 64, False),
    (1024, False, 64, False), (2048, False, 64, False),
    (1024, True, 16, False)])
def test_fold_route_rule(p, hermitian, bn, folded):
    """The folded route where the DFM's symmetry holds, P is even, the
    tile is 64 wide and K = P/2 takes fewer 32-deep chunks than K = P."""
    assert pfbk.folds(p, hermitian, bn) is folded
