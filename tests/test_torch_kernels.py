"""The port's kernel wrappers against the JAX package's Pallas kernels.

Inputs come from numpy with a fixed seed and go to both packages.  The
JAX functions reach their Pallas kernels in interpret mode off-TPU, as
the JAX suite runs them; the port's wrappers run their kernels' plain
torch versions for CPU tensors.  Tolerances are the JAX suite's own
(``tests/test_kernels.py``).  The CUDA kernels themselves run only on a
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pfb as jpfb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import elementwise as ewk
from repro_torch.kernels import ops, ref, tune
from repro_torch.kernels import pfb as pfbk


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("p,m,nframes", [(32, 8, 64), (64, 4, 300)])
def test_pfb_matches_jax(p, m, nframes):
    rng = _rng("pfb", p, m, nframes)
    x = rng.standard_normal((2, p * nframes)).astype(np.float32)
    taps = jpfb.pfb_window(p, m).astype(np.float32)
    want = np.asarray(jops.pfb(jnp.asarray(x), jnp.asarray(taps)))
    got = ops.pfb(_t(x), _t(taps)).numpy()
    assert got.shape == want.shape == (2, nframes - m + 1, p)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got.real, want.real, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.imag, want.imag, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("b,t,p,m", [(2, 256, 64, 8), (1, 300, 16, 12),
                                     (2, 128, 128, 4)])
def test_pfb_fir_matches_jax(b, t, p, m):
    rng = _rng("pfb_fir", b, t, p, m)
    frames = rng.standard_normal((b, t, p)).astype(np.float32)
    taps = rng.standard_normal((m, p)).astype(np.float32)
    want = np.asarray(jops.pfb_fir(jnp.asarray(frames), jnp.asarray(taps)))
    got = ops.pfb_fir(_t(frames), _t(taps)).numpy()
    assert got.shape == want.shape == (b, t - m + 1, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


CHAINS = [
    ((("abs2",),), True, 0),
    ((("abs2",), ("scale", 0.25)), True, 0),
    ((("mul",), ("add",), ("scale", 1.7)), False, 2),
]


@pytest.mark.parametrize("steps,cplx,n_ops", CHAINS,
                         ids=["abs2", "abs2+scale", "mul+add+scale"])
def test_fused_elementwise_matches_jax(steps, cplx, n_ops):
    rng = _rng("chain", len(steps), cplx)
    shape = (3, 40, 24)
    if cplx:
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    operands = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(n_ops)]
    want = np.asarray(jops.fused_elementwise(
        jnp.asarray(x), tuple(jnp.asarray(o) for o in operands), steps))
    got = ops.fused_elementwise(_t(x), tuple(_t(o) for o in operands),
                                steps).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fused_elementwise_broadcasts_operands_like_jax():
    rng = _rng("bcast")
    x = rng.standard_normal((4, 16)).astype(np.float32)
    row = rng.standard_normal((16,)).astype(np.float32)
    steps = (("mul",), ("scale", 0.5))
    want = np.asarray(jops.fused_elementwise(jnp.asarray(x),
                                             (jnp.asarray(row),), steps))
    got = ops.fused_elementwise(_t(x), (_t(row),), steps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_abs2_matches_jax():
    rng = _rng("abs2")
    z = (rng.standard_normal((5, 33))
         + 1j * rng.standard_normal((5, 33))).astype(np.complex64)
    want = np.asarray(jops.abs2(jnp.asarray(z)))
    np.testing.assert_allclose(ops.abs2(_t(z)).numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_ref_pfb_twins_match_jax():
    rng = _rng("ref_pfb")
    p, m = 16, 4
    x = rng.standard_normal((2, p * 40)).astype(np.float32)
    taps = rng.standard_normal((m, p)).astype(np.float32)
    frames = x.reshape(2, -1, p)
    np.testing.assert_allclose(
        ref.ref_pfb_fir(_t(frames), _t(taps)).numpy(),
        np.asarray(jref.ref_pfb_fir(jnp.asarray(frames), jnp.asarray(taps))),
        rtol=1e-5, atol=1e-5)
    got_r, got_i = ref.ref_pfb(_t(x), _t(taps))
    want_r, want_i = jref.ref_pfb(jnp.asarray(x), jnp.asarray(taps))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["mult", "add"])
def test_ref_elementwise_twins_match_jax(name):
    rng = _rng("ref_ew", name)
    x, y = (rng.standard_normal((6, 9)).astype(np.float32) for _ in range(2))
    tfn = getattr(ref, f"ref_elementwise_{name}")
    jfn = getattr(jref, f"ref_elementwise_{name}")
    np.testing.assert_array_equal(
        tfn(_t(x), _t(y)).numpy(),
        np.asarray(jfn(jnp.asarray(x), jnp.asarray(y))))


def test_plain_versions_match_ref():
    """The kernels' plain versions against the torch oracles."""
    rng = _rng("plain")
    p, m = 16, 6
    x = _t(rng.standard_normal((3, p * 50)).astype(np.float32))
    taps = _t(rng.standard_normal((m, p)).astype(np.float32))
    z = ops.pfb(x, taps)
    want_r, want_i = ref.ref_pfb(x, taps)
    torch.testing.assert_close(z.real, want_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(z.imag, want_i, rtol=1e-4, atol=1e-4)
    power = ewk.elementwise_chain_plain(z, (), (), abs2_head=True)
    torch.testing.assert_close(power, z.abs() ** 2, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version: the launch counts stay put."""
    before = (pfbk.LAUNCHES, ewk.LAUNCHES)
    x = torch.randn(2, 16 * 20)
    taps = torch.randn(4, 16)
    ops.abs2(ops.pfb(x, taps))
    ops.pfb_fir(x.reshape(2, 20, 16), taps)
    assert (pfbk.LAUNCHES, ewk.LAUNCHES) == before


def test_non_cuda_device_raises():
    frames = torch.empty(1, 8, 4, device="meta")
    taps = torch.empty(2, 4, device="meta")
    eye = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        pfbk.pfb_fused(frames, taps, eye, eye)
    with pytest.raises(ValueError, match="no kernel for device"):
        ewk.elementwise_chain(torch.empty(3, device="meta"), (),
                              (("scale", 2.0),))


@pytest.mark.parametrize("kwargs", [{"bt": 48}, {"bn": 128},
                                    {"bt": 16, "bn": 64}])
def test_invalid_pfb_block_config_raises(kwargs):
    x = torch.randn(16 * 32)
    taps = torch.randn(4, 16)
    with pytest.raises(ValueError, match="invalid block config"):
        ops.pfb(x, taps, **kwargs)
    with pytest.raises(ValueError, match="invalid block config"):
        ops.pfb_fir(x.reshape(32, 16), taps, **kwargs)


def test_invalid_chain_config_and_steps_raise():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="invalid block config"):
        ops.fused_elementwise(x, (), (("scale", 2.0),), threads=100)
    with pytest.raises(ValueError, match="unknown chain step"):
        ops.fused_elementwise(x, (), (("exp",),))
    with pytest.raises(ValueError, match="complex input"):
        ops.fused_elementwise(x.to(torch.complex64), (), (("scale", 2.0),))


def test_pfb_rejects_indivisible_signal():
    with pytest.raises(ValueError, match="not divisible by P=16"):
        ops.pfb(torch.randn(100), torch.randn(4, 16))


def test_tune_spaces_describe_the_cuda_kernels():
    sp = tune.space("pfb")
    assert sp is pfbk.TUNE_SPACE and sp.params == ("bt", "bn")
    ctx = {"m": 8, "p": 1024, "t": 4096}
    assert {(c["bt"], c["bn"]) for c in sp.configs(ctx)} == set(pfbk.TILES)
    # the TPU kernel's halo rule M - 1 <= bt is gone: 100 taps fit a
    # 32-frame tile because the kernel loads its own halo rows
    assert sp.valid({"bt": 32, "bn": 32}, {"m": 100, "p": 16, "t": 200})
    # only shared memory bounds the taps now
    huge = (tune.SMEM_BUDGET // (4 * pfbk.BK)) + 1
    assert not sp.valid({"bt": 32, "bn": 32}, {"m": huge, "p": 16, "t": 200})
    with pytest.raises(ValueError, match="unknown block param"):
        sp.check({"order": "tc"}, ctx)
    assert tune.space("elementwise").check({}, {"rows": 1, "cols": 1,
                                                "n_in": 1}) == {"threads": 256}
