"""The port's core layer (blocks, the op mappings the PFB reaches, the
PFB itself) against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go to both packages.  The
JAX ``pallas`` lowering is the port's ``kernel`` lowering (the kernels'
plain torch versions on a CPU tensor); tolerances are the JAX suite's
(``tests/test_system.py``).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks
from repro.core import functions as jfunctions
from repro.core import pfb as jpfb
from repro_torch.core import blocks, functions, pfb

LOWERINGS = [("native", "native"), ("conv", "conv"), ("kernel", "pallas")]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=[l for l, _ in LOWERINGS])
def test_pfb_matches_jax(lw, jlw):
    p, m = 16, 8
    taps = jpfb.pfb_window(p, m).astype(np.float32)
    x = _rng("pfb", lw).standard_normal(1024).astype(np.float32)
    want = np.asarray(jpfb.pfb(jnp.asarray(x), jnp.asarray(taps),
                               lowering=jlw))
    got = pfb.pfb(_t(x), _t(taps), lowering=lw).numpy()
    assert got.shape == want.shape == (1024 // p - m + 1, p)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=[l for l, _ in LOWERINGS])
def test_pfb_frontend_matches_jax(lw, jlw):
    p, m = 16, 8
    taps = jpfb.pfb_window(p, m).astype(np.float32)
    x = _rng("frontend", lw).standard_normal((2, 1024)).astype(np.float32)
    want = np.asarray(jpfb.pfb_frontend(jnp.asarray(x), jnp.asarray(taps),
                                        lowering=jlw))
    got = pfb.pfb_frontend(_t(x), _t(taps), lowering=lw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("lw", ["native", "conv"])
@pytest.mark.parametrize("variant", ["4mult", "3mult"])
def test_pfb_variants_match_jax(lw, variant):
    p, m = 32, 4
    taps = jpfb.pfb_window(p, m).astype(np.float32)
    x = _rng("variant", lw, variant).standard_normal((3, p * 24)) \
        .astype(np.float32)
    want = np.asarray(jpfb.pfb(jnp.asarray(x), jnp.asarray(taps),
                               lowering=lw, variant=variant))
    got = pfb.pfb(_t(x), _t(taps), lowering=lw, variant=variant).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", ["hamming", "hanning", "rect"])
def test_pfb_window_identical(kind):
    np.testing.assert_array_equal(pfb.pfb_window(32, 8, kind),
                                  jpfb.pfb_window(32, 8, kind))
    with pytest.raises(ValueError, match="unknown window"):
        pfb.pfb_window(4, 2, "kaiser")


def test_pfb_rejects_indivisible_signal_and_unknown_lowering():
    taps = torch.ones(4, 16)
    with pytest.raises(ValueError, match="not divisible"):
        pfb.pfb_frontend(torch.ones(100), taps)
    with pytest.raises(ValueError, match="unknown lowering"):
        pfb.pfb(torch.ones(160), taps, lowering="pallas")


# ---------------------------------------------------------------------------
# the op mappings the PFB reaches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lw", ["native", "conv"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("variant", ["4mult", "3mult"])
def test_dft_matches_jax(lw, inverse, variant):
    rng = _rng("dft", lw, inverse, variant)
    x = (rng.standard_normal((4, 32))
         + 1j * rng.standard_normal((4, 32))).astype(np.complex64)
    want = np.asarray(jfunctions.dft(jnp.asarray(x), inverse=inverse,
                                     lowering=lw, variant=variant))
    fn = functions.idft if inverse else functions.dft
    got = fn(_t(x), lowering=lw, variant=variant).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lw", ["native", "conv"])
def test_matmul_and_elementwise_match_jax(lw):
    rng = _rng("mm", lw)
    a = rng.standard_normal((2, 8, 12)).astype(np.float32)
    b = rng.standard_normal((12, 5)).astype(np.float32)
    c = rng.standard_normal((2, 8, 12)).astype(np.float32)
    np.testing.assert_allclose(
        functions.matmul(_t(a), _t(b), lowering=lw).numpy(),
        np.asarray(jfunctions.matmul(jnp.asarray(a), jnp.asarray(b),
                                     lowering=lw)), rtol=1e-5, atol=1e-5)
    for name in ("elementwise_mult", "elementwise_add"):
        for y in (c, c[0]):           # batched and shared second operand
            np.testing.assert_allclose(
                getattr(functions, name)(_t(a), _t(y), lowering=lw).numpy(),
                np.asarray(getattr(jfunctions, name)(
                    jnp.asarray(a), jnp.asarray(y), lowering=lw)),
                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lw", ["native", "conv"])
@pytest.mark.parametrize("k", [1, 5])
def test_depthwise_fir_matches_jax(lw, k):
    rng = _rng("dwfir", lw, k)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    taps = rng.standard_normal((k, 6)).astype(np.float32)
    np.testing.assert_allclose(
        functions.depthwise_fir(_t(x), _t(taps), lowering=lw).numpy(),
        np.asarray(jfunctions.depthwise_fir(jnp.asarray(x), jnp.asarray(taps),
                                            lowering=lw)),
        rtol=1e-5, atol=1e-5)


def test_single_op_kernel_lowering_not_yet_ported():
    """No single op's kernel lowering is left unported: matmul's (the
    reference's Pallas GEMM) was the last; the DFT and elementwise ops
    have theirs.  An unknown lowering still raises."""
    x = torch.ones(4, 4)
    torch.testing.assert_close(functions.matmul(x, x, lowering="kernel"),
                               functions.matmul(x, x, lowering="native"))
    with pytest.raises(ValueError, match="unknown lowering"):
        functions.matmul(x, x, lowering="pallas")
    torch.testing.assert_close(
        functions.elementwise_mult(x, x, lowering="kernel"), x)
    torch.testing.assert_close(
        functions.dft(x, lowering="kernel"),
        functions.dft(x, lowering="native"), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the five NN blocks
# ---------------------------------------------------------------------------
CONV_CASES = [
    dict(stride=(1, 1), padding="VALID", groups=1),
    dict(stride=(2, 1), padding="VALID", groups=1),
    dict(stride=(1, 1), padding="SAME", groups=1),
    dict(stride=(1, 1), padding=((1, 2), (0, 1)), groups=1),
    dict(stride=(1, 1), padding="VALID", groups=2),
]


@pytest.mark.parametrize("lw", ["conv", "native"])
@pytest.mark.parametrize("case", CONV_CASES, ids=range(len(CONV_CASES)))
def test_standard_conv_matches_jax(lw, case):
    rng = _rng("std", lw, repr(case))
    x = rng.standard_normal((2, 4, 9, 11)).astype(np.float32)
    k = rng.standard_normal((6, 4 // case["groups"], 3, 4)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jblocks.standard_conv(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), lowering=lw, **case))
    got = blocks.standard_conv(_t(x), _t(k), _t(bias), lowering=lw,
                               **case).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lw", ["conv", "native"])
@pytest.mark.parametrize("shape,padding", [((1, 1), "VALID"),
                                           ((3, 2), "VALID"),
                                           ((3, 3), "SAME")])
def test_depthwise_conv_matches_jax(lw, shape, padding):
    rng = _rng("dw", lw, shape, padding)
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    k = rng.standard_normal((5,) + shape).astype(np.float32)
    want = np.asarray(jblocks.depthwise_conv(jnp.asarray(x), jnp.asarray(k),
                                             padding=padding, lowering=lw))
    got = blocks.depthwise_conv(_t(x), _t(k), padding=padding,
                                lowering=lw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lw", ["conv", "native"])
def test_pointwise_transposed_fc_match_jax(lw):
    rng = _rng("pw", lw)
    x = rng.standard_normal((2, 6, 3, 5)).astype(np.float32)
    k = rng.standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        blocks.pointwise_conv(_t(x), _t(k), lowering=lw).numpy(),
        np.asarray(jblocks.pointwise_conv(jnp.asarray(x), jnp.asarray(k),
                                          lowering=lw)), rtol=1e-5, atol=1e-5)
    xt = rng.standard_normal((2, 7, 3)).astype(np.float32)
    kt = rng.standard_normal((4, 3, 2)).astype(np.float32)
    for stride in (1, 2, 4):
        np.testing.assert_allclose(
            blocks.transposed_conv(_t(xt), _t(kt), stride=stride,
                                   lowering=lw).numpy(),
            np.asarray(jblocks.transposed_conv(jnp.asarray(xt),
                                               jnp.asarray(kt), stride=stride,
                                               lowering=lw)),
            rtol=1e-5, atol=1e-5)
    xf = rng.standard_normal((3, 4, 6)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    np.testing.assert_allclose(
        blocks.fully_connected(_t(xf), _t(k), _t(bias), lowering=lw).numpy(),
        np.asarray(jblocks.fully_connected(jnp.asarray(xf), jnp.asarray(k),
                                           jnp.asarray(bias), lowering=lw)),
        rtol=1e-5, atol=1e-5)


def test_convs_keep_tf32_setting():
    """The blocks turn cuDNN's TF32 off around each conv and put the
    caller's setting back."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with blocks.fp32_convs():
            assert torch.backends.cudnn.allow_tf32 is False
        blocks.pointwise_conv(torch.ones(1, 2, 1, 1), torch.ones(2, 2))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
