"""The recurrent blocks (RG-LRU, RWKV6) and the modality frontends on the
port against the JAX package.

The reference's ``init_*`` trees are carried across as numpy arrays and
the inputs made by numpy from a seed; each block runs a prefill into a
state and then decode steps that continue it, and the outputs and the
states are held to JAX's within 1e-4 of max at f32.  The port writes a
state in place, so the state tensors after each call are the ones
:func:`init_rglru_state` / :func:`init_rwkv_state` made.  The ``kernel``
lowering (JAX's ``pallas``) runs the models' depthwise FIR at
``native``, as the reference does.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro_torch import configs as tconfigs
from repro_torch.core import functions as tfunctions
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv

JAX_LOWERING = {"native": "native", "conv": "conv", "kernel": "pallas"}
F32_RTOL = 1e-4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _cfgs(arch, lowering="native", **over):
    jcfg = jconfigs.get_reduced(arch).scaled(
        tina_lowering=JAX_LOWERING[lowering], **over)
    tcfg = tconfigs.get_reduced(arch).scaled(tina_lowering=lowering, **over)
    return jcfg, tcfg


def _carry(tree):
    """A reference init tree as JAX arrays and as the port's tensors."""
    tree = jax.tree.map(np.array, tree)
    return jax.tree.map(jnp.asarray, tree), convert._tree(
        tree, torch.device("cpu"))


@pytest.fixture
def fir_lowerings(monkeypatch):
    """The lowerings the port's depthwise FIR is called with."""
    seen = []
    real = tfunctions.depthwise_fir

    def recording(x, taps, *, causal=True, lowering="native"):
        seen.append(lowering)
        return real(x, taps, causal=causal, lowering=lowering)

    monkeypatch.setattr(tfunctions, "depthwise_fir", recording)
    return seen


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 33])
def test_linear_scan_is_the_recurrence(s):
    """The Hillis–Steele scan against the sequential recurrence in
    float64, for lengths at, off and between powers of two."""
    rng = _rng("scan", s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, s, 5)))
    b = torch.from_numpy(rng.standard_normal((3, s, 5)))
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(trglru.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("lowering", ["native", "conv", "kernel"])
def test_rglru_prefill_and_decode_match_jax(lowering, fir_lowerings):
    """A prefill of 9 steps into the state, then 3 decode steps; the
    outputs and the state (h in f32, the conv window) against JAX's.
    The depthwise FIR runs at the config's lowering, ``kernel`` at
    ``native``."""
    jcfg, tcfg = _cfgs("recurrentgemma_9b", lowering)
    jp, tp = _carry(jrglru.init_rglru_block(jax.random.PRNGKey(4), jcfg))
    rng = _rng("rglru", lowering)
    b, s = 2, 9
    x = rng.standard_normal((b, s + 3, jcfg.d_model)).astype(np.float32)
    js = jrglru.init_rglru_state(jcfg, b)
    ts = trglru.init_rglru_state(tcfg, b, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    want, js = jrglru.rglru_block(jp, jnp.asarray(x[:, :s]), jcfg, state=js)
    got, ts2 = trglru.rglru_block(tp, torch.from_numpy(x[:, :s]), tcfg,
                                  state=ts)
    assert ts2 is ts
    _close(got, want, F32_RTOL, "prefill")
    for i in range(s, s + 3):
        want, js = jrglru.rglru_block(jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                                      state=js)
        got, _ = trglru.rglru_block(tp, torch.from_numpy(x[:, i:i + 1]),
                                    tcfg, state=ts)
        _close(got, want, F32_RTOL, f"decode {i}")
        _close(ts["h"], js["h"], F32_RTOL, f"h {i}")
        _close(ts["conv"], js["conv"], F32_RTOL, f"conv {i}")
    assert {k: v.data_ptr() for k, v in ts.items()} == ptrs
    assert ts["h"].dtype == torch.float32
    assert fir_lowerings == [trglru.fir_lowering(tcfg)]
    assert fir_lowerings == ["conv" if lowering == "conv" else "native"]


def test_rglru_without_state_matches_jax():
    """Training-style forward: no state in, none out."""
    jcfg, tcfg = _cfgs("recurrentgemma_9b")
    jp, tp = _carry(jrglru.init_rglru_block(jax.random.PRNGKey(6), jcfg))
    x = _rng("rglru-nostate").standard_normal(
        (3, 20, jcfg.d_model)).astype(np.float32)
    want, js = jrglru.rglru_block(jp, jnp.asarray(x), jcfg)
    got, ts = trglru.rglru_block(tp, torch.from_numpy(x), tcfg)
    assert js is None and ts is None
    _close(got, want, F32_RTOL, "forward")


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lowering", ["native", "conv", "kernel"])
def test_time_and_channel_mix_match_jax(lowering):
    """time_mix then channel_mix on one state, as a block runs them: a
    prefill of 7 steps, then 3 decode steps; outputs, the WKV state and
    both shifted inputs against JAX's."""
    jcfg, tcfg = _cfgs("rwkv6_3b", lowering)
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    jtm, ttm = _carry(jrwkv.init_time_mix(k1, jcfg))
    jcm, tcm = _carry(jrwkv.init_channel_mix(k2, jcfg))
    rng = _rng("rwkv", lowering)
    b, s = 2, 7
    x = rng.standard_normal((b, s + 3, jcfg.d_model)).astype(np.float32)
    js = jrwkv.init_rwkv_state(jcfg, b)
    ts = trwkv.init_rwkv_state(tcfg, b, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    for lo, hi in [(0, s)] + [(i, i + 1) for i in range(s, s + 3)]:
        xi = x[:, lo:hi]
        want, js = jrwkv.time_mix(jtm, jnp.asarray(xi), jcfg, state=js)
        got, ts2 = trwkv.time_mix(ttm, torch.from_numpy(xi), tcfg, state=ts)
        assert ts2 is ts
        _close(got, want, F32_RTOL, f"time mix {lo}")
        want, js = jrwkv.channel_mix(jcm, jnp.asarray(xi), jcfg, state=js)
        got, _ = trwkv.channel_mix(tcm, torch.from_numpy(xi), tcfg, state=ts)
        _close(got, want, F32_RTOL, f"channel mix {lo}")
        for k in ("S", "x_tm", "x_cm"):
            _close(ts[k], js[k], F32_RTOL, f"{k} {lo}")
    assert {k: v.data_ptr() for k, v in ts.items()} == ptrs


def test_wkv_scan_matches_jax_step_for_step():
    """The WKV loop alone on random r/k/v/w and a nonzero state."""
    rng = _rng("wkv")
    b, s, h, hs = 2, 6, 3, 8
    r, k, v = (rng.standard_normal((b, s, h, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, (b, s, h, hs)).astype(np.float32)
    u = rng.standard_normal((h, hs)).astype(np.float32)
    s0 = rng.standard_normal((b, h, hs, hs)).astype(np.float32)
    want, wstate = jrwkv._wkv_scan(*(jnp.asarray(a) for a in
                                     (r, k, v, w, u, s0)))
    got, gstate = trwkv._wkv_scan(*(torch.from_numpy(a) for a in
                                    (r, k, v, w, u, s0)))
    _close(got, want, 1e-5, "out")
    _close(gstate, wstate, 1e-5, "state")


def test_group_norm_uses_the_population_variance():
    """ln_x divides by hs, not hs - 1 (jnp.var's default, not torch's)."""
    jcfg, tcfg = _cfgs("rwkv6_3b")
    jtm, ttm = _carry(jrwkv.init_time_mix(jax.random.PRNGKey(2), jcfg))
    x = _rng("ln_x").standard_normal((1, 4, jcfg.d_model)).astype(np.float32)
    want, _ = jrwkv.time_mix(jtm, jnp.asarray(x), jcfg)
    got, _ = trwkv.time_mix(ttm, torch.from_numpy(x), tcfg)
    _close(got, want, F32_RTOL, "time mix without state")


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------
FRONTENDS = {"vision_stub": ("internvl2_2b", jmodel.VISION_FEAT_DIM),
             "audio_stub": ("hubert_xlarge", jmodel.AUDIO_FEAT_DIM)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lowering", ["native", "kernel"])
@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
def test_frontend_matches_jax(frontend, lowering, dtype, fir_lowerings):
    """The projection (the TINA matmul at the lowering) and, for audio,
    the width-128 causal depthwise-FIR positional embedding through a
    tanh GELU (its FIR at ``native`` for ``kernel``)."""
    arch, feat = FRONTENDS[frontend]
    jcfg, tcfg = _cfgs(arch, lowering, compute_dtype=dtype)
    jp, tp = _carry(jmodel.init_frontend(jax.random.PRNGKey(9), jcfg))
    tp = {**tp, "proj": tlayers.prepare_linear(tp["proj"], tcfg)}
    x = _rng("frontend", frontend).standard_normal(
        (2, 150, feat)).astype(np.float32)
    want = jmodel.apply_frontend(jp, jnp.asarray(x), jcfg)
    got = tmodel.apply_frontend(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == tlayers.cdtype(tcfg)
    _close(got, want, F32_RTOL if dtype == "float32" else 2e-2, frontend)
    assert fir_lowerings == (["native"] if frontend == "audio_stub" else [])


def test_frontend_shapes_are_the_reference_constants():
    assert (tmodel.VISION_FEAT_DIM, tmodel.AUDIO_FEAT_DIM,
            tmodel.AUDIO_CONV_POS_WIDTH) == (
        jmodel.VISION_FEAT_DIM, jmodel.AUDIO_FEAT_DIM,
        jmodel.AUDIO_CONV_POS_WIDTH)
