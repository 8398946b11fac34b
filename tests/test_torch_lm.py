"""The model zoo's dense decoders on the port against the JAX package.

The same seeded numpy inputs, and the JAX ``init_model`` weights carried
across by ``repro_torch.models.convert.from_jax``, go through the JAX
function and its port: each layer, then the whole model (forward, and
prefill + decode), at f32 compute within 1e-4 of max (``native`` against
``native``, the port's ``kernel`` against JAX's ``pallas``, whose GEMM
runs in interpret mode as the JAX suite runs it).  The port's kernel
lowering runs its kernels' plain versions on these CPU tensors.  The
bf16 comparisons, the serving steps and the launcher are in
``tests/test_torch_lm_serve.py``.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

DENSE = ["olmo_1b", "qwen2_7b", "stablelm_3b", "stablelm_1_6b"]
JAX_LOWERING = {"native": "native", "kernel": "pallas"}
F32_RTOL = 1e-4     # of max: f32 sums in other orders, through every layer


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _weights(jcfg, tcfg, seed=0):
    params = jmodel.init_model(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return params, tmodel.prepare(
        convert.from_jax(tree, tcfg, device="cpu"), tcfg)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_are_the_reference_data(arch):
    """Every config, full and reduced, field for field."""
    for get in ("get", "get_reduced"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), (arch, get)
        assert (t.rotary_dim, t.layer_kinds) == (j.rotary_dim, j.layer_kinds)
    for alias, name in jconfigs._ALIASES.items():
        assert tconfigs.get(alias) == tconfigs.get(name)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm",
                                       "nonparam_ln"])
def test_norm_matches_jax(norm_type):
    jcfg, tcfg = _cfgs("olmo_1b", norm_type=norm_type)
    rng = _rng("norm", norm_type)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32) * 3
    p = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in jax.tree.map(np.asarray,
                                  jlayers.init_norm(jcfg)).items()}
    want = jlayers.norm(p, jnp.asarray(x), jcfg)
    got = tlayers.norm({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(got, want, 1e-5, norm_type)


@pytest.mark.parametrize("arch", ["olmo_1b", "stablelm_3b"])
def test_rope_matches_jax(arch):
    """Full rotation (olmo) and the partial fraction (stablelm: 0.25),
    at positions far from the start."""
    jcfg, tcfg = _cfgs(arch)
    rng = _rng("rope", arch)
    x = rng.standard_normal((2, 7, 4, jcfg.head_dim)).astype(np.float32)
    pos = (1000 + rng.integers(0, 50, (2, 7))).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = tlayers.rope(_t(x), _t(pos), tcfg)
    _close(got, want, 1e-5, arch)


@pytest.mark.parametrize("lowering", ["native", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_jax(lowering, dtype):
    """A dense layer through TINA (bias included), raw weights cast per
    call as the reference does and the prepared K-major copy made once:
    the same values, so the same output."""
    jcfg, tcfg = _cfgs("qwen2_7b", lowering, compute_dtype=dtype)
    rng = _rng("linear", lowering, dtype)
    w = rng.standard_normal((jcfg.d_model, 96)).astype(np.float32) * 0.1
    b = rng.standard_normal((96,)).astype(np.float32)
    x = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    want = jlayers.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, xj,
                          jcfg)
    xt = _t(x).to(tlayers.cdtype(tcfg))
    p = {"w": _t(w), "b": _t(b)}
    got = tlayers.linear(p, xt, tcfg)
    prepared = tlayers.prepare_linear(p, tcfg)
    assert got.dtype == xt.dtype
    assert ("wt" in prepared) == (dtype == "bfloat16")
    assert torch.equal(tlayers.linear(prepared, xt, tcfg), got)
    # bf16: the one rounding of each output; its f32 sums' order differs
    _close(got, want, 1e-5 if dtype == "float32" else 8e-3, dtype)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(mlp_type):
    jcfg, tcfg = _cfgs("olmo_1b", mlp_type=mlp_type)
    key = jax.random.PRNGKey(3)
    p = jlayers.init_mlp(key, jcfg)
    x = _rng("mlp", mlp_type).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    want = jlayers.mlp(p, jnp.asarray(x), jcfg)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), p)
    _close(tlayers.mlp(tp, _t(x), tcfg), want, 1e-5, mlp_type)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_prefill_and_rolling_decode_match_jax(window):
    """Prefill into a cache, then decode past its end: with a window the
    cache is a rolling buffer (writes at pos % size, the validity mask
    over the slots' absolute positions); the port keeps pos on the host."""
    jcfg, tcfg = _cfgs("qwen2_7b", attn_chunk=4)
    p = jlayers.init_attention(jax.random.PRNGKey(5), jcfg)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), p)
    rng = _rng("attn", window)
    b, s = 2, 9
    x = rng.standard_normal((b, s + 6, jcfg.d_model)).astype(np.float32)
    jc = jlayers.init_cache(jcfg, b, 16, window=window)
    tc = tlayers.init_cache(tcfg, b, 16, window=window, device="cpu")
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, jc = jlayers.attention(p, jnp.asarray(x[:, :s]), jcfg,
                                 positions=jnp.asarray(pos), cache=jc,
                                 window=window)
    got, tc = tlayers.attention(tp, _t(x[:, :s]), tcfg, positions=_t(pos),
                                pos0=0, cache=tc, window=window)
    _close(got, want, 1e-5, "prefill")
    for i in range(s, s + 6):
        pi = np.full((b, 1), i, np.int32)
        want, jc = jlayers.attention(p, jnp.asarray(x[:, i:i + 1]), jcfg,
                                     positions=jnp.asarray(pi), cache=jc,
                                     window=window)
        got, tc = tlayers.attention(tp, _t(x[:, i:i + 1]), tcfg,
                                    positions=_t(pi), pos0=i, cache=tc,
                                    window=window)
        assert tc["pos"] == int(jc["pos"]) == i + 1
        _close(got, want, 1e-5, f"decode {i}")
        _close(tc["k"], jc["k"], 1e-5, f"cache {i}")


# ---------------------------------------------------------------------------
# the whole model at f32
# ---------------------------------------------------------------------------
# recurrentgemma at 5 layers: one (rglru, rglru, attn) repeat and the
# unrolled (rglru, rglru) tail
OVER = {"recurrentgemma_9b": {"n_layers": 5}}


def model_inputs(cfg, b, s, rng):
    """numpy inputs of a forward over ``s`` positions: a vlm's patches
    (``num_patches`` of them) then tokens, an audio model's frames, or
    tokens."""
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal(
            (b, s, jmodel.AUDIO_FEAT_DIM)).astype(np.float32)}
    p = cfg.num_patches if cfg.frontend == "vision_stub" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - p)).astype(
        np.int32)}
    if p:
        out["patch_embeds"] = rng.standard_normal(
            (b, p, jmodel.VISION_FEAT_DIM)).astype(np.float32)
    return out


def prompt_of(batch, n):
    """The batch cut to its first ``n`` text tokens (patches kept)."""
    return {k: v[:, :n] if k == "tokens" else v for k, v in batch.items()}


@pytest.mark.parametrize("lowering", ["native", "kernel"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_forward_and_decode_match_jax_f32(arch, lowering):
    """Forward, then prefill + 4 decode steps, with the JAX weights; the
    MoE statistics too.  hubert (encoder-only) runs the forward."""
    jcfg, tcfg = _cfgs(arch, lowering, attn_chunk=8, **OVER.get(arch, {}))
    params, tp = _weights(jcfg, tcfg)
    b = 2
    s = 12 + (jcfg.num_patches if jcfg.frontend == "vision_stub" else 0)
    batch = model_inputs(jcfg, b, s, _rng("lm", arch))
    want, _, jaux = jmodel.forward(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        remat=False)
    got, _, taux = tmodel.forward(
        tp, {k: _t(v) for k, v in batch.items()}, tcfg)
    _close(got, want, F32_RTOL, f"{arch} forward")
    # the blocks' statistics summed over the layers: each block's are held
    # exactly in tests/test_torch_moe.py; XLA's scan sums them in f32 in
    # its own association
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6, k
    if jcfg.family == "audio":
        return

    tokens = batch["tokens"]
    t0 = tokens.shape[1] - 4
    jc = jmodel.init_caches(jcfg, b, max_len=s)
    tc = tmodel.init_caches(tcfg, b, s, device="cpu")
    prompt = prompt_of(batch, t0)
    want, jc, _ = jmodel.forward(
        params, {k: jnp.asarray(v) for k, v in prompt.items()}, jcfg,
        caches=jc, remat=False)
    got, tc, _ = tmodel.forward(tp, {k: _t(v) for k, v in prompt.items()},
                                tcfg, caches=tc)
    _close(got, want, F32_RTOL, f"{arch} prefill")
    for i in range(t0, tokens.shape[1]):
        want, jc = jmodel.decode_step(params, jnp.asarray(tokens[:, i]), jc,
                                      jcfg)
        got, tc = tmodel.decode_step(tp, _t(tokens[:, i]), tc, tcfg)
        _close(got, want, F32_RTOL, f"{arch} decode {i}")
        attn = "attn" in jcfg.block_pattern
        assert tmodel._cache_pos(tc) == (s - tokens.shape[1] + i + 1
                                         if attn else 0)


def test_convert_unstacks_the_vmapped_stack():
    """The reference's stack leaves carry the repeats on axis 0; the
    port holds one dict per layer, row i of each leaf."""
    jcfg, tcfg = _cfgs("stablelm_1_6b")
    params = jax.tree.map(np.asarray,
                          jmodel.init_model(jax.random.PRNGKey(1), jcfg))
    tp = convert.from_jax(params, tcfg, device="cpu")
    assert len(tp["stack"]) == jcfg.n_layers and tp["tail"] == []
    for i, sb in enumerate(tp["stack"]):
        got = sb["sub0"]["attn"]["wq"]
        np.testing.assert_array_equal(
            got["w"].numpy(), params["stack"]["sub0"]["attn"]["wq"]["w"][i])
        np.testing.assert_array_equal(
            got["b"].numpy(), params["stack"]["sub0"]["attn"]["wq"]["b"][i])
    np.testing.assert_array_equal(tp["head"]["w"].numpy(),
                                  params["head"]["w"])
    np.testing.assert_array_equal(tp["embed"]["table"].numpy(),
                                  params["embed"]["table"])
    # bf16 leaves keep their bits
    leaf = jnp.asarray(params["embed"]["table"][:3, :5], jnp.bfloat16)
    t = convert._tensor(np.asarray(leaf), torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(leaf.astype(jnp.float32)))
