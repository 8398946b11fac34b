"""The Mixture-of-Experts block on the port against the JAX package.

The reference's ``moe_block`` on its GSPMD path (``_moe_block_gspmd``,
the one it takes without a mesh) is the oracle; its weights are carried
across as numpy arrays and the inputs made by numpy from a seed.  The
routing is held exactly: the chosen experts equal JAX's ``top_k``, the
drop fraction equal bit for bit, the aux loss within 1e-6; the outputs
within 1e-4 of max at f32 and 2e-2 at bf16 (the JAX suite's decode
tolerance: the two frameworks round bf16 at other places).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

MOE = ["kimi_k2_1t_a32b", "arctic_480b"]     # shared expert, dense residual
JAX_LOWERING = {"native": "native", "kernel": "pallas"}
RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
AUX_TOL = 1e-6


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


def _cfgs(arch, dtype="float32", lowering="native", **over):
    jcfg = jconfigs.get_reduced(arch).scaled(
        compute_dtype=dtype, tina_lowering=JAX_LOWERING[lowering], **over)
    tcfg = tconfigs.get_reduced(arch).scaled(
        compute_dtype=dtype, tina_lowering=lowering, **over)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=1, edit=None):
    """The reference's init_moe tree (numpy leaves, edited by ``edit``),
    as JAX arrays and as the port's prepared tensors."""
    tree = jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(seed),
                                                jcfg))
    if edit is not None:
        edit(tree)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert._tree(tree, torch.device("cpu"))
    prepared = {**tp, **{k: tp[k].to(tlayers.cdtype(tcfg))
                         for k in tmoe.EXPERT_WEIGHTS}}
    for k in ("shared", "dense"):
        if k in tp:
            prepared[k] = {n: tlayers.prepare_linear(v, tcfg)
                           for n, v in tp[k].items()}
    return jp, prepared


def _jax_experts(jp, x, k):
    """The experts JAX's block chooses: its f32 router and lax.top_k."""
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    logits = jnp.asarray(x, jnp.float32).reshape(n, d) @ \
        jp["router"]["w"].astype(jnp.float32)
    _, experts = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    return np.asarray(experts)


def _run_both(jcfg, tcfg, jp, tp, x):
    dt = tlayers.cdtype(tcfg)
    want, jaux = jmoe._moe_block_gspmd(jp, jnp.asarray(x, jcfg.compute_dtype),
                                       jcfg)
    got, taux = tmoe.moe_block(tp, torch.from_numpy(x).to(dt), tcfg)
    assert got.dtype == dt
    return want, jaux, got, taux


def _kept(experts, cap, e):
    """The reference's keep rule in numpy: an expert keeps the first
    ``cap`` of its assignments in token order."""
    flat = experts.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=e)
    pos = np.arange(flat.size) - (np.cumsum(counts) - counts)[flat[order]]
    keep = np.empty(flat.size, bool)
    keep[order] = pos < cap
    return keep.reshape(experts.shape)


def _hold_routing(jp, x, jcfg, jaux, taux):
    xr = _np(jnp.asarray(x, jcfg.compute_dtype))
    experts = _jax_experts(jp, xr, jcfg.n_experts_per_token)
    np.testing.assert_array_equal(taux["moe_experts"].numpy(), experts)
    np.testing.assert_array_equal(
        taux["moe_kept"].numpy(),
        _kept(experts, jmoe._capacity(experts.shape[0], jcfg),
              jcfg.n_experts))
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    assert abs(float(taux["moe_aux_loss"]) - float(jaux["moe_aux_loss"])) \
        <= AUX_TOL


@pytest.mark.parametrize("dtype,lowering", [("float32", "native"),
                                            ("float32", "kernel"),
                                            ("bfloat16", "kernel")])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_jax(arch, dtype, lowering):
    """kimi (a shared expert) and arctic (a dense residual MLP), whose
    MLPs run the TINA matmul at the lowering."""
    jcfg, tcfg = _cfgs(arch, dtype, lowering)
    jp, tp = _params(jcfg, tcfg)
    x = _rng("moe", arch, dtype).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    want, jaux, got, taux = _run_both(jcfg, tcfg, jp, tp, x)
    _close(got, want, RTOL[dtype], f"{arch} {dtype}")
    _hold_routing(jp, x, jcfg, jaux, taux)


def _bias_to_expert_0(tree):
    tree["router"]["w"][0, 0] = 3.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_capacity_binds_and_drops_as_jax_does(arch, dtype):
    """Feature 0 constant and the router's weight from it to expert 0
    large: most tokens choose expert 0, which keeps only its capacity of
    them, the earliest in token order (a stable sort), as JAX keeps."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg, edit=_bias_to_expert_0)
    x = _rng("cap", arch).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    x[..., 0] = 5.0
    want, jaux, got, taux = _run_both(jcfg, tcfg, jp, tp, x)
    n, k = x.shape[0] * x.shape[1], jcfg.n_experts_per_token
    cap = jmoe._capacity(n, jcfg)
    assert tmoe.capacity(n, tcfg) == cap
    assert int((taux["moe_experts"] == 0).sum()) > 2 * cap
    assert float(taux["moe_drop_frac"]) > 0.1
    _hold_routing(jp, x, jcfg, jaux, taux)
    _close(got, want, RTOL[dtype], f"{arch} {dtype} capacity-bound")


def test_topk_ties_go_to_the_lower_index():
    """Equal probabilities: ``route`` picks the lower expert index first,
    as jax.lax.top_k does, whatever their places."""
    rng = _rng("ties")
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    vals, idx = tmoe.route(torch.from_numpy(probs), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_with_tied_experts_matches_jax(arch):
    """Two experts with the same router column tie on every token: the
    block routes to the lower one as JAX does, and gives its output."""
    jcfg, tcfg = _cfgs(arch)

    def tie(tree):
        tree["router"]["w"][:, 5] = tree["router"]["w"][:, 2]

    jp, tp = _params(jcfg, tcfg, edit=tie)
    x = _rng("tie", arch).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    logits = torch.from_numpy(x).reshape(-1, jcfg.d_model) @ \
        tp["router"]["w"]
    assert torch.equal(logits[:, 2], logits[:, 5])
    want, jaux, got, taux = _run_both(jcfg, tcfg, jp, tp, x)
    chosen = taux["moe_experts"]
    # tokens that chose both: 2 ranks before 5
    both = ((chosen == 2).any(-1) & (chosen == 5).any(-1)).nonzero()[:, 0]
    assert both.numel()
    for t in both.tolist():
        row = chosen[t].tolist()
        assert row.index(2) + 1 == row.index(5)
    _hold_routing(jp, x, jcfg, jaux, taux)
    _close(got, want, RTOL["float32"], f"{arch} tied")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_replays_bit_for_bit(dtype):
    """Each token's k contributions are added in ascending k, not
    scattered with atomics: two calls give the same bits."""
    cfg = tconfigs.get_reduced("kimi_k2_1t_a32b").scaled(compute_dtype=dtype)
    p = tmoe.init_moe(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(_rng("replay", dtype).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32)).to(tlayers.cdtype(cfg))
    y1, a1 = tmoe.moe_block(p, x, cfg)
    y2, a2 = tmoe.moe_block(p, x, cfg)
    assert torch.equal(y1, y2)
    assert torch.equal(a1["moe_experts"], a2["moe_experts"])
    assert float(a1["moe_drop_frac"]) == float(a2["moe_drop_frac"])


def test_moe_routing_sane():
    """The port of the JAX suite's test_moe_routing_sane: output shape,
    finite aux loss, bounded drop fraction (reduced kimi)."""
    cfg = tconfigs.get_reduced("kimi_k2_1t_a32b")
    p = tmoe.init_moe(torch.Generator().manual_seed(1), cfg)
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y, aux = tmoe.moe_block(p, x, cfg)
    assert y.shape == x.shape
    assert np.isfinite(float(aux["moe_aux_loss"]))
    assert 0.0 <= float(aux["moe_drop_frac"]) < 0.6


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "arctic_480b"])
@pytest.mark.parametrize("n", [1, 8, 100, 4096])
def test_capacity_is_the_reference_rule(arch, n):
    """Full configs: a decode step's few tokens and a prefill's many get
    the reference's capacities (at least 8, a multiple of 8)."""
    assert tmoe.capacity(n, tconfigs.get(arch)) == \
        jmoe._capacity(n, jconfigs.get(arch))
