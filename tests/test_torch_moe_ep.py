"""The MoE block over a mesh (``repro_torch.models.sharded.moe_block``)
against the reference's: its ``shard_map`` expert-parallel dispatch
(``cfg.moe_dispatch == "shard_map"``, ``src/repro/models/moe.py:145``)
run under ``axis_rules(default_rules() + {"__mesh__": mesh})`` on 8
forced host devices with ``Auto`` axes, in a subprocess; and the GSPMD
dispatch on a mesh against the port's unsharded block.

Reduced kimi-k2 (8 experts, top-2, one shared expert), f32 compute,
inputs (8, 32, 128) from a seeded normal plus one seeded vector shared
by every token (so the router favours some experts).  At capacity factor 8.0 no
token drops; at the config's own 1.25 each data shard's capacity is
counted from its own tokens and drops occur.

Tolerances: y within ``Y_TOL`` = 2^-7 of its largest element: both
sides round each shard's partial output to bf16 and sum in bf16 (the
combine), and a partial computed in another f32 order can round to the
neighbouring bf16 value, an ulp of 2^-8 of the partial, in either of two
partials; the drop fraction exactly (counts of kept and assigned
(token, expert) pairs, summed over every axis); the aux loss 1e-6
relative (the f32 router's mean over each shard's tokens, averaged over
the shards).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as shr
from repro_torch.distributed import step as step_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import sharded
from repro_torch.optim import constant, make_optimizer
from repro_torch.tree import flatten_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "kimi_k2_1t_a32b"
X_SHAPE = (8, 32, 128)
Y_TOL = 2.0 ** -7
MESHES = [(4, 2), (2, 4)]
CAPS = [8.0, 1.25]
LR = 1e-3
CASES = [dict(kind="moe", mesh=m, cap=c,
              name=f"moe-{'x'.join(map(str, m))}-{c}")
         for m in MESHES for c in CAPS]
CASES.append(dict(kind="train", mesh=(4, 2), cap=1.25,
                  name="train-4x2-1.25"))

ORACLE = """
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.data.pipeline import make_batch
from repro.distributed import step as step_lib
from repro.models import model as M
from repro.models.moe import init_moe, moe_block
from repro.optim import constant, make_optimizer
from repro.partitioning import axis_rules, default_rules

cases, out_dir = json.loads(sys.argv[1]), sys.argv[2]
rng = np.random.default_rng(0)
x = (rng.standard_normal(%(X)r)
     + 0.5 * rng.standard_normal(%(X)r[-1])).astype(np.float32)
for c in cases:
    cfg = get_reduced(%(ARCH)r).scaled(moe_dispatch="shard_map",
                                       moe_capacity_factor=c["cap"])
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        if c["kind"] == "moe":
            p = init_moe(jax.random.PRNGKey(0), cfg)
            rules = {**default_rules(), "__mesh__": mesh}
            with axis_rules(rules):
                y, aux = jax.jit(lambda p, x: moe_block(p, x, cfg))(
                    p, jnp.asarray(x))
            res = {"y": np.asarray(y),
                   "aux": np.asarray(aux["moe_aux_loss"]),
                   "drop": np.asarray(aux["moe_drop_frac"])}
        else:
            fn, specs = step_lib.make_train_step(
                cfg, mesh, batch_size=8, seq_len=32,
                lr_fn=constant(%(LR)r), grad_wire="none")
            params = M.init_model(jax.random.PRNGKey(0), cfg)
            opt = make_optimizer(cfg, constant(%(LR)r))
            st = jax.device_put(opt.init(params), specs.opt_state_sh)
            params = jax.device_put(params, specs.params_sh)
            batch = {k: jnp.asarray(v)
                     for k, v in make_batch(cfg, 8, 32).items()}
            _, s2, m = fn(params, st, batch)
            res = {"m/" + k: np.asarray(v) for k, v in m.items()}
            for path, v in jax.tree_util.tree_flatten_with_path(s2)[0]:
                res["s/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                    for k in path)] = np.asarray(v)
    np.savez(os.path.join(out_dir, c["name"] + ".npz"), **res)
""" % dict(X=X_SHAPE, ARCH=ARCH, LR=LR)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and a pool of threads per test worker only spins against the other
    workers' pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe_ep")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(ORACLE),
                        json.dumps(CASES), str(out)], capture_output=True,
                       text=True, env=env, timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return {c["name"]: dict(np.load(out / (c["name"] + ".npz")))
            for c in CASES}


def _setup(shape, cap, dispatch="shard_map"):
    jcfg = jconfigs.get_reduced(ARCH).scaled(moe_dispatch=dispatch,
                                             moe_capacity_factor=cap)
    tcfg = tconfigs.get_reduced(ARCH).scaled(moe_dispatch=dispatch,
                                             moe_capacity_factor=cap)
    p = convert._tree(jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(0), jcfg)), torch.device("cpu"))
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    L = step_lib.make_decode_step(tcfg, mesh=mesh, batch_size=X_SHAPE[0],
                                  cache_len=X_SHAPE[1]).specs.layout
    specs = shr.step_param_specs({"ffn": p}, tcfg, mesh, L.rules,
                                 compute=True)
    ps = [t["ffn"] for t in convert.shard_params({"ffn": p}, mesh, specs)]
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(X_SHAPE) + 0.5 * rng.standard_normal(
        X_SHAPE[-1])).astype(np.float32))
    return tcfg, L, p, ps, x


def _run(L, ps, x):
    xs = step_lib._split_batch(L, x)
    ys, aux = sharded.moe_block(L, ps, xs)
    return torch.cat([ys[i] for i in L.canon], 0), aux


@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] == "moe"],
                         ids=lambda c: c["name"])
def test_ep_dispatch_matches_reference_shard_map(case, oracle):
    want = oracle[case["name"]]
    _, L, _, ps, x = _setup(tuple(case["mesh"]), case["cap"])
    assert L.ep and L.expert == ("model",)
    y, aux = _run(L, ps, x)
    np.testing.assert_allclose(y.numpy(), want["y"], rtol=0,
                               atol=Y_TOL * np.abs(want["y"]).max())
    assert float(aux["moe_drop_frac"]) == float(want["drop"])
    np.testing.assert_allclose(float(aux["moe_aux_loss"]),
                               float(want["aux"]), rtol=1e-6)
    if case["cap"] == 8.0:
        assert float(want["drop"]) == 0.0
    else:
        assert float(want["drop"]) > 0.0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_gspmd_dispatch_on_a_mesh_is_the_unsharded_block(shape):
    """The GSPMD dispatch on a mesh: tokens gathered over data, each
    shard's expert group, the partial outputs summed over model: the
    unsharded block's routing, drops and aux exactly, y within 1e-6 of
    its largest (the combine's order)."""
    tcfg, L, p, ps, x = _setup(shape, 1.25, dispatch="gspmd")
    assert not L.ep
    y, aux = _run(L, ps, x)
    y1, aux1 = tmoe.moe_block(p, x, tcfg)
    np.testing.assert_allclose(y.numpy(), y1.numpy(), rtol=0,
                               atol=1e-6 * float(y1.abs().max()))
    assert float(aux["moe_drop_frac"]) == float(aux1["moe_drop_frac"]) > 0
    assert float(aux["moe_aux_loss"]) == float(aux1["moe_aux_loss"])
    for e in aux["moe_experts"]:
        assert torch.equal(e, aux1["moe_experts"])


def test_ep_routes_as_the_one_device_dispatch_on_its_tokens():
    """Each data shard's routing under the EP dispatch (its experts and
    which of its group's assignments it keeps) is the one-device block's
    on that shard's tokens with the router product in the activations'
    dtype: the same capacity, counted from the shard's own tokens."""
    tcfg, L, p, ps, x = _setup((2, 4), 1.25)
    xs = step_lib._split_batch(L, x)
    _, aux = sharded.moe_block(L, ps, xs)
    for i in range(L.mesh.size):
        n = xs[i].shape[0] * xs[i].shape[1]
        _, st = tmoe.routed(p, xs[i].reshape(n, -1), tcfg, lo=0,
                            n_local=tcfg.n_experts, router_in_x_dtype=True)
        assert torch.equal(aux["moe_experts"][i], st["experts"])
        e_per = tcfg.n_experts // L.mesh.count(L.expert)
        lo = L.rank(i, L.expert) * e_per
        mine = (st["experts"] >= lo) & (st["experts"] < lo + e_per)
        assert torch.equal(aux["moe_kept"][i], st["kept_mask"] & mine)


def test_ep_train_step_matches_jax_sharded_step(oracle):
    """Kimi at the shard_map dispatch, one sharded train step on (4, 2)
    (grad wire none): the loss, aux and drop fraction, and the gradient
    through the EP dispatch read from Adafactor's factors, against the
    reference's step: the metrics 1e-5 relative, the factors within 1e-3
    of their largest.  The factors' bar is wider than the dense steps'
    (``tests/test_torch_sharded.py``: 2e-4) because the combine's
    backward rounds the cotangent to bf16 on both sides, and a sum taken
    in another f32 order can round to the neighbouring bf16 value, 2^-8
    of the element, which a mean of squares doubles."""
    want = oracle["train-4x2-1.25"]
    jcfg = jconfigs.get_reduced(ARCH).scaled(moe_dispatch="shard_map")
    tcfg = tconfigs.get_reduced(ARCH).scaled(moe_dispatch="shard_map")
    params = jax.tree.map(np.asarray, jmodel.init_model(
        jax.random.PRNGKey(0), jcfg))
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    fn, specs = step_lib.make_train_step(tcfg, mesh=mesh, batch_size=8,
                                         seq_len=32, lr_fn=constant(LR),
                                         grad_wire="none")
    ps = convert.shard_params(convert.train_from_jax(params, tcfg,
                                                     device="cpu"),
                              mesh, specs.params_sh)
    opt = make_optimizer(tcfg, constant(LR))
    st = [opt.init(p) for p in ps]
    batch = jmake_batch(jcfg, 8, 32)
    _, st, m = fn(ps, st, {"tokens": torch.from_numpy(batch["tokens"])})
    for k in ("loss", "moe_aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(want["m/" + k]),
                                   rtol=1e-5, err_msg=k)
    assert float(m["moe_drop_frac"]) == float(want["m/moe_drop_frac"])
    got = dict(flatten_with_path(convert.unshard(st, mesh,
                                                 specs.opt_state_sh)))
    for k, w in want.items():
        if k.startswith("s/") and w.ndim:
            np.testing.assert_allclose(got[k[2:]].numpy(), w, rtol=0,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=k)
