"""The port's sharded LM steps (``repro_torch.distributed.step`` with
``mesh=``, ``repro_torch.models.sharded``, ``distributed/collectives``)
on logical CPU shards, against the reference's sharded steps and the
port's own one-device step.

The oracle is the reference's ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` on 8 forced host devices, in one subprocess
(JAX fixes its device count at first use), each mesh built with
``jax.make_mesh(..., axis_types=(AxisType.Auto,) * n)`` and the steps
run inside ``with mesh:``: on this JAX, ``make_mesh``'s default axes
are ``Explicit`` and the reference's ``with_sharding_constraint``
refuses them (why 7 of the reference's own distributed tests fail).
Nothing of the JAX package changes for it.  Weights are the reference's
``init_model(PRNGKey(0))`` carried across (``convert.train_from_jax``,
then ``convert.shard_params``); the batch is its ``make_batch``.

Tolerances (reduced configs, f32 compute):

* loss within 1e-5 relative; the MoE aux loss 1e-5 and its drop fraction
  exactly (counts);
* the gradient, read from the optimizer state after one step (AdamW's
  first moment is 0.1 x the clipped gradient, Adafactor's factors its
  row and column mean squares), within ``STATE_TOL`` of each leaf's
  largest: 1e-4 at ``grad_wire="none"``; 1e-2 at ``"bf16"``, where the
  port rounds each shard's gradient to bf16 before the data-parallel
  sum and the reference rounds the summed gradient (an element may move
  by a bf16 ulp, 2^-8 of itself, and the sum of rounded parts by 2^-8 of
  the largest part, which can exceed the sum); a second moment (a mean
  of squares) is held to twice these (``SQUARE``), as squaring doubles a
  relative error;
* the grad norm 1e-5 relative at ``"none"``, 1e-2 at ``"bf16"``;
* a parameter after the step within ``PARAM_TOL``: AdamW's first step
  moves each element by lr x g / (|g| + 1e-8), which a gradient within
  the state bar can move by up to 2 lr where |g| is near 1e-8 (lr = 1e-3
  here, so the bar is 2.5e-3, a ceiling no step can exceed); so AdamW's
  step is also held where its sign is sure: on the elements whose
  reference first moment clears ``SIGN_SURE`` times the state bar of its
  leaf's largest (no gradient within the bar can flip them), within
  ``ADAMW_STEP_TOL`` = 1e-3 lr (measured: 6e-8, one f32 ulp of a
  parameter near 1; a step that left a position's parameters as they
  were misses by lr there); Adafactor's by lr x its normalised
  update, whose elements reach ~5: 1e-5 at ``"none"``, 1e-4 at
  ``"bf16"`` (1e-2 of an update of 5 at lr 1e-3 is 5e-5).
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
from repro_torch import configs as tconfigs
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shr
from repro_torch.distributed import step as step_lib
from repro_torch.launch.mesh import (Mesh, make_local_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.optim import constant, make_optimizer
from repro_torch.tree import flatten_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LR = 1e-3
B, S = 8, 32
MESHES = [(4, 2), (2, 4), (2, 2, 2)]
ARCHS = {"qwen2_7b": dict(fsdp=True), "olmo_1b": {},
         "kimi_k2_1t_a32b": {}}
MODES = [("tp", "bf16"), ("fsdp", "none")]
STATE_TOL = {"none": 1e-4, "bf16": 1e-2}
NORM_TOL = {"none": 1e-5, "bf16": 1e-2}
SQUARE = 2.0
ADAMW_PARAM_TOL = 2.5 * LR
SIGN_SURE = 2.0
ADAMW_STEP_TOL = 1e-3 * LR
ADAFACTOR_PARAM_TOL = {"none": 1e-5, "bf16": 1e-4}
PROMPT, DECODE = 16, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and a pool of threads per test worker only spins against the other
    workers' pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _name(kind, arch, shape, layout="tp", wire="none"):
    return f"{kind}-{arch}-{'x'.join(map(str, shape))}-{layout}-{wire}"


TRAIN_CASES = [dict(kind="train", arch=a, over=ARCHS[a], mesh=m, layout=l,
                    wire=w, name=_name("train", a, m, l, w))
               for m in MESHES for a in ARCHS for l, w in MODES]
# KV heads replicated: 2 KV heads on 4-way tensor parallelism
KV2 = dict(fsdp=True, n_kv_heads=2)
TRAIN_CASES.append(dict(kind="train", arch="qwen2_7b", over=KV2,
                        mesh=(2, 4), layout="tp", wire="none",
                        name=_name("train", "qwen2kv2", (2, 4))))
SERVE_CASES = [dict(kind="serve", arch=a, over=ARCHS[a], mesh=(4, 2),
                    name=_name("serve", a, (4, 2)))
               for a in ("qwen2_7b", "kimi_k2_1t_a32b")]

ORACLE = """
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.data.pipeline import make_batch
from repro.distributed import step as step_lib
from repro.models import model as M
from repro.optim import constant, make_optimizer

def flat(tree, prefix):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[prefix + key] = np.asarray(v)
    return out

cases, out_dir = json.loads(sys.argv[1]), sys.argv[2]
for c in cases:
    cfg = get_reduced(c["arch"]).scaled(**c["over"])
    shape = tuple(c["mesh"])
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
    params = M.init_model(jax.random.PRNGKey(0), cfg)
    with mesh:
        if c["kind"] == "train":
            fn, specs = step_lib.make_train_step(
                cfg, mesh, batch_size=%(B)d, seq_len=%(S)d,
                lr_fn=constant(%(LR)r), grad_wire=c["wire"],
                layout=c["layout"])
            opt = make_optimizer(cfg, constant(%(LR)r))
            st = jax.device_put(opt.init(params), specs.opt_state_sh)
            params = jax.device_put(params, specs.params_sh)
            batch = {k: jnp.asarray(v)
                     for k, v in make_batch(cfg, %(B)d, %(S)d).items()}
            p2, s2, m = fn(params, st, batch)
            res = {**flat(p2, "p/"), **flat(s2, "s/"),
                   **{"m/" + k: np.asarray(v) for k, v in m.items()}}
        else:
            max_len = %(PROMPT)d + %(DECODE)d
            pre, ps = step_lib.make_prefill_step(cfg, mesh, batch_size=%(B)d,
                                                 seq_len=%(PROMPT)d)
            dec, ds = step_lib.make_decode_step(cfg, mesh, batch_size=%(B)d,
                                                cache_len=max_len)
            params = jax.device_put(params, ps.params_sh)
            caches = M.init_caches(cfg, %(B)d, max_len)
            batch = make_batch(cfg, %(B)d, %(PROMPT)d)
            logits, caches = pre(params, {"tokens": jnp.asarray(
                batch["tokens"])}, caches)
            res = {"logits0": np.asarray(logits)}
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            for i in range(%(DECODE)d):
                tok, logits, caches = dec(params, tok, caches)
                res[f"logits{i + 1}"] = np.asarray(logits)
                res[f"tok{i + 1}"] = np.asarray(tok)
    np.savez(os.path.join(out_dir, c["name"] + ".npz"), **res)
    print("done", c["name"], flush=True)
""" % dict(B=B, S=S, LR=LR, PROMPT=PROMPT, DECODE=DECODE)


def run_oracle(cases, out_dir, n_devices=8):
    """The reference on ``n_devices`` forced host devices, in a
    subprocess; returns {case name: {key: array}}."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(ORACLE),
                        json.dumps(cases), str(out_dir)],
                       capture_output=True, text=True, env=env, timeout=1200)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return {c["name"]: dict(np.load(os.path.join(out_dir,
                                                 c["name"] + ".npz")))
            for c in cases}


def cases_on(shape):
    """The train cases of one mesh shape: each mesh's oracle runs in its
    own file's subprocess (``tests/test_torch_sharded_2x4.py``,
    ``tests/test_torch_sharded_pod.py``), so the three run apart."""
    return [c for c in TRAIN_CASES if tuple(c["mesh"]) == tuple(shape)]


LOCAL_CASES = cases_on((4, 2))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(LOCAL_CASES + SERVE_CASES,
                      tmp_path_factory.mktemp("jax_sharded"))


def _cfgs(arch, over):
    return (jconfigs.get_reduced(arch).scaled(**over),
            tconfigs.get_reduced(arch).scaled(**over))


@pytest.fixture(scope="module")
def weights():
    return load_weights()


def load_weights():
    """Each config's reference weights (numpy) and batch."""
    out = {}
    for arch, over in list(ARCHS.items()) + [("qwen2kv2", KV2)]:
        jcfg, tcfg = _cfgs("qwen2_7b" if arch == "qwen2kv2" else arch, over)
        params = jax.tree.map(np.asarray,
                              jmodel.init_model(jax.random.PRNGKey(0), jcfg))
        out[arch] = (tcfg, params, jmake_batch(jcfg, B, S))
    return out


def _mesh(shape):
    return make_mesh(shape, _axes(shape), "cpu")


def _sharded_step(tcfg, params, batch, shape, layout, wire):
    mesh = _mesh(shape)
    fn, specs = step_lib.make_train_step(
        tcfg, mesh=mesh, layout=layout, batch_size=B, seq_len=S,
        lr_fn=constant(LR), grad_wire=wire)
    ps = convert.shard_params(convert.train_from_jax(params, tcfg,
                                                     device="cpu"),
                              mesh, specs.params_sh)
    opt = make_optimizer(tcfg, constant(LR))
    st = [opt.init(p) for p in ps]
    ps, st, m = fn(ps, st, {"tokens": torch.from_numpy(batch["tokens"])})
    return (dict(flatten_with_path(convert.unshard(ps, mesh,
                                                   specs.params_sh))),
            dict(flatten_with_path(convert.unshard(st, mesh,
                                                   specs.opt_state_sh))),
            {k: float(v) for k, v in m.items()})


def _one_device_step(tcfg, params, batch):
    fn, _ = step_lib.make_train_step(tcfg, batch_size=B, seq_len=S,
                                     lr_fn=constant(LR), grad_wire="none",
                                     device="cpu")
    p = convert.train_from_jax(params, tcfg, device="cpu")
    opt = make_optimizer(tcfg, constant(LR))
    p, st, m = fn(p, opt.init(p), {"tokens": torch.from_numpy(
        batch["tokens"])})
    return (dict(flatten_with_path(p)), dict(flatten_with_path(st)),
            {k: float(v) for k, v in m.items()})


def _hold(got, want, wire, adafactor, determined=False):
    """Params, optimizer state and metrics of one step (see the module's
    docstring for the bars).  ``determined``: AdamW's step is held on
    the sign-sure elements where the state bar also bounds it (its
    change lr eps d / (|g| - d + eps)^2, for the gradient error d the
    bar allows, within ``ADAMW_STEP_TOL``): an element whose leaf's
    gradients sit near AdamW's eps (1e-8) moves by ~lr under a gradient
    error of a few percent of itself, which the bf16 wire's rounded parts
    make."""
    gp, gs, gm = got
    wp, ws, wm = want
    np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=1e-5)
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"],
                               rtol=NORM_TOL[wire])
    np.testing.assert_allclose(gm["moe_aux_loss"], wm["moe_aux_loss"],
                               rtol=1e-5, atol=1e-7)
    assert gm["moe_drop_frac"] == pytest.approx(wm["moe_drop_frac"],
                                                abs=1e-7)
    assert gs.keys() == ws.keys() and gp.keys() == wp.keys()
    for k, w in ws.items():
        w = np.asarray(w, dtype=np.float64)
        if w.ndim == 0:
            continue
        g = gs[k].double().numpy()
        tol = STATE_TOL[wire] * (1.0 if k.startswith("m/") else SQUARE)
        np.testing.assert_allclose(g, w, rtol=0, err_msg=k,
                                   atol=tol * np.abs(w).max())
    ptol = ADAFACTOR_PARAM_TOL[wire] if adafactor else ADAMW_PARAM_TOL
    for k, w in wp.items():
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(w), rtol=0,
                                   atol=ptol, err_msg=k)
    if adafactor:
        return
    worst = 0.0
    for k, w in wp.items():
        m = np.abs(np.asarray(ws["m/" + k], dtype=np.float64))
        sure = m > SIGN_SURE * STATE_TOL[wire] * m.max()
        if determined:                 # b1 = 0.9: m = 0.1 g at step 1
            g, d = m / 0.1, STATE_TOL[wire] * m.max() / 0.1
            sure &= LR * 1e-8 * d <= ADAMW_STEP_TOL * (g - d + 1e-8) ** 2
        if sure.any():
            d = np.abs(gp[k].double().numpy() - np.asarray(w, np.float64))
            worst = max(worst, float(d[sure].max()))
    assert worst <= ADAMW_STEP_TOL, worst


def _from_oracle(res):
    return ({k[2:]: v for k, v in res.items() if k.startswith("p/")},
            {k[2:]: v for k, v in res.items() if k.startswith("s/")},
            {k[2:]: float(v) for k, v in res.items() if k.startswith("m/")})


# ---------------------------------------------------------------------------
# (a) the train step against the reference's sharded step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", LOCAL_CASES, ids=[c["name"]
                                                   for c in LOCAL_CASES])
def test_train_step_matches_jax_sharded_step(case, oracle, weights):
    check_case(case, oracle, weights)


def check_case(case, oracle, weights):
    """One train case against its oracle result (the module's bars)."""
    key = "qwen2kv2" if case["over"] is KV2 else case["arch"]
    tcfg, params, batch = weights[key]
    got = _sharded_step(tcfg, params, batch, tuple(case["mesh"]),
                        case["layout"], case["wire"])
    _hold(got, _from_oracle(oracle[case["name"]]), case["wire"],
          tcfg.optimizer == "adafactor")


# ---------------------------------------------------------------------------
# (b) the sharded step against the port's own one-device step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", list(ARCHS) + ["qwen2kv2"])
@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_train_step_matches_one_device_step(layout, arch, shape, weights):
    tcfg, params, batch = weights[arch]
    got = _sharded_step(tcfg, params, batch, shape, layout, "none")
    _hold(got, _one_device_step(tcfg, params, batch), "none",
          tcfg.optimizer == "adafactor")


def test_microbatch_and_bf16_wire_on_a_mesh(weights):
    """``microbatch=2`` slices the global batch before it splits over the
    data axes; the mean of the two slices' gradients is the whole
    batch's (equal token counts), within the one-device step's own
    microbatch bar; the bf16 wire leaves every gradient on the bf16
    grid."""
    tcfg, params, batch = weights["olmo_1b"]
    mesh = _mesh((2, 2, 2))
    fn, specs = step_lib.make_train_step(
        tcfg, mesh=mesh, batch_size=B, seq_len=S, lr_fn=constant(LR),
        grad_wire="bf16", microbatch=2)
    ps = convert.shard_params(convert.train_from_jax(params, tcfg,
                                                     device="cpu"),
                              mesh, specs.params_sh)
    opt = make_optimizer(tcfg, constant(LR))
    st = [opt.init(p) for p in ps]
    _, st, m = fn(ps, st, {"tokens": torch.from_numpy(batch["tokens"])})
    _, ws, wm = _one_device_step(tcfg, params, batch)
    np.testing.assert_allclose(float(m["loss"]), wm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), wm["grad_norm"],
                               rtol=1e-2)
    gs = dict(flatten_with_path(convert.unshard(st, mesh,
                                                specs.opt_state_sh)))
    for k, w in ws.items():
        if k.startswith("m/"):
            np.testing.assert_allclose(gs[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-2 * float(w.abs().max()),
                                       err_msg=k)


# ---------------------------------------------------------------------------
# (c) prefill and decode against the reference's sharded serving steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SERVE_CASES,
                         ids=[c["name"] for c in SERVE_CASES])
def test_prefill_and_decode_match_jax_sharded_steps(case, oracle):
    """Logits within 1e-4 of the largest at f32, greedy tokens equal."""
    want = oracle[case["name"]]
    jcfg, tcfg = _cfgs(case["arch"], case["over"])
    mesh = _mesh(tuple(case["mesh"]))
    max_len = PROMPT + DECODE
    pre = step_lib.make_prefill_step(tcfg, mesh=mesh, batch_size=B,
                                     seq_len=PROMPT)
    dec = step_lib.make_decode_step(tcfg, mesh=mesh, batch_size=B,
                                    cache_len=max_len)
    params = convert.from_jax(jax.tree.map(np.asarray, jmodel.init_model(
        jax.random.PRNGKey(0), jcfg)), tcfg, device="cpu")
    ps = convert.shard_params(params, mesh, dec.specs.params_sh, copy=False)
    caches = step_lib.init_sharded_caches(dec.specs, B, max_len)
    tokens = torch.from_numpy(jmake_batch(jcfg, B, PROMPT)["tokens"])
    logits, caches = pre(ps, {"tokens": tokens}, caches)

    def close(got, w):
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    close(logits, want["logits0"])
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(DECODE):
        tok, logits, caches = dec(ps, tok, caches)
        close(logits, want[f"logits{i + 1}"])
        np.testing.assert_array_equal(tok.numpy(), want[f"tok{i + 1}"])


def test_sharded_decode_matches_one_device_decode():
    """Reduced olmo on (2, 2, 2) at the kernel lowering (its plain
    versions here), prepared shards: the same logits as the one-device
    steps, within 1e-5 of the largest."""
    cfg = tconfigs.get_reduced("olmo_1b").scaled(tina_lowering="kernel")
    mesh = _mesh((2, 2, 2))
    params = tmodel.init_model(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                           generator=torch.Generator().manual_seed(0))
    max_len = PROMPT + DECODE
    pre1 = step_lib.make_prefill_step(cfg, batch_size=B, seq_len=PROMPT)
    dec1 = step_lib.make_decode_step(cfg, batch_size=B, cache_len=max_len)
    pre = step_lib.make_prefill_step(cfg, mesh=mesh, batch_size=B,
                                     seq_len=PROMPT)
    dec = step_lib.make_decode_step(cfg, mesh=mesh, batch_size=B,
                                    cache_len=max_len)
    one = tmodel.prepare(params, cfg)
    c1 = tmodel.init_caches(cfg, B, max_len, device="cpu")
    ps = [tmodel.prepare(t, cfg) for t in convert.shard_params(
        params, mesh, dec.specs.params_sh, copy=False)]
    cs = step_lib.init_sharded_caches(dec.specs, B, max_len)
    l1, c1 = pre1(one, {"tokens": tokens}, c1)
    ls, cs = pre(ps, {"tokens": tokens}, cs)
    tok = torch.argmax(l1, -1).to(torch.int32)
    for _ in range(DECODE):
        assert torch.allclose(ls, l1, rtol=0,
                              atol=1e-5 * float(l1.abs().max()))
        t1, l1, c1 = dec1(one, tok, c1)
        ts, ls, cs = dec(ps, tok, cs)
        assert torch.equal(t1, ts)
        tok = t1


# ---------------------------------------------------------------------------
# collectives, shard/unshard, meshes
# ---------------------------------------------------------------------------
def test_collectives_and_their_adjoints():
    """On a (2, 2, 2) CPU mesh: the sums, gathers and scatters are what
    the definitions say, and each backward is its forward's adjoint
    (<A x, y> == <x, A^T y> on random tensors)."""
    mesh = _mesh((2, 2, 2))
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(4, 6, generator=g, dtype=torch.float64)
          for _ in range(8)]
    ys = coll.all_reduce(xs, mesh, ("pod", "data"))
    for grp in mesh.groups(("pod", "data")):
        want = xs[grp[0]] + xs[grp[1]] + xs[grp[2]] + xs[grp[3]]
        for i in grp:
            assert torch.equal(ys[i], want)
    gs = coll.all_gather(xs, mesh, "model", 1)
    for a, b in mesh.groups("model"):
        assert torch.equal(gs[a], torch.cat([xs[a], xs[b]], 1))
    rs = coll.reduce_scatter(xs, mesh, "data", 0)
    for a, b in mesh.groups("data"):
        s = xs[a] + xs[b]
        assert torch.equal(rs[a], s[:2]) and torch.equal(rs[b], s[2:])
    mx = coll.all_reduce_max(xs, mesh, "model")
    for a, b in mesh.groups("model"):
        assert torch.equal(mx[b], torch.maximum(xs[a], xs[b]))
    for fn, rel in ((lambda v: coll.all_reduce(v, mesh, "data"), 1e-12),
                    (lambda v: coll.all_gather(v, mesh, ("pod", "model"),
                                               0), 1e-12),
                    (lambda v: coll.reduce_scatter(v, mesh, "model", 1),
                     1e-12),
                    # rounds to bf16: adjoint to bf16's precision
                    (lambda v: coll.expert_combine(v, mesh, "model"),
                     1e-2)):
        x = [t.clone().requires_grad_() for t in xs]
        out = fn(x)
        w = [torch.randn(o.shape, generator=g, dtype=o.dtype) for o in out]
        lhs = sum(float((o * v).sum()) for o, v in zip(out, w))
        grads = torch.autograd.grad(out, x, w)
        rhs = sum(float((a * b).sum()) for a, b in zip(xs, grads))
        assert lhs == pytest.approx(rhs, rel=rel)


def test_collective_routes():
    assert coll.route(["cpu"] * 4) == "sum"
    assert coll.route(["cuda:0", "cuda:1"]) == "nccl"
    assert coll.route(["cuda:0", "cuda:0"]) == "sum"
    with pytest.raises(ValueError, match="mixes"):
        coll.route(["cuda:0", "cuda:0", "cuda:1"])
    assert coll.mesh_routes(_mesh((4, 2)), "model") == {"sum"}


def test_shard_params_round_trip_and_ownership():
    cfg = tconfigs.get_reduced("qwen2_7b").scaled(fsdp=True)
    mesh = _mesh((2, 2, 2))
    _, specs = step_lib.make_train_step(cfg, mesh=mesh, batch_size=B,
                                        seq_len=S)
    p = convert.stack_params(tmodel.init_model(cfg, device="cpu"))
    ps = convert.shard_params(p, mesh, specs.params_sh)
    back = dict(flatten_with_path(convert.unshard(ps, mesh,
                                                  specs.params_sh)))
    for k, t in flatten_with_path(p):
        assert torch.equal(back[k], t), k
    # every position owns its memory (in-place updates stay its own)
    ptrs = [t.data_ptr() for tree in ps for _, t in flatten_with_path(tree)]
    assert len(set(ptrs)) == len(ptrs)
    wq = ps[0]["stack"]["sub0"]["attn"]["wq"]["w"]
    assert tuple(wq.shape) == (2, cfg.d_model // 2, 4 * 32 // 2)


def test_meshes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert m.device_type == "meta" and m.size == 256
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises((ValueError, RuntimeError)):
        make_production_mesh(device="cuda")
    m = make_local_mesh(model=2, device="cpu", n=8)
    assert m.shape == {"data": 4, "model": 2}
    assert make_local_mesh(model=4, device="cpu", n=2).shape == \
        {"data": 1, "model": 2}
    m = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    assert [m.rank(i, ("pod", "data")) for i in range(8)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert m.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="pair up"):
        Mesh((2, 2), ("data",), ("cpu",) * 4)
    with pytest.raises(ValueError, match="devices for"):
        Mesh((2, 2), ("data", "model"), ("cpu",) * 3)
    with pytest.raises(ValueError, match="mix types"):
        Mesh((2,), ("data",), ("cpu", "meta"))


# ---------------------------------------------------------------------------
# (f) refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("over,shape", [
    (dict(head_dim=31), (1, 8)),                 # h * hd = 124, 8-way
    (dict(d_ff=260), (1, 8)),                    # d_ff columns, 8-way
    (dict(d_ff=251), (4, 2)),                    # columns
])
def test_head_counts_that_cannot_split_raise(over, shape):
    """A width the tensor-parallel degree does not divide raises, naming
    it (the reference's legalize would replicate the leaf); head counts
    it does not divide split their flat columns
    (``tests/test_torch_sharded_flat.py``)."""
    cfg = tconfigs.get_reduced("olmo_1b").scaled(**over)
    with pytest.raises(ValueError, match="do not split"):
        step_lib.make_train_step(cfg, mesh=_mesh(shape), batch_size=B,
                                 seq_len=S)


def test_train_step_refusals():
    cfg = tconfigs.get_reduced("olmo_1b")
    mesh = _mesh((4, 2))
    with pytest.raises(ValueError, match="no gradient"):
        step_lib.make_train_step(cfg.scaled(tina_lowering="kernel"),
                                 mesh=mesh, batch_size=B, seq_len=S)
    with pytest.raises(ValueError, match="needs a mesh"):
        step_lib.make_train_step(cfg, batch_size=B, seq_len=S,
                                 layout="fsdp", device="cpu")
    fn, specs = step_lib.make_train_step(cfg, mesh=mesh, batch_size=B,
                                         seq_len=S)
    p = convert.stack_params(tmodel.init_model(cfg, device="cpu"))
    ps = convert.shard_params(p, mesh, specs.params_sh)
    opt = make_optimizer(cfg, constant(LR))
    with pytest.raises(ValueError, match="one tree a mesh position"):
        fn(p, opt.init(p), {"tokens": torch.zeros(B, S, dtype=torch.int32)})
    with pytest.raises(ValueError, match="rows over"):
        fn(ps, [opt.init(x) for x in ps],
           {"tokens": torch.zeros(6, S, dtype=torch.int32)})


def test_batch_not_dividing_the_data_axes_is_replicated():
    """The reference's ``_rules_for``: a batch of 2 on 4 data shards
    replicates over them; the step still equals the one-device step."""
    cfg = tconfigs.get_reduced("olmo_1b")
    mesh = _mesh((4, 2))
    rules = step_lib.sharded_rules(cfg, mesh, batch_size=2)
    assert rules["batch"] is None
    tokens = torch.randint(0, cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(1))
    fn, specs = step_lib.make_train_step(cfg, mesh=mesh, batch_size=2,
                                         seq_len=S, grad_wire="none")
    p = convert.stack_params(tmodel.init_model(cfg, device="cpu"))
    ps = convert.shard_params(p, mesh, specs.params_sh)
    opt = make_optimizer(cfg, constant(LR))
    _, _, m = fn(ps, [opt.init(x) for x in ps], {"tokens": tokens})
    one, _ = step_lib.make_train_step(cfg, batch_size=2, seq_len=S,
                                      grad_wire="none", device="cpu")
    _, _, mw = one(p, opt.init(p), {"tokens": tokens})
    np.testing.assert_allclose(float(m["loss"]), float(mw["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(mw["grad_norm"]), rtol=1e-5)


def test_kv_replicated_specs():
    cfg = tconfigs.get_reduced("qwen2_7b").scaled(n_kv_heads=2)
    mesh = _mesh((2, 4))
    rules = step_lib.sharded_rules(cfg, mesh, batch_size=B)
    assert shr.kv_replicated(cfg, mesh, rules)
    specs = dict(flatten_with_path(
        shr.step_param_specs(step_lib.param_specs(cfg), cfg, mesh, rules),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert specs["stack/sub0/attn/wk/w"] == (None, None, None)
    assert specs["stack/sub0/attn/wq/w"] == (None, None, "model")
