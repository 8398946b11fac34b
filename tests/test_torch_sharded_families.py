"""The port's sharded LM steps for every family and layout: the RG-LRU
hybrid (recurrentgemma, with its unrolled tail), rwkv6, the vision and
audio frontends (internvl2, hubert), at ``layout="tp"``, ``"fsdp"`` and
``"sp"`` and with Megatron-SP (``sequence_parallel=True``), on logical
CPU shards of a (data 4, model 2) mesh, against the reference's sharded
``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` and
against the port's own one-device steps.

The oracle is ``tests/test_torch_sharded.py``'s: the reference on 8
forced host devices in a subprocess, ``Auto`` mesh axes, the steps run
inside ``with mesh:``; here it takes the whole batch (patches, frames,
targets and mask) and the layout.  Each file of this group runs its own
subprocess (``--dist loadfile`` spreads them): this one recurrentgemma,
``_rwkv`` rwkv6, ``_vlm`` internvl2 and every config's steps at every
layout against its one-device steps, ``_audio`` hubert and olmo_1b's
sequence-parallel steps.  recurrentgemma runs at ``n_layers=5``: one
(rglru, rglru, attn) superblock and a (rglru, rglru) tail (its reduced
config's 6 layers leave none).

Bars (f32 compute), those of ``tests/test_torch_sharded.py``: the train
step's loss within 1e-5 relative, the gradient (from the optimizer
state) within ``STATE_TOL`` of each leaf's largest, the grad norm within
``NORM_TOL``, the parameters as ``_hold`` holds them, AdamW's step
where the state bar determines it (``_hold(determined=True)``: the
gradients of recurrentgemma's first ``w_r`` peak at 8.4e-9 and of
rwkv6's ``td_w2`` at ~7e-9, below AdamW's eps of 1e-8, where a gradient
within the bar moves a sign-sure step by 1.5e-3 lr); serving logits
within 1e-4 of their largest and the greedy tokens equal.  rwkv6 trains
at no wire in float64 (``tests/test_torch_sharded_families_rwkv.py``).
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
from repro_torch.distributed import sharding as shr
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.optim import constant, make_optimizer
from repro_torch.tree import flatten_with_path

# one_thread: the autouse fixture, imported so that it runs here too
from test_torch_sharded import (B, DECODE, LR, PROMPT, S, SRC, _hold, _mesh,
                                one_thread)

MESH = (4, 2)
TAIL = dict(n_layers=5)
OVER = {"recurrentgemma_9b": TAIL}
F64 = dict(param_dtype="float64", compute_dtype="float64")
SERVE_TOL = 1e-4


def _name(kind, arch, layout, wire="none", sp=False, f64=False):
    return (f"{kind}-{arch}-{layout}{'+sp' if sp else ''}-{wire}"
            f"{'-f64' if f64 else ''}")


def train_case(arch, layout, wire="none", sp=False, f64=False):
    """``f64``: parameters and compute in float64 (the reference with
    ``jax_enable_x64``), for a config whose f32 step moves by more than
    the bars under any reordering of its sums (rwkv6)."""
    return dict(kind="train", arch=arch,
                over={**OVER.get(arch, {}), **(F64 if f64 else {})},
                mesh=MESH, layout=layout, wire=wire, sp=sp, x64=f64,
                name=_name("train", arch, layout, wire, sp, f64))


def serve_case(arch, layout):
    return dict(kind="serve", arch=arch, over=OVER.get(arch, {}),
                mesh=MESH, layout=layout, name=_name("serve", arch, layout))


def family_cases(arch):
    """An arch's train cases at (tp, bf16 wire) and (fsdp, no wire)."""
    return [train_case(arch, "tp", "bf16"), train_case(arch, "fsdp")]


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
    jax.config.update("jax_enable_x64", bool(c.get("x64")))
    cfg = get_reduced(c["arch"]).scaled(**c["over"])
    shape = tuple(c["mesh"])
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = M.init_model(jax.random.PRNGKey(0), cfg)
    with mesh:
        if c["kind"] == "train":
            fn, specs = step_lib.make_train_step(
                cfg, mesh, batch_size=%(B)d, seq_len=%(S)d,
                lr_fn=constant(%(LR)r), grad_wire=c["wire"],
                layout=c["layout"], sequence_parallel=c["sp"])
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
            pre, ps = step_lib.make_prefill_step(
                cfg, mesh, batch_size=%(B)d, seq_len=%(PROMPT)d,
                layout=c["layout"])
            params = jax.device_put(params, ps.params_sh)
            caches = M.init_caches(cfg, %(B)d, max_len)
            batch = {k: jnp.asarray(v) for k, v in
                     make_batch(cfg, %(B)d, %(PROMPT)d).items()}
            logits, caches = pre(params, batch, caches)
            res = {"logits0": np.asarray(logits)}
            if cfg.family != "audio":
                dec, ds = step_lib.make_decode_step(
                    cfg, mesh, batch_size=%(B)d, cache_len=max_len,
                    layout=c["layout"])
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                for i in range(%(DECODE)d):
                    tok, logits, caches = dec(params, tok, caches)
                    res[f"logits{i + 1}"] = np.asarray(logits)
                    res[f"tok{i + 1}"] = np.asarray(tok)
    np.savez(os.path.join(out_dir, c["name"] + ".npz"), **res)
    print("done", c["name"], flush=True)
""" % dict(B=B, S=S, LR=LR, PROMPT=PROMPT, DECODE=DECODE)


def run_oracle(cases, out_dir):
    """The reference's sharded steps on 8 forced host devices, in a
    subprocess; returns {case name: {key: array}}."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(ORACLE),
                        json.dumps(cases), str(out_dir)],
                       capture_output=True, text=True, env=env, timeout=1200)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return {c["name"]: dict(np.load(os.path.join(out_dir,
                                                 c["name"] + ".npz")))
            for c in cases}


_WEIGHTS: dict = {}


def weights(arch, f64=False):
    """The reduced config (port and reference), the reference's weights
    (numpy) and its train batch, made once a process; ``f64``: drawn in
    float64 (x64 on only while they are drawn)."""
    if (arch, f64) not in _WEIGHTS:
        over = {**OVER.get(arch, {}), **(F64 if f64 else {})}
        jcfg = jconfigs.get_reduced(arch).scaled(**over)
        tcfg = tconfigs.get_reduced(arch).scaled(**over)
        jax.config.update("jax_enable_x64", f64)
        try:
            params = jax.tree.map(np.asarray, jmodel.init_model(
                jax.random.PRNGKey(0), jcfg))
        finally:
            jax.config.update("jax_enable_x64", False)
        _WEIGHTS[arch, f64] = (jcfg, tcfg, params, jmake_batch(jcfg, B, S))
    return _WEIGHTS[arch, f64]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def sharded_step(case):
    """One sharded train step from the reference's weights: (params,
    optimizer state, metrics), the trees unsharded and flattened."""
    _, tcfg, params, batch = weights(case["arch"], case["x64"])
    mesh = _mesh(tuple(case["mesh"]))
    fn, specs = step_lib.make_train_step(
        tcfg, mesh=mesh, layout=case["layout"], batch_size=B, seq_len=S,
        lr_fn=constant(LR), grad_wire=case["wire"],
        sequence_parallel=case["sp"])
    ps = convert.shard_params(convert.train_from_jax(params, tcfg,
                                                     device="cpu"),
                              mesh, specs.params_sh)
    opt = make_optimizer(tcfg, constant(LR))
    st = [opt.init(p) for p in ps]
    ps, st, m = fn(ps, st, _torch_batch(batch))
    return (dict(flatten_with_path(convert.unshard(ps, mesh,
                                                   specs.params_sh))),
            dict(flatten_with_path(convert.unshard(st, mesh,
                                                   specs.opt_state_sh))),
            {k: float(v) for k, v in m.items()})


def one_device_step(arch, f64=False):
    """The port's one-device train step on the same weights and batch."""
    _, tcfg, params, batch = weights(arch, f64)
    fn, _ = step_lib.make_train_step(tcfg, batch_size=B, seq_len=S,
                                     lr_fn=constant(LR), grad_wire="none",
                                     device="cpu")
    p = convert.train_from_jax(params, tcfg, device="cpu")
    opt = make_optimizer(tcfg, constant(LR))
    p, st, m = fn(p, opt.init(p), _torch_batch(batch))
    return (dict(flatten_with_path(p)), dict(flatten_with_path(st)),
            {k: float(v) for k, v in m.items()})


def from_oracle(res):
    return ({k[2:]: v for k, v in res.items() if k.startswith("p/")},
            {k[2:]: v for k, v in res.items() if k.startswith("s/")},
            {k[2:]: float(v) for k, v in res.items() if k.startswith("m/")})


def check_train(case, oracle):
    """The sharded step against the reference's sharded step."""
    _, tcfg, _, _ = weights(case["arch"], case["x64"])
    _hold(sharded_step(case), from_oracle(oracle[case["name"]]),
          case["wire"], tcfg.optimizer == "adafactor", determined=True)


def check_train_one_device(case):
    """The sharded step (at no wire) against the one-device step."""
    _, tcfg, _, _ = weights(case["arch"], case["x64"])
    _hold(sharded_step({**case, "wire": "none"}),
          one_device_step(case["arch"], case["x64"]), "none",
          tcfg.optimizer == "adafactor", determined=True)


def serve_run(case, mesh_shape=None):
    """Prefill, then (a decoder) ``DECODE`` greedy steps, through the
    sharded serving steps from the reference's weights: the logits of
    each call and the tokens, teacher-forced by none."""
    jcfg, tcfg, params, _ = weights(case["arch"])
    max_len = PROMPT + DECODE
    prompt = {k: torch.from_numpy(v) for k, v in
              jmake_batch(jcfg, B, PROMPT).items()
              if k in ("tokens", "patch_embeds", "frames")}
    p = convert.from_jax(params, tcfg, device="cpu")
    if mesh_shape is None:
        pre = step_lib.make_prefill_step(tcfg, batch_size=B, seq_len=PROMPT)
        dec = step_lib.make_decode_step(tcfg, batch_size=B,
                                        cache_len=max_len)
        ps, caches = p, tmodel.init_caches(tcfg, B, max_len, device="cpu")
    else:
        mesh = _mesh(mesh_shape)
        pre = step_lib.make_prefill_step(tcfg, mesh=mesh, batch_size=B,
                                         seq_len=PROMPT,
                                         layout=case["layout"])
        dec = step_lib.make_decode_step(tcfg, mesh=mesh, batch_size=B,
                                        cache_len=max_len,
                                        layout=case["layout"])
        ps = convert.shard_params(p, mesh, dec.specs.params_sh, copy=False)
        caches = step_lib.init_sharded_caches(dec.specs, B, max_len)
    logits, caches = pre(ps, prompt, caches)
    out = {"logits0": logits}
    if tcfg.family != "audio":
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i in range(DECODE):
            tok, logits, caches = dec(ps, tok, caches)
            out[f"logits{i + 1}"] = logits
            out[f"tok{i + 1}"] = tok
    return out


def hold_serve(got, want):
    """Logits within ``SERVE_TOL`` of the largest, greedy tokens equal."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        if k.startswith("tok"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, err_msg=k,
                                       atol=SERVE_TOL * np.abs(w).max())


def check_serve(case, oracle):
    hold_serve(serve_run(case, tuple(case["mesh"])), oracle[case["name"]])


def check_serve_one_device(case):
    hold_serve(serve_run(case, tuple(case["mesh"])),
               {k: v.numpy() for k, v in serve_run(case).items()})


# ---------------------------------------------------------------------------
# recurrentgemma (n_layers=5: the RG-LRU, MQA local attention, the tail)
# ---------------------------------------------------------------------------
RG = "recurrentgemma_9b"
TRAIN = family_cases(RG) + [train_case(RG, "sp"),
                            train_case(RG, "tp", sp=True)]
SERVE = [serve_case(RG, "tp"), serve_case(RG, "sp")]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(TRAIN + SERVE, tmp_path_factory.mktemp("jax_families"))


@pytest.mark.parametrize("case", TRAIN, ids=[c["name"] for c in TRAIN])
def test_train_step_matches_jax_sharded_step(case, oracle):
    check_train(case, oracle)


@pytest.mark.parametrize("case", TRAIN, ids=[c["name"] for c in TRAIN])
def test_train_step_matches_one_device_step(case):
    check_train_one_device(case)


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_jax_sharded_steps(case, oracle):
    check_serve(case, oracle)


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_one_device_steps(case):
    check_serve_one_device(case)


# ---------------------------------------------------------------------------
# layouts, specs and caches
# ---------------------------------------------------------------------------
def test_tail_round_trips_through_shards():
    """The tail's leaves shard and unshard with the stack's (the training
    layout's ``tail/j`` leaves have no repeat axis)."""
    cfg = tconfigs.get_reduced(RG).scaled(**TAIL, fsdp=True)
    mesh = _mesh(MESH)
    _, specs = step_lib.make_train_step(cfg, mesh=mesh, batch_size=B,
                                        seq_len=S)
    p = convert.stack_params(tmodel.init_model(cfg, device="cpu"))
    assert len(p["tail"]) == 2
    ps = convert.shard_params(p, mesh, specs.params_sh)
    back = dict(flatten_with_path(convert.unshard(ps, mesh,
                                                  specs.params_sh)))
    for k, t in flatten_with_path(p):
        assert torch.equal(back[k], t), k
    w = ps[0]["tail"][1]["rec"]["w_r"]["w"]
    assert tuple(w.shape) == (128 // 4, 128 // 2)      # fsdp 4, tp 2


def test_rwkv6_compute_layout():
    """Under TP the channel mix's value map computes split on its d_ff
    rows (stored on its output columns, the reference's), and the time
    mix's per-head leaves are cut to the shard's heads; under SP nothing
    of the blocks splits."""
    cfg = tconfigs.get_reduced("rwkv6_3b")
    mesh = _mesh(MESH)
    pspecs = step_lib.param_specs(cfg)
    leaf = lambda x: isinstance(x, tuple)
    for layout, want in (("tp", {"cm/wv/w": (None, "model", None),
                                 "tm/u": (None, "model", None),
                                 "tm/w0": (None, "model"),
                                 "tm/td_w2": (None, None, "model")}),
                         ("sp", {"cm/wv/w": (None, None, None),
                                 "tm/u": (None, None, None)})):
        rules = step_lib.sharded_rules(cfg, mesh, batch_size=B,
                                       layout=layout)
        stored = dict(flatten_with_path(
            shr.step_param_specs(pspecs, cfg, mesh, rules), is_leaf=leaf))
        comp = dict(flatten_with_path(
            shr.step_param_specs(pspecs, cfg, mesh, rules, compute=True),
            is_leaf=leaf))
        for k, spec in want.items():
            assert comp["stack/sub0/" + k] == spec, (layout, k)
        if layout == "tp":
            assert stored["stack/sub0/cm/wv/w"] == (None, None, "model")
            assert stored["stack/sub0/tm/u"] == (None, None, None)


def test_caches_per_position():
    """TP: a position's caches hold its RG-LRU channels, its rwkv6 heads'
    WKV state and the whole shifted tokens; SP: every cache whole over
    the sequence axis."""
    mesh = _mesh(MESH)
    for arch, layout, want in (
            (RG, "tp", {"h": (2, 64), "conv": (2, 3, 64)}),
            (RG, "sp", {"h": (2, 128), "conv": (2, 3, 128)}),
            ("rwkv6_3b", "tp", {"S": (2, 2, 32, 32), "x_tm": (2, 128)}),
            ("rwkv6_3b", "sp", {"S": (2, 4, 32, 32), "x_cm": (2, 128)})):
        cfg = tconfigs.get_reduced(arch).scaled(**OVER.get(arch, {}))
        dec = step_lib.make_decode_step(cfg, mesh=mesh, batch_size=B,
                                        cache_len=24, layout=layout)
        cs = step_lib.init_sharded_caches(dec.specs, B, 24)
        st = cs[1]["stack"][0]["sub0"]
        for k, shape in want.items():
            assert tuple(st[k].shape) == shape, (arch, layout, k)
        if arch == RG:
            assert tuple(cs[1]["tail"][1]["h"].shape) == want["h"]
            kv = cs[1]["stack"][0]["sub2"]["k"]
            assert tuple(kv.shape) == (2, 24, 1, 32)


def test_sequence_that_does_not_split_raises():
    cfg = tconfigs.get_reduced("olmo_1b")
    mesh = _mesh(MESH)
    pre = step_lib.make_prefill_step(cfg, mesh=mesh, batch_size=B,
                                     seq_len=15, layout="sp")
    ps = convert.shard_params(tmodel.init_model(cfg, device="cpu"), mesh,
                              pre.specs.params_sh, copy=False)
    with pytest.raises(ValueError, match="sequence shards"):
        pre(ps, {"tokens": torch.zeros(B, 15, dtype=torch.int32)},
            step_lib.init_sharded_caches(pre.specs, B, 15))
