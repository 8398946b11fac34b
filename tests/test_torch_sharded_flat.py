"""The port's sharded LM steps where the tensor-parallel degree does not
divide the heads (qwen2's 28 heads, arctic's 56 and rwkv6's 40 on the
production meshes' 16-way TP): the reference splits the flat ``h * hd``
columns (``repro.distributed.sharding``), the port keeps those flat
blocks and moves q (rwkv6: r, k, v, g) onto each position's whole heads,
ceil(h / n) a position, and the heads' output back onto ``wo``'s rows
(``repro_torch.models.sharded``).

Reduced qwen2_7b, arctic_480b and rwkv6_3b on logical CPU shards:

* (data 1, model 8): their 4 heads of 32, half a head of flat columns a
  position; positions 0-3 hold a head each, 4-7 none;
* (data 2, model 4) at ``d_model=192, n_heads=6, n_kv_heads=2`` (rwkv6:
  6 heads of 32): 1.5 heads of columns a position, 2 heads a position
  (the last none), and position 1's query heads 2 and 3 read KV heads 0
  and 1 (a KV head straddled by a position's heads).

Each runs the train step (bf16 wire, and Megatron-SP at no wire),
prefill and decode against the reference's sharded steps on the same
weights (``tests/test_torch_sharded_families.py``'s oracle: 8 forced
host devices in a subprocess, ``Auto`` mesh axes), and the train step
(no wire) and serving against the port's own one-device steps, at the
bars of ``tests/test_torch_sharded.py`` (``_hold``, AdamW's step where
the state bar determines it) and serving logits within 1e-4 of their
largest, greedy tokens equal.  rwkv6 trains at no wire in float64, as
``tests/test_torch_sharded_families_rwkv.py`` does (its f32 step moves
by ~1e-4 under any reordering of its sums).

rwkv6's Megatron-SP step at no wire is held against the port's own
one-device step, not the reference's: its WKV state and decay are f32
in both packages also under float64 (``.float()``, ``jnp.float32``), so
the two packages' unsharded arithmetic differs there by more than the
grad-norm bar (1e-5): the reference's steps give 26.105444 at (1, 8) and
26.10558 on (1, 2), (1, 4) and (8, 1); the port's one-device and
sharded steps 26.105831 (1.48e-5 from the reference's (1, 8)); at the
(2, 4) widths the reference gives 70.63481 on every mesh, the port
70.63338 one-device and sharded (2.0e-5).  The sharding itself moves the
port's grad norm by 7e-8 and 2e-7 (ROADMAP.md queue 3).  Against the
reference rwkv6's Megatron-SP step runs at the bf16 wire.
"""
import numpy as np
import pytest
import torch

import jax
from repro import configs as jconfigs
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.optim import constant, make_optimizer
from repro_torch.tree import flatten_with_path

# one_thread: the autouse fixture, imported so that it runs here too
from test_torch_sharded import B, DECODE, LR, PROMPT, S, _hold, _mesh, \
    one_thread
from test_torch_sharded_families import F64, hold_serve, run_oracle

ARCHS = ("qwen2_7b", "arctic_480b", "rwkv6_3b")
WIDE = dict(d_model=192, n_heads=6, n_kv_heads=2)
MESHES = {(1, 8): {}, (2, 4): WIDE}


def _tag(shape):
    return "x".join(map(str, shape))


def train_case(arch, shape, wire, sp=False, f64=False):
    return dict(kind="train", arch=arch,
                over={**MESHES[shape], **(F64 if f64 else {})},
                mesh=shape, layout="tp", wire=wire, sp=sp, x64=f64,
                name=f"train-{arch}-{_tag(shape)}{'+sp' if sp else ''}-"
                     f"{wire}{'-f64' if f64 else ''}")


def serve_case(arch, shape):
    return dict(kind="serve", arch=arch, over=MESHES[shape], mesh=shape,
                layout="tp", name=f"serve-{arch}-{_tag(shape)}")


def _f64(arch):
    return arch == "rwkv6_3b"


TRAIN = [c for a in ARCHS for m in MESHES for c in (
    train_case(a, m, "bf16"),
    train_case(a, m, "bf16" if _f64(a) else "none", sp=True))]
ONE_DEVICE = [train_case(a, m, "none", sp=sp, f64=_f64(a)) for a in ARCHS
              for m in MESHES for sp in (False, True)]
SERVE = [serve_case(a, m) for a in ARCHS for m in MESHES]

_WEIGHTS: dict = {}


def weights(case):
    """The reduced config (port and reference) at the case's widths, the
    reference's weights (numpy) and its train batch."""
    key = (case["arch"], tuple(sorted(case["over"].items())))
    if key not in _WEIGHTS:
        jcfg = jconfigs.get_reduced(case["arch"]).scaled(**case["over"])
        tcfg = tconfigs.get_reduced(case["arch"]).scaled(**case["over"])
        jax.config.update("jax_enable_x64", bool(case.get("x64")))
        try:
            params = jax.tree.map(np.asarray, jmodel.init_model(
                jax.random.PRNGKey(0), jcfg))
        finally:
            jax.config.update("jax_enable_x64", False)
        _WEIGHTS[key] = (jcfg, tcfg, params, jmake_batch(jcfg, B, S))
    return _WEIGHTS[key]


def _batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree):
    return dict(flatten_with_path(tree))


def train_step(case, mesh_shape=None):
    """One train step from the reference's weights, sharded on
    ``mesh_shape`` (None: one device): (params, state, metrics)."""
    _, tcfg, params, batch = weights(case)
    p = convert.train_from_jax(params, tcfg, device="cpu")
    opt = make_optimizer(tcfg, constant(LR))
    if mesh_shape is None:
        fn, _ = step_lib.make_train_step(tcfg, batch_size=B, seq_len=S,
                                         lr_fn=constant(LR),
                                         grad_wire="none", device="cpu")
        p, st, m = fn(p, opt.init(p), _batch(batch))
        return _flat(p), _flat(st), {k: float(v) for k, v in m.items()}
    mesh = _mesh(mesh_shape)
    fn, specs = step_lib.make_train_step(
        tcfg, mesh=mesh, batch_size=B, seq_len=S, lr_fn=constant(LR),
        grad_wire=case["wire"], sequence_parallel=case["sp"])
    assert specs.layout.flat
    ps = convert.shard_params(p, mesh, specs.params_sh)
    ps, st, m = fn(ps, [opt.init(x) for x in ps], _batch(batch))
    return (_flat(convert.unshard(ps, mesh, specs.params_sh)),
            _flat(convert.unshard(st, mesh, specs.opt_state_sh)),
            {k: float(v) for k, v in m.items()})


def serve_run(case, mesh_shape=None):
    """Prefill and ``DECODE`` greedy steps from the reference's weights:
    each call's logits and the tokens."""
    jcfg, tcfg, params, _ = weights(case)
    max_len = PROMPT + DECODE
    p = convert.from_jax(params, tcfg, device="cpu")
    kw = {} if mesh_shape is None else {"mesh": _mesh(mesh_shape)}
    pre = step_lib.make_prefill_step(tcfg, batch_size=B, seq_len=PROMPT,
                                     **kw)
    dec = step_lib.make_decode_step(tcfg, batch_size=B, cache_len=max_len,
                                    **kw)
    if mesh_shape is None:
        ps, caches = p, tmodel.init_caches(tcfg, B, max_len, device="cpu")
    else:
        assert dec.specs.layout.flat
        ps = convert.shard_params(p, kw["mesh"], dec.specs.params_sh,
                                  copy=False)
        caches = step_lib.init_sharded_caches(dec.specs, B, max_len)
    tokens = torch.from_numpy(jmake_batch(jcfg, B, PROMPT)["tokens"])
    logits, caches = pre(ps, {"tokens": tokens}, caches)
    out = {"logits0": logits}
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(DECODE):
        tok, logits, caches = dec(ps, tok, caches)
        out[f"logits{i + 1}"] = logits
        out[f"tok{i + 1}"] = tok
    return out


def _from_oracle(res):
    return ({k[2:]: v for k, v in res.items() if k.startswith("p/")},
            {k[2:]: v for k, v in res.items() if k.startswith("s/")},
            {k[2:]: float(v) for k, v in res.items() if k.startswith("m/")})


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(TRAIN + SERVE, tmp_path_factory.mktemp("jax_flat"))


def _adafactor(case):
    return weights(case)[1].optimizer == "adafactor"


@pytest.mark.parametrize("case", TRAIN, ids=[c["name"] for c in TRAIN])
def test_train_step_matches_jax_sharded_step(case, oracle):
    _hold(train_step(case, tuple(case["mesh"])),
          _from_oracle(oracle[case["name"]]), case["wire"],
          _adafactor(case), determined=True)


@pytest.mark.parametrize("case", ONE_DEVICE,
                         ids=[c["name"] for c in ONE_DEVICE])
def test_train_step_matches_one_device_step(case):
    _hold(train_step(case, tuple(case["mesh"])), train_step(case), "none",
          _adafactor(case), determined=True)


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_jax_sharded_steps(case, oracle):
    hold_serve(serve_run(case, tuple(case["mesh"])), oracle[case["name"]])


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_one_device_steps(case):
    hold_serve(serve_run(case, tuple(case["mesh"])),
               {k: v.numpy() for k, v in serve_run(case).items()})


# ---------------------------------------------------------------------------
# MoE routes under the flat split: chip_smoke's bar on tokens routed
# otherwise than on one device
# ---------------------------------------------------------------------------
FLIP_SHARE = 0.1       # chip_smoke.SHARD_FLIP_SHARE


def _routes(monkeypatch, moe_lib, sharded_lib):
    """Each MoE block's experts and kept slots per token, in call order
    (a sharded block's: its first position's experts, the slots any
    expert shard kept)."""
    log = []
    one, many = moe_lib.moe_block, sharded_lib.moe_block

    def one_block(p, x, cfg):
        y, aux = one(p, x, cfg)
        log.append((aux["moe_experts"], aux["moe_kept"]))
        return y, aux

    def sharded_block(L, ps, zs):
        ys, aux = many(L, ps, zs)
        kept = aux["moe_kept"][0]
        for k in aux["moe_kept"][1:]:
            kept = kept | k
        log.append((aux["moe_experts"][0], kept))
        return ys, aux
    monkeypatch.setattr(moe_lib, "moe_block", one_block)
    monkeypatch.setattr(sharded_lib, "moe_block", sharded_block)
    return log


@pytest.mark.parametrize("broken", [None, "zeroed", "swapped"])
def test_moe_routes_flip_only_at_near_ties(broken, monkeypatch):
    """Reduced arctic at 128 experts, 6 heads (one a position) on (1, 8)
    at ``shard_map`` EP, bf16 compute, 8 x 64 then 4 teacher-forced
    steps: the sharded steps route 18 of 544 tokens (3.3 %) otherwise
    than one device, near ties flipped by the bf16 partial sums' order,
    within ``FLIP_SHARE``; a broken flat split, position 0's heads zeroed
    before ``wo`` or positions 0 and 1's heads swapped, flips 85 % and
    98 %, past it."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import sharded as sharded_lib
    cfg = tconfigs.get_reduced("arctic_480b").scaled(
        n_experts=128, n_layers=1, d_model=192, n_heads=6, n_kv_heads=6,
        compute_dtype="bfloat16", param_dtype="bfloat16",
        moe_dispatch="shard_map", tina_lowering="kernel")
    b, s, steps = 8, 64, 4
    mesh = make_mesh((1, 8), ("data", "model"), "cpu")
    params = tmodel.init_model(cfg, generator=torch.Generator().manual_seed(1))
    batch = {k: torch.as_tensor(v)
             for k, v in make_batch(cfg, b, s, seed=1).items()}
    pre = step_lib.make_prefill_step(cfg, mesh=mesh, batch_size=b,
                                     seq_len=s)
    dec = step_lib.make_decode_step(cfg, mesh=mesh, batch_size=b,
                                    cache_len=s + steps)
    assert dec.specs.layout.flat
    log = _routes(monkeypatch, moe_lib, sharded_lib)

    def run(pre_, dec_, p, caches, toks=None):
        lg, caches = pre_(p, batch, caches)
        picked = [torch.argmax(lg, -1).to(torch.int32)]
        for i in range(steps):
            tok, _, caches = dec_(p, picked[-1] if toks is None else toks[i],
                                  caches)
            picked.append(tok)
        return picked
    toks = run(step_lib.make_prefill_step(cfg, batch_size=b, seq_len=s),
               step_lib.make_decode_step(cfg, batch_size=b,
                                         cache_len=s + steps),
               tmodel.prepare(params, cfg),
               tmodel.init_caches(cfg, b, s + steps, device="cpu"))
    want, log[:] = list(log), []
    to_flat = sharded_lib._to_flat

    def broken_to_flat(L, xs, hs):
        xs = list(xs)
        if broken == "zeroed":
            xs[0] = torch.zeros_like(xs[0])
        else:
            xs[0], xs[1] = xs[1], xs[0]
        return to_flat(L, xs, hs)
    if broken:
        monkeypatch.setattr(sharded_lib, "_to_flat", broken_to_flat)
    shards = [tmodel.prepare(t, cfg) for t in convert.shard_params(
        params, mesh, dec.specs.params_sh, copy=False)]
    run(pre, dec, shards, step_lib.init_sharded_caches(dec.specs, b,
                                                       s + steps), toks[:-1])
    assert len(log) == len(want) == steps + 1
    alike = torch.cat([((ea == eb).all(-1) & (ka == kb).all(-1))
                       for (ea, ka), (eb, kb) in zip(want, log)])
    share = 1 - alike.float().mean().item()
    assert alike.numel() == b * s + steps * b
    if broken is None:
        assert share <= FLIP_SHARE, share
    else:
        assert share > FLIP_SHARE, share
