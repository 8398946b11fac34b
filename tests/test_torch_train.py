"""The port's training path against the JAX package: the loss, its
gradients, remat, the train step and the data pipeline.

Weights come from the reference's ``init_model(PRNGKey(0), cfg)``,
carried into the training layout (each leaf of ``params["stack"]`` with
the repeat axis) by ``repro_torch.models.convert.train_from_jax``; the
batches are the reference's ``make_batch`` numpy arrays.  The whole JAX
train step (``repro.distributed.step.make_train_step``) fails on this
JAX in the reference's own suite (``ShardingTypeError``), so the oracle
for a step is composed from the reference's public functions, as
``tests/test_system.py::test_train_decreases_loss`` composes it:
``jax.value_and_grad(loss_fn)``, ``compress_bf16``, the microbatch
accumulation, ``clip_by_global_norm`` and ``make_optimizer(...).update``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as jopt
from repro.data import pipeline as jdata
from repro.models import model as jmodel
from repro.optim.compress import compress_bf16 as jcompress_bf16
from repro_torch import configs as tconfigs
from repro_torch import optim as topt
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.tree import flatten_with_path, map_tree

LOSS_RTOL = 1e-5
# tests/test_system.py's remat test: rtol 1e-4, atol 1e-5, the atol here
# taken of max(1, max |leaf|): rwkv6's tied table has gradients up to 14.3,
# where f32 sums through its WKV loop in another order differ by 2.7e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STEP_RTOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat}


def _tflat(tree):
    return dict(flatten_with_path(tree))


def _setup(arch, seed=0, **over):
    """(jax cfg, port cfg, jax params, port training-layout params)."""
    jcfg = jconfigs.get_reduced(arch).scaled(**over)
    tcfg = tconfigs.get_reduced(arch).scaled(**over)
    params = jmodel.init_model(jax.random.PRNGKey(seed), jcfg)
    tp = convert.train_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return jcfg, tcfg, params, tp


def _batches(cfg, b, s, seed=0):
    nb = jdata.make_batch(cfg, b, s, seed=seed)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _jgrads(params, batch, cfg):
    fn = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(p, batch, cfg),
                                    has_aux=True))
    return fn(params)


def _close_leaves(got: dict, want: dict, rtol, atol, floor=1e-30, what=""):
    """Leaf for leaf: |got - want| <= atol * max(floor, max|want|) + rtol
    * |want|."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k in sorted(want):
        g, w = _np(got[k]), _np(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol * max(floor, np.abs(w).max()),
            err_msg=f"{what} {k}")


def _close_grads(got: dict, want: dict, what=""):
    _close_leaves(got, want, GRAD_RTOL, GRAD_ATOL, floor=1.0, what=what)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
def test_ce_where_iota_matches_reference_and_take_along_axis():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 16, 64)).astype(np.float32)
    targets = rng.integers(0, 64, (4, 16)).astype(np.int32)
    mask = (rng.random((4, 16)) < 0.7).astype(np.float32)
    loss, denom = tmodel._ce(torch.from_numpy(logits),
                             torch.from_numpy(targets), torch.from_numpy(mask))
    jloss, jdenom = jmodel._ce(jnp.asarray(logits), jnp.asarray(targets),
                               jnp.asarray(mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(denom) == float(jdenom) == mask.sum()
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    gold = torch.take_along_dim(torch.from_numpy(logits),
                                torch.from_numpy(targets).long()[..., None],
                                -1)[..., 0]
    want = ((lse - gold) * torch.from_numpy(mask)).sum() / mask.sum()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_loss_and_grads_match_jax(arch):
    """loss_fn and its gradients at f32 compute (reduced config, remat as
    the config sets it) against ``jax.value_and_grad`` of the
    reference's: the loss within 1e-5 relative, every leaf of the
    training layout within rtol 1e-4 / atol 1e-5 (of max(1, max|leaf|)),
    the metrics too."""
    jcfg, tcfg, params, tp = _setup(arch)
    jb, tb = _batches(jcfg, 2, 32, seed=1)
    (jtotal, jm), jg = _jgrads(params, jb, jcfg)
    total, m, g = step_lib.value_and_grad(tp, tb, tcfg)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    for k in ("loss", "tokens", "moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    _close_grads(_tflat(g), _jflat(jg), what=f"{arch} grads")
    # the layout: every stacked leaf carries the repeat axis
    reps = tcfg.n_layers // len(tcfg.block_pattern)
    assert all(t.shape[0] == reps for k, t in _tflat(tp).items()
               if k.startswith("stack/"))


def test_sqrt_remat_grads_match_flat():
    """sqrt-remat (remat_group=2 over 5 superblocks: 2 groups and a
    remainder) is a memory schedule only: its loss and gradients equal
    flat per-superblock remat's in the port (1e-4 / 1e-5), and JAX's
    sqrt-remat gradients."""
    jcfg, tcfg, params, tp = _setup("olmo_1b", n_layers=5)
    jb, tb = _batches(jcfg, 2, 16)
    _, _, g_flat = step_lib.value_and_grad(tp, tb, tcfg)
    segs = tmodel._remat_segments(tcfg.scaled(remat_group=2), 5, True)
    assert [(list(r), c) for r, c in segs] == [([0, 1], True),
                                               ([2, 3], True), ([4], True)]
    total, _, g_sqrt = step_lib.value_and_grad(tp, tb,
                                               tcfg.scaled(remat_group=2))
    _close_grads(_tflat(g_sqrt), _tflat(g_flat), what="port sqrt vs flat")
    (jtotal, _), jg = _jgrads(params, jb, jcfg.scaled(remat_group=2))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    _close_grads(_tflat(g_sqrt), _jflat(jg), what="sqrt vs JAX")


def test_remat_recomputes_in_backward():
    """With remat the forward saves each superblock's input alone: the
    blocks run again during the backward (counted), and the gradients
    equal those of the run without remat."""
    _, tcfg, _, tp = _setup("olmo_1b", n_layers=2)
    _, tb = _batches(tcfg, 2, 16)
    calls = {"n": 0}
    orig = tmodel.apply_block

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    tmodel.apply_block = counting
    try:
        out = {}
        for remat in (False, True):
            calls["n"] = 0
            out[remat] = step_lib.value_and_grad(tp, tb,
                                                 tcfg.scaled(remat=remat))
            out[remat] += (calls["n"],)
    finally:
        tmodel.apply_block = orig
    assert out[False][3] == 2 and out[True][3] == 4
    _close_leaves(_tflat(out[True][2]), _tflat(out[False][2]), 0, 0,
                  what="remat vs none")


# ---------------------------------------------------------------------------
# the train step against the composed JAX step
# ---------------------------------------------------------------------------
def _jax_step(params, opt_state, batch, cfg, opt, grad_wire, k):
    """The reference's train step body, composed from its public
    functions (its jitted ``make_train_step`` fails on this JAX)."""
    def grads_of(b):
        (_, m), g = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, b, cfg), has_aux=True)(params)
        if grad_wire == "bf16":
            g = jcompress_bf16(g)
        return g, m

    wires = []
    if k > 1:
        n = next(iter(batch.values())).shape[0] // k
        g_acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             params)
        m_acc = None
        for i in range(k):
            g, m = grads_of({kk: v[i * n:(i + 1) * n]
                             for kk, v in batch.items()})
            g_acc = jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                 g_acc, g)
            m_acc = m if m_acc is None else jax.tree.map(jnp.add, m_acc, m)
            wires.append(g)
        grads = jax.tree.map(lambda g: g / k, g_acc)
        metrics = jax.tree.map(lambda m: m / k, m_acc)
    else:
        grads, metrics = grads_of(batch)
        wires.append(grads)
    grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
    grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
    new_p, new_opt = opt.update(grads, opt_state, params)
    return new_p, new_opt, {**metrics, "grad_norm": gnorm}, wires


def _bf16_ulp(x):
    """One bf16 ulp at each element of |x| (the spacing of bf16 values
    there; 2^-133 below the normal range)."""
    a = np.abs(_np(x)).astype(np.float64)
    e = np.floor(np.log2(np.maximum(a, 2.0 ** -126)))
    return 2.0 ** (e - 7)


STEP_CASES = [("olmo_1b", "none", 1), ("olmo_1b", "bf16", 1),
              ("olmo_1b", "none", 2), ("olmo_1b", "bf16", 2),
              ("rwkv6_3b", "none", 1), ("kimi_k2_1t_a32b", "none", 1)]


def _port_wire_grads(tp, tb, cfg, wire, k) -> list[dict]:
    """The gradients of each of a train step's k slices after the wire,
    recomposed from the port's ``value_and_grad``."""
    n = next(iter(tb.values())).shape[0] // k
    out = []
    for i in range(k):
        _, _, g = step_lib.value_and_grad(
            tp, {key: v[i * n:(i + 1) * n] for key, v in tb.items()}, cfg)
        out.append({name: (t.to(torch.bfloat16) if wire == "bf16" else t)
                    for name, t in _tflat(g).items()})
    return out


@pytest.mark.parametrize("arch,wire,k", STEP_CASES)
def test_train_step_matches_composed_jax_step(arch, wire, k):
    """One ``train_step`` (rwkv6: AdamW on its stacked norm scales, biases
    and mixes; kimi: Adafactor) against the composed JAX step.

    - metrics within 1e-5 of the JAX step's (the gradients' norm within
      the gradient bar, 1e-4);
    - the gradients the step clips within the gradient bar of the JAX
      step's (1e-4 / 1e-5), at the bf16 wire plus one bf16 ulp (two f32
      gradients that close may round a ulp apart);
    - params and optimizer state within 1e-5 (of each leaf's max) of the
      reference's accumulation, clip and update applied to those
      gradients.  (Not of the JAX step's own: AdamW's first step divides
      g by |g| + 1e-8, so where |g| is near 1e-8 the gradients' rounding
      moves a parameter by up to lr * 1e-2.)"""
    jcfg, tcfg, params, tp = _setup(arch)
    jb, tb = _batches(jcfg, 4, 16, seed=2)
    lr = 1e-3
    jo = jopt.make_optimizer(jcfg, jopt.warmup_cosine(lr, 2, 10))
    fn, specs = step_lib.make_train_step(
        tcfg, batch_size=4, seq_len=16, lr_fn=topt.warmup_cosine(lr, 2, 10),
        grad_wire=wire, microbatch=k, device="cpu")
    to = topt.make_optimizer(tcfg, topt.warmup_cosine(lr, 2, 10))
    tst = to.init(tp)
    assert {n: tuple(t.shape) for n, t in _tflat(specs.params).items()} == \
        {n: tuple(t.shape) for n, t in _tflat(tp).items()}
    assert {n: tuple(t.shape) for n, t in _tflat(specs.opt_state).items()} \
        == {n: tuple(t.shape) for n, t in _tflat(tst).items()}

    port_wires = _port_wire_grads(tp, tb, tcfg, wire, k)
    _, _, jm, jwires = _jax_step(params, jo.init(params), jb, jcfg, jo,
                                      wire, k)
    for port_wire, jwire in zip(port_wires, jwires):
        for n, w in _jflat(jwire).items():
            # at the bf16 wire: one bf16 ulp on top of the f32 gradient
            # bar (two f32 gradients that close may round a ulp apart)
            ulp = _bf16_ulp(w) if wire == "bf16" else 0.0
            w = _np(w)
            d = np.abs(_np(port_wire[n]) - w)
            bar = ulp + GRAD_ATOL * max(1.0, np.abs(w).max()) \
                + GRAD_RTOL * np.abs(w)
            assert (d <= bar * (1 + 1e-6)).all(), (n, float((d - bar).max()))
    # the reference's accumulation, clip and update of the port's slices
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    for port_wire in port_wires:
        pw = _unflat_like(params, {n: _np(t) for n, t in port_wire.items()})
        acc = jax.tree.map(lambda a, b: a + jnp.asarray(b), acc, pw)
    clipped, _ = jopt.clip_by_global_norm(jax.tree.map(lambda g: g / k, acc),
                                          1.0)
    jp_own, jst_own = jo.update(clipped, jo.init(params), params)

    tp2, tst2, m = fn(tp, tst, tb)
    for key in ("loss", "tokens", "moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=key)
    # the norm of gradients held to the gradient bar
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_RTOL)
    what = f"{arch} {wire} k={k}"
    _close_leaves(_tflat(tp2), _jflat(jp_own), STEP_RTOL, STEP_RTOL,
                  what=f"{what} params")
    _close_leaves(_tflat(tst2), _jflat(jst_own), STEP_RTOL, STEP_RTOL,
                  what=f"{what} state")


def _unflat_like(tree, flat: dict):
    """``tree`` (a JAX tree) with its leaves replaced by ``flat[key]``."""
    leaves_p, treedef = jax.tree_util.tree_flatten_with_path(tree)
    keys = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in leaves_p]
    return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])


def test_train_step_donates_and_copies():
    """``donate=True`` updates the given tensors in place and returns
    them; ``donate=False`` leaves them as they were."""
    _, tcfg, _, tp = _setup("olmo_1b", n_layers=2)
    _, tb = _batches(tcfg, 2, 16)
    opt = topt.make_optimizer(tcfg, topt.constant(1e-3))
    for donate in (True, False):
        fn, _ = step_lib.make_train_step(tcfg, batch_size=2, seq_len=16,
                                         lr_fn=topt.constant(1e-3),
                                         donate=donate, device="cpu")
        params = map_tree(torch.clone, tp)
        before = {n: t.clone() for n, t in _tflat(params).items()}
        st = opt.init(params)
        p2, st2, _ = fn(params, st, tb)
        same = all(a is b for a, b in zip(_tflat(p2).values(),
                                          _tflat(params).values()))
        moved = any(not torch.equal(t, before[n])
                    for n, t in _tflat(params).items())
        assert same == donate and moved == donate, donate
        assert int(st2["count"]) == 1 and int(st["count"]) == int(donate)


def test_train_decreases_loss():
    """The twin of ``tests/test_system.py::test_train_decreases_loss``:
    20 steps of the port's loss gradients and AdamW at 3e-3 on one batch
    lower the loss by more than 0.5 nats, tracking the reference's."""
    jcfg, tcfg, params, tp = _setup("olmo_1b", n_layers=2, remat=False)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    opt = topt.adamw(topt.constant(3e-3))
    st = opt.init(tp)
    losses = []
    for _ in range(20):
        _, m, g = step_lib.value_and_grad(
            tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
        tp, st = opt.update(g, st, tp)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    jo = jopt.adamw(jopt.constant(3e-3))
    jst = jo.init(params)
    jb = {"tokens": jnp.asarray(tokens)}
    step = jax.jit(lambda p, s: _jloss_step(p, s, jb, jcfg, jo))
    jl = []
    for _ in range(20):
        params, jst, loss = step(params, jst)
        jl.append(float(loss))
    np.testing.assert_allclose(losses[:5], jl[:5], rtol=1e-4)


def _jloss_step(p, s, batch, cfg, opt):
    (l, _), g = jax.value_and_grad(
        lambda q: jmodel.loss_fn(q, batch, cfg), has_aux=True)(p)
    p2, s2 = opt.update(g, s, p)
    return p2, s2, l


# ---------------------------------------------------------------------------
# what the train step refuses
# ---------------------------------------------------------------------------
def test_kernel_lowering_refused():
    cfg = tconfigs.get_reduced("olmo_1b").scaled(tina_lowering="kernel")
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="kernel"):
            step_lib.make_train_step(cfg, batch_size=2, seq_len=8,
                                     device=device)


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_7b", "rwkv6_3b"])
def test_prepared_params_refused(arch):
    """``prepare``'s serving copies (the linears' ``wt``, the untied
    head's rounded ``wr``) go stale after an update: refused.  rwkv6's
    receptance linears (dicts named ``wr``) are parameters: accepted."""
    cfg = tconfigs.get_reduced(arch).scaled(compute_dtype="bfloat16")
    fn, _ = step_lib.make_train_step(cfg, batch_size=2, seq_len=8,
                                     device="cpu")
    raw = tmodel.init_model(cfg, device="cpu")
    tp = convert.stack_params(raw)
    opt = topt.make_optimizer(cfg, topt.constant(1e-3))
    batch = {k: torch.from_numpy(v)
             for k, v in tdata.make_batch(cfg, 2, 8).items()}
    prepared = convert.stack_params(tmodel.prepare(raw, cfg))
    with pytest.raises(ValueError, match="serving copies"):
        fn(prepared, opt.init(prepared), batch)
    if arch == "rwkv6_3b":
        assert "wr" in tp["stack"]["sub0"]["tm"]
    _, _, m = fn(tp, opt.init(tp), batch)
    assert np.isfinite(float(m["loss"]))


def test_params_on_another_device_refused():
    cfg = tconfigs.get_reduced("olmo_1b")
    fn, specs = step_lib.make_train_step(cfg, batch_size=2, seq_len=8,
                                         device="cpu")
    opt = topt.make_optimizer(cfg, topt.constant(1e-3))
    with pytest.raises(ValueError, match="built for cpu"):
        fn(specs.params, opt.init(specs.params), {})


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmo_1b", "internvl2_2b", "hubert_xlarge"])
def test_input_specs_match_batches(arch):
    cfg = tconfigs.get_reduced(arch)
    specs = tdata.input_specs(cfg, 2, 32)
    batch = tdata.make_batch(cfg, 2, 32)
    jspecs = jdata.input_specs(jconfigs.get_reduced(arch), 2, 32)
    assert set(specs) == set(batch) == set(jspecs)
    for k in specs:
        assert specs[k].device.type == "meta"
        assert tuple(specs[k].shape) == batch[k].shape == jspecs[k].shape
        assert torch.from_numpy(batch[k]).dtype == specs[k].dtype, k
        assert np.dtype(jspecs[k].dtype) == batch[k].dtype


def test_input_specs_no_allocation():
    cfg = tconfigs.get("qwen2_7b")
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    specs = tdata.input_specs(cfg, 256, 4096)   # 1M tokens
    assert all(t.device.type == "meta" for t in specs.values())
    assert tuple(specs["tokens"].shape) == (256, 4096)
    # the full model's parameters and optimizer state too: 7.6e9 floats
    pspecs = step_lib.param_specs(cfg)
    n = sum(t.numel() for t in _tflat(pspecs).values())
    assert n > 7e9 and all(t.device.type == "meta"
                           for t in _tflat(pspecs).values())
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


def test_data_pipeline_restart_deterministic():
    """The twin of ``tests/test_runtime.py``'s: a step's batch is a pure
    function of (seed, process index, step), and the reference's."""
    cfg = tconfigs.get_reduced("olmo_1b")
    d1 = tdata.SyntheticDataset(cfg, 2, 16, seed=3)
    d2 = tdata.SyntheticDataset(cfg, 2, 16, seed=3)
    np.testing.assert_array_equal(d1[5]["tokens"], d2[5]["tokens"])
    assert not np.array_equal(d1[5]["tokens"], d1[6]["tokens"])
    d3 = tdata.SyntheticDataset(cfg, 2, 16, seed=3, process_index=1)
    assert not np.array_equal(d1[5]["tokens"], d3[5]["tokens"])
    for arch in ("olmo_1b", "hubert_xlarge"):
        j = jdata.SyntheticDataset(jconfigs.get_reduced(arch), 2, 16, seed=3,
                                   process_index=1)
        t = tdata.SyntheticDataset(tconfigs.get_reduced(arch), 2, 16, seed=3,
                                   process_index=1)
        for step in (0, 7):
            for k, v in j[step].items():
                np.testing.assert_array_equal(t[step][k], v)


def test_prefetch_keeps_order_and_bounds_depth():
    made = []

    def source():
        for i in range(20):
            made.append(i)
            yield i

    it = tdata.prefetch(source(), depth=2)
    assert next(it) == 0
    deadline = time.monotonic() + 5
    while len(made) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    # consumed 1; the queue holds at most 2 and the worker blocks on a
    # third: never more than 4 made
    assert len(made) <= 4, made
    assert list(it) == list(range(1, 20))
    assert threading.active_count() >= 1
