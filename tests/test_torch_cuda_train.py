"""The training path on the card.  Every test here is marked ``cuda`` and
skips without one; the file imports neither JAX nor the JAX package
(the CPU tests hold the port against JAX; these hold the card against
the CPU):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.optim import constant, make_optimizer
from repro_torch.tree import flatten_with_path, leaves, map_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", torch.cuda.current_device())


def _setup(arch, dev, **over):
    cfg = get_reduced(arch).scaled(**over)
    cpu = convert.stack_params(model_lib.init_model(cfg, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, 4, 32, seed=1).items()}
    return cfg, cpu, batch


@pytest.mark.parametrize("arch", ["olmo_1b", "rwkv6_3b", "kimi_k2_1t_a32b",
                                  "hubert_xlarge"])
def test_grads_on_card_match_cpu(dev, arch):
    """f32 compute: the loss and every gradient leaf on the card within
    the CPU's, to the JAX suite's remat bar (rtol 1e-4, atol 1e-5 of
    max(1, max|leaf|)).  MoE routing follows f32 router probabilities,
    so kimi's tokens route alike on both devices."""
    cfg, cpu, batch = _setup(arch, dev)
    on = map_tree(lambda t: t.to(dev), cpu)
    lc, _, gc_ = step_lib.value_and_grad(cpu, batch, cfg)
    lg, _, gg = step_lib.value_and_grad(
        on, {k: v.to(dev) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for (k, a), (_, b) in zip(flatten_with_path(gg), flatten_with_path(gc_)):
        assert a.device == dev
        b = b.numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(b).max()),
                                   err_msg=k)


def test_train_step_on_card_lowers_loss(dev):
    """bf16 compute, bf16 wire, remat: 15 steps on one batch lower the
    loss by more than 0.5 nats, every tensor staying on the card."""
    cfg, cpu, batch = _setup("olmo_1b", dev, compute_dtype="bfloat16")
    fn, _ = step_lib.make_train_step(cfg, batch_size=4, seq_len=32,
                                     lr_fn=constant(3e-3), device=dev)
    params = map_tree(lambda t: t.to(dev), cpu)
    st = make_optimizer(cfg, constant(3e-3)).init(params)
    assert st["count"].device == dev
    batch = {k: v.to(dev) for k, v in batch.items()}
    losses = []
    for _ in range(15):
        params, st, m = fn(params, st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    assert all(t.device == dev for t in leaves(params) + leaves(st))
    with pytest.raises(ValueError, match="built for"):
        fn(cpu, make_optimizer(cfg, constant(1e-3)).init(cpu), batch)
    with pytest.raises(ValueError, match="kernel"):
        step_lib.make_train_step(cfg.scaled(tina_lowering="kernel"),
                                 batch_size=4, seq_len=32, device=dev)


def test_async_save_while_next_step_runs(dev, tmp_path):
    """``save`` returns with a host copy of the state: the next (donated)
    step then updates the same CUDA storage while the file write runs,
    and the checkpoint holds the state as it was at ``save``."""
    cfg, cpu, batch = _setup("olmo_1b", dev)
    fn, specs = step_lib.make_train_step(cfg, batch_size=4, seq_len=32,
                                         lr_fn=constant(1e-2), device=dev)
    params = map_tree(lambda t: t.to(dev), cpu)
    st = make_optimizer(cfg, constant(1e-2)).init(params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    params, st, _ = fn(params, st, batch)
    want = map_tree(lambda t: t.cpu().clone(), {"params": params,
                                                "opt_state": st})
    ptrs = [t.data_ptr() for t in leaves(params)]
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"params": params, "opt_state": st})
    params, st, _ = fn(params, st, batch)          # in place, on the card
    assert [t.data_ptr() for t in leaves(params)] == ptrs
    out, meta = mgr.restore({"params": specs.params,
                             "opt_state": specs.opt_state}, device=dev)
    assert meta["step"] == 1
    for (k, a), (_, b) in zip(flatten_with_path(out),
                              flatten_with_path(want)):
        assert a.device == dev and torch.equal(a.cpu(), b), k
    assert int(out["opt_state"]["count"]) == 1 and int(st["count"]) == 2


# ---------------------------------------------------------------------------
# the sharded steps: logical shards of the card, and distinct cards
# ---------------------------------------------------------------------------
SHARDED = [("olmo_1b", {}), ("qwen2_7b", dict(fsdp=True)),
           ("kimi_k2_1t_a32b", dict(moe_dispatch="shard_map"))]
# the optimizer state's bar, of each leaf's largest: 1e-4 (f32 sums in
# other orders), but 2e-2 for the expert-parallel dispatch, whose combine
# rounds each shard's partial output to bf16 (the reference's): a partial
# summed in another f32 order on the card than on the CPU can round to
# the neighbouring bf16 value, 2^-8 of it, and a second moment squares it
STATE_TOL = {"olmo_1b": 1e-4, "qwen2_7b": 1e-4, "kimi_k2_1t_a32b": 2e-2}


def _sharded_step(cfg, cpu, batch, mesh, wire="none"):
    """One sharded step from the CPU params ``cpu`` on ``mesh``: the
    metrics and the global first moments / Adafactor factors on the
    CPU."""
    fn, specs = step_lib.make_train_step(cfg, mesh=mesh, batch_size=4,
                                         seq_len=32, lr_fn=constant(1e-3),
                                         grad_wire=wire)
    ps = convert.shard_params(cpu, mesh, specs.params_sh)
    opt = make_optimizer(cfg, constant(1e-3))
    st = [opt.init(p) for p in ps]
    _, st, m = fn(ps, st, batch)
    state = dict(flatten_with_path(convert.unshard(
        st, mesh, specs.opt_state_sh, device="cpu")))
    return {k: float(v) for k, v in m.items()}, state


def _hold_sharded(got, want, tol=1e-4):
    (gm, gs), (wm, ws) = got, want
    for k in ("loss", "grad_norm", "moe_aux_loss"):
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert gm["moe_drop_frac"] == wm["moe_drop_frac"]
    for k, w in ws.items():
        if w.ndim:
            np.testing.assert_allclose(gs[k].numpy(), w.numpy(), rtol=0,
                                       atol=tol * float(w.abs().max()),
                                       err_msg=k)


@pytest.mark.parametrize("arch,over", SHARDED, ids=[a for a, _ in SHARDED])
def test_sharded_step_on_logical_shards_of_the_card(dev, arch, over):
    """f32 compute: a (2, 2) mesh of logical shards of the card against
    the same mesh of CPU shards (the CPU tests hold those against the
    reference's sharded step): the metrics 1e-5, the optimizer state
    within ``STATE_TOL`` of each leaf's largest."""
    from repro_torch.launch.mesh import make_mesh
    cfg, cpu, batch = _setup(arch, dev, **over)
    got = _sharded_step(cfg, cpu, batch, make_mesh((2, 2), ("data", "model"),
                                                  dev))
    want = _sharded_step(cfg, cpu, batch, make_mesh((2, 2),
                                                    ("data", "model"), "cpu"))
    _hold_sharded(got, want, STATE_TOL[arch])


def test_collectives_autograd_on_the_card(dev):
    """The collectives on 4 logical shards of the card: the forward is
    the CPU's, bit for bit, and each backward is its forward's adjoint."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    cpu_mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(4, 6, generator=g) for _ in range(4)]
    for fn in (lambda v, m: coll.all_reduce(v, m, "model"),
               lambda v, m: coll.all_gather(v, m, "data", 1),
               lambda v, m: coll.reduce_scatter(v, m, "model", 0)):
        on = [x.to(dev).requires_grad_() for x in xs]
        out = fn(on, mesh)
        want = fn(xs, cpu_mesh)
        for o, w in zip(out, want):
            assert o.device == dev and torch.equal(o.cpu(), w)
        ws = [torch.randn(o.shape, generator=g).to(dev) for o in out]
        grads = torch.autograd.grad(out, on, ws)
        lhs = sum(float((o * w).sum()) for o, w in zip(out, ws))
        rhs = sum(float((x * gr).sum()) for x, gr in zip(on, grads))
        assert lhs == pytest.approx(rhs, rel=1e-5)


def test_sharded_serving_on_logical_shards_of_the_card(dev):
    """Reduced olmo at the kernel lowering on a (2, 2) mesh of the card,
    prepared shards: prefill and 3 decode steps within 1e-4 of the
    one-device steps' largest logit (f32 compute: the 3xTF32 GEMM on
    each shard's blocks), greedy tokens equal."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_reduced("olmo_1b").scaled(tina_lowering="kernel")
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    params = model_lib.init_model(cfg, seed=3, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    pre1 = step_lib.make_prefill_step(cfg, batch_size=4, seq_len=16)
    dec1 = step_lib.make_decode_step(cfg, batch_size=4, cache_len=19)
    pre = step_lib.make_prefill_step(cfg, mesh=mesh, batch_size=4,
                                     seq_len=16)
    dec = step_lib.make_decode_step(cfg, mesh=mesh, batch_size=4,
                                    cache_len=19)
    one = model_lib.prepare(params, cfg)
    ps = [model_lib.prepare(t, cfg) for t in convert.shard_params(
        params, mesh, dec.specs.params_sh, copy=False)]
    c1 = model_lib.init_caches(cfg, 4, 19, device=dev)
    cs = step_lib.init_sharded_caches(dec.specs, 4, 19)
    l1, c1 = pre1(one, {"tokens": tokens}, c1)
    ls, cs = pre(ps, {"tokens": tokens}, cs)
    tok = torch.argmax(l1, -1).to(torch.int32)
    for _ in range(3):
        assert torch.allclose(ls, l1, rtol=0,
                              atol=1e-4 * float(l1.abs().max()))
        t1, l1, c1 = dec1(one, tok, c1)
        ts, ls, cs = dec(ps, tok, cs)
        assert torch.equal(t1, ts)
        tok = t1


@pytest.mark.parametrize("wire", ["none", "bf16"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=["two_cards", "four_cards"])
def test_sharded_step_on_distinct_cards(dev, shape, wire):
    """A mesh of distinct cards (the NCCL route) against the same mesh of
    logical shards of one card: the metrics 1e-5; the optimizer state
    within 1e-4 of each leaf's largest at the none wire (f32 sums in
    NCCL's order), 2e-2 at the bf16 wire: NCCL sums a group of bf16
    gradients (four members for a leaf replicated over both axes) in its
    own order, each add rounded to bf16, so an element can move by an
    ulp, 2^-8 of it, which a second moment squares.  Skips without
    enough cards."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh
    n = shape[0] * shape[1]
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, {torch.cuda.device_count()} visible")
    for arch, over in SHARDED:
        cfg, cpu, batch = _setup(arch, dev, **over)
        mesh = make_mesh(shape, ("data", "model"))
        assert coll.mesh_routes(mesh, "model") == {"nccl"}
        got = _sharded_step(cfg, cpu, batch, mesh, wire=wire)
        want = _sharded_step(cfg, cpu, batch,
                             make_mesh(shape, ("data", "model"), dev),
                             wire=wire)
        _hold_sharded(got, want, 1e-4 if wire == "none" else 2e-2)


@pytest.mark.parametrize("layout", ["tp", "sp"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=["two_cards", "four_cards"])
def test_recurrentgemma_on_distinct_cards(dev, shape, layout):
    """Reduced recurrentgemma at 5 layers (the RG-LRU with its gathered
    conv output under TP or its carries along the sequence blocks under
    SP, MQA local attention, the tail) on distinct cards against the
    same mesh of logical shards of one card: the train step's metrics
    1e-5 and optimizer state 1e-4 of each leaf's largest (no wire), and
    prefill and 3 decode steps at the kernel lowering within 1e-4 of
    the largest logit, greedy tokens equal.  Skips without enough
    cards."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh
    n = shape[0] * shape[1]
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, {torch.cuda.device_count()} visible")
    cfg, cpu, batch = _setup("recurrentgemma_9b", dev, n_layers=5)
    cards = make_mesh(shape, ("data", "model"))
    logical = make_mesh(shape, ("data", "model"), dev)
    assert coll.mesh_routes(cards, "model") == {"nccl"}

    def step(mesh):
        fn, specs = step_lib.make_train_step(
            cfg, mesh=mesh, batch_size=4, seq_len=32, lr_fn=constant(1e-3),
            grad_wire="none", layout=layout)
        ps = convert.shard_params(cpu, mesh, specs.params_sh)
        opt = make_optimizer(cfg, constant(1e-3))
        _, st, m = fn(ps, [opt.init(p) for p in ps], batch)
        return ({k: float(v) for k, v in m.items()},
                dict(flatten_with_path(convert.unshard(
                    st, mesh, specs.opt_state_sh, device="cpu"))))
    _hold_sharded(step(cards), step(logical), 1e-4)

    kcfg = cfg.scaled(tina_lowering="kernel")
    params = model_lib.init_model(kcfg, seed=3, device=dev)
    tokens = torch.randint(0, kcfg.vocab_size, (4, 16), device=dev,
                           generator=torch.Generator(dev).manual_seed(0))

    def serve(mesh):
        pre = step_lib.make_prefill_step(kcfg, mesh=mesh, batch_size=4,
                                         seq_len=16, layout=layout)
        dec = step_lib.make_decode_step(kcfg, mesh=mesh, batch_size=4,
                                        cache_len=19, layout=layout)
        ps = [model_lib.prepare(t, kcfg) for t in convert.shard_params(
            params, mesh, dec.specs.params_sh, copy=False)]
        cs = step_lib.init_sharded_caches(dec.specs, 4, 19)
        lg, cs = pre(ps, {"tokens": tokens}, cs)
        out, tok = [lg], torch.argmax(lg, -1).to(torch.int32)
        for _ in range(3):
            tok, lg, cs = dec(ps, tok, cs)
            out += [lg, tok]
        return [t.cpu() for t in out]
    for got, want in zip(serve(cards), serve(logical)):
        if got.is_floating_point():
            assert torch.allclose(got, want, rtol=0,
                                  atol=1e-4 * float(want.abs().max()))
        else:
            assert torch.equal(got, want)
