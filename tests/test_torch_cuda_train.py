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
