"""Elastic re-meshing (``repro_torch.runtime.elastic.elastic_restore``)
and sharded checkpoints on logical CPU shards.

A sharded tree is saved as its global arrays (the reference's format),
so it restores onto any mesh: saved on (data 4, model 2), restored on
(2, 4) bit for bit, and a step taken there equals the step the (4, 2)
mesh takes from the same state (1e-5 relative in the metrics, the
bars of ``tests/test_torch_sharded.py`` at the none wire in the state).
A checkpoint the JAX package's own ``CheckpointManager`` writes restores
onto (2, 4) bit for bit and trains.  The Trainer over a mesh resumes on
another mesh.
"""
import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import optim as jopt
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, load_manifest
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import step as step_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.optim import constant, make_optimizer
from repro_torch.runtime import Trainer, TrainerConfig, elastic_restore
from repro_torch.tree import flatten_with_path

B, S, LR = 8, 32, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and a pool of threads per test worker only spins against the other
    workers' pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), "cpu")


def _bits(t):
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _step(cfg, mesh, params, opt_state, batch):
    fn, specs = step_lib.make_train_step(cfg, mesh=mesh, batch_size=B,
                                         seq_len=S, lr_fn=constant(LR),
                                         grad_wire="none")
    return fn(params, opt_state, batch), specs


def _global(trees, mesh, specs):
    return dict(flatten_with_path(convert.unshard(trees, mesh, specs)))


@pytest.mark.parametrize("arch,over", [("qwen2_7b", dict(fsdp=True)),
                                       ("kimi_k2_1t_a32b", {})])
def test_save_on_4x2_restore_on_2x4(tmp_path, arch, over):
    cfg = tconfigs.get_reduced(arch).scaled(**over)
    a, b = _mesh((4, 2)), _mesh((2, 4))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, B, S).items()}
    _, specs = step_lib.make_train_step(cfg, mesh=a, batch_size=B,
                                        seq_len=S, lr_fn=constant(LR))
    opt = make_optimizer(cfg, constant(LR))
    ps = convert.shard_params(convert.stack_params(tmodel.init_model(
        cfg, device="cpu")), a, specs.params_sh)
    st = [opt.init(p) for p in ps]
    (ps, st, _), specs = _step(cfg, a, ps, st, batch)   # a real state
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    shard = {"params": specs.params_sh, "opt_state": specs.opt_state_sh}
    ckpt.save(1, [{"params": p, "opt_state": o} for p, o in zip(ps, st)],
              mesh=a, specs=shard)
    want_p = _global(ps, a, specs.params_sh)
    want_s = _global(st, a, specs.opt_state_sh)

    p2, s2, meta, specs2 = elastic_restore(ckpt, cfg, b, batch_size=B,
                                           seq_len=S)
    assert meta["step"] == 1 and len(p2) == b.size
    for key, t in _global(p2, b, specs2.params_sh).items():
        assert _bits(t) == _bits(want_p[key]), key
    for key, t in _global(s2, b, specs2.opt_state_sh).items():
        assert _bits(t) == _bits(want_s[key]), key
    # each position's blocks are (2, 4)'s, on its device
    wq = p2[0]["stack"]["sub0"]["attn"]["wq"]["w"]
    assert wq.shape[-1] == 4 * 32 // 4

    # one more step on either mesh: the same step
    (_, sa, ma), _ = _step(cfg, a, ps, st, batch)
    (_, sb, mb), _ = _step(cfg, b, p2, s2, batch)
    for k in ("loss", "grad_norm", "moe_aux_loss"):
        np.testing.assert_allclose(float(mb[k]), float(ma[k]), rtol=1e-5,
                                   err_msg=k)
    got = _global(sb, b, specs2.opt_state_sh)
    for key, w in _global(sa, a, specs.opt_state_sh).items():
        if w.ndim:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                       atol=2e-4 * float(w.abs().max()),
                                       err_msg=key)


def test_sharded_save_writes_the_global_arrays(tmp_path):
    """The files of a sharded save are those of the global tree's save,
    byte for byte, under the same keys."""
    cfg = tconfigs.get_reduced("olmo_1b")
    mesh = _mesh((2, 4))
    _, specs = step_lib.make_train_step(cfg, mesh=mesh, batch_size=B,
                                        seq_len=S)
    p = convert.stack_params(tmodel.init_model(cfg, device="cpu"))
    ckpt = CheckpointManager(str(tmp_path / "a"))
    ckpt.save(3, convert.shard_params(p, mesh, specs.params_sh), mesh=mesh,
              specs=specs.params_sh)
    ref = CheckpointManager(str(tmp_path / "b"))
    ref.save(3, p)
    ma, mb = load_manifest(ckpt.path(3)), load_manifest(ref.path(3))
    assert ma["leaves"] == mb["leaves"]
    for entry in ma["leaves"].values():
        with open(f"{ckpt.path(3)}/{entry['file']}", "rb") as f, \
                open(f"{ref.path(3)}/{entry['file']}", "rb") as g:
            assert f.read() == g.read()


def test_jax_checkpoint_restores_onto_2x4_and_trains(tmp_path):
    """The reference's manager writes params and AdamW state; the port
    restores them onto (2, 4) bit for bit and its step there equals its
    one-device step from the same checkpoint (1e-5 in the metrics, first
    moments within 1e-4 of their largest)."""
    jcfg = jconfigs.get_reduced("qwen2_7b").scaled(fsdp=True)
    tcfg = tconfigs.get_reduced("qwen2_7b").scaled(fsdp=True)
    params = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    state = jopt.make_optimizer(jcfg, jopt.constant(LR)).init(params)
    jckpt.CheckpointManager(str(tmp_path)).save(
        5, {"params": params, "opt_state": state})
    mesh = _mesh((2, 4))
    ckpt = CheckpointManager(str(tmp_path))
    ps, st, meta, specs = elastic_restore(ckpt, tcfg, mesh, batch_size=B,
                                          seq_len=S)
    assert meta["step"] == 5
    want = dict(flatten_with_path({"params": jax.tree.map(np.asarray,
                                                          params)}))
    for key, t in _global(ps, mesh, specs.params_sh).items():
        assert np.asarray(t).tobytes() == want["params/" + key].tobytes()

    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg, B,
                                                           S).items()}
    (_, st, m), _ = _step(tcfg, mesh, ps, st, batch)
    one, _ = step_lib.make_train_step(tcfg, batch_size=B, seq_len=S,
                                      lr_fn=constant(LR), grad_wire="none",
                                      device="cpu")
    tree, _ = ckpt.restore({"params": specs.params,
                            "opt_state": specs.opt_state}, device="cpu")
    _, ws, wm = one(tree["params"], tree["opt_state"], batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-5)
    got = _global(st, mesh, specs.opt_state_sh)
    for key, w in flatten_with_path(ws):
        if key.startswith("m/"):
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * float(w.abs().max()),
                                       err_msg=key)


def test_elastic_restore_without_a_checkpoint(tmp_path):
    cfg = tconfigs.get_reduced("olmo_1b")
    out = elastic_restore(CheckpointManager(str(tmp_path)), cfg,
                          _mesh((2, 4)), batch_size=B, seq_len=S)
    assert out[:3] == (None, None, None) and out[3].mesh.shape == \
        {"data": 2, "model": 4}


def test_trainer_on_a_mesh_resumes_on_another(tmp_path):
    """Four steps on (4, 2) with a checkpoint at 2, then a Trainer on
    (2, 4) in the same workdir resumes at 4 and runs to 6; the losses of
    steps 5 and 6 equal a run on (4, 2) straight through (1e-5)."""
    cfg = tconfigs.get_reduced("olmo_1b")
    tc = dict(batch_size=B, seq_len=16, ckpt_every=2, async_save=False,
              log_every=100)
    logs = []
    Trainer(cfg, TrainerConfig(total_steps=4, **tc), workdir=str(tmp_path),
            mesh=_mesh((4, 2)), log_fn=logs.append).run()
    tr = Trainer(cfg, TrainerConfig(total_steps=6, **tc),
                 workdir=str(tmp_path), mesh=_mesh((2, 4)),
                 log_fn=logs.append)
    last = tr.run()
    assert any("restored step 4" in line for line in logs)
    assert tr.step == 6 and len(tr.params) == 8
    straight = Trainer(cfg, TrainerConfig(total_steps=6, **tc),
                       workdir=str(tmp_path / "straight"),
                       mesh=_mesh((4, 2)), log_fn=logs.append).run()
    np.testing.assert_allclose(last["loss"], straight["loss"], rtol=1e-5)
