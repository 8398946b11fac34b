"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the twins of ``tests/test_checkpoint.py``'s seven tests, and
checkpoints crossing between the packages in both directions (the same
on-disk format: one ``.npy`` per leaf, bf16 as uint16 bits, a
``manifest.json``)."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import optim as jopt
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import optim as topt
from repro_torch.checkpoint import (CheckpointManager, load_manifest,
                                    load_pytree, save_pytree)
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.tree import flatten_with_path, map_tree


def _tree():
    return {"p": {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
                  "b": torch.ones((4,), dtype=torch.float32)},
            "tail": [torch.zeros((2,), dtype=torch.int32)],
            "count": torch.tensor(5, dtype=torch.int32)}


def _meta(tree):
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _flat(tree):
    return dict(flatten_with_path(tree))


def test_roundtrip_bitwise(tmp_path):
    t = _tree()
    d = str(tmp_path / "c")
    save_pytree(t, d, metadata={"step": 1})
    for target in (_meta(t), map_tree(torch.zeros_like, t)):
        out = load_pytree(target, d, device="cpu")
        for (ka, a), (kb, b) in zip(flatten_with_path(out),
                                    flatten_with_path(t)):
            assert ka == kb and a.dtype == b.dtype and a.device.type == "cpu"
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert load_manifest(d)["metadata"] == {"step": 1}


def test_atomic_no_tmp_visible(tmp_path):
    d = str(tmp_path / "c")
    save_pytree(_tree(), d)
    assert not os.path.exists(d + ".tmp")
    assert os.path.exists(os.path.join(d, "manifest.json"))


def test_half_written_checkpoint_ignored(tmp_path):
    """A directory without a manifest (a kill mid-write) is not picked up
    as the latest."""
    mgr = CheckpointManager(str(tmp_path), keep_n=5)
    mgr.save(1, _tree())
    os.makedirs(str(tmp_path / "ckpt_2"))
    assert mgr.latest_step() == 1


def test_keep_n_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=True)
    t = _tree()
    mgr.save(7, t)
    out, meta = mgr.restore(_meta(t), device="cpu")
    assert meta["step"] == 7
    np.testing.assert_array_equal(out["p"]["b"].numpy(), t["p"]["b"].numpy())


def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` copies every leaf before it returns: an in-place update
    made right after it (the next donated step) does not reach the
    checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = {"w": torch.arange(1 << 20, dtype=torch.float32),
         "h": torch.ones((8,), dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in t.items()}
    mgr.save(3, t)
    t["w"].mul_(-1.0)
    t["h"].add_(1.0)
    out, _ = mgr.restore(_meta(t), device="cpu")
    for k in t:
        np.testing.assert_array_equal(_bits(out[k]), _bits(want[k]))


def test_async_save_error_raised_by_wait(tmp_path):
    """A background write that fails raises from ``wait`` (and so from
    the next ``save`` or ``restore``), not silently."""
    root = tmp_path / "ck"
    mgr = CheckpointManager(str(root), async_save=True)
    mgr.save(1, _tree())
    mgr.wait()
    shutil.rmtree(str(root))
    root.write_text("not a directory")        # the write cannot start
    mgr.save(2, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                # reported once


def test_restore_missing_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    out, meta = mgr.restore({"x": torch.empty((2,), device="meta")})
    assert out is None and meta is None


def test_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "c")
    save_pytree({"w": torch.zeros((2, 2))}, d)
    with pytest.raises(ValueError):
        load_pytree({"w": torch.empty((3, 2), device="meta")}, d,
                    device="cpu")
    with pytest.raises(KeyError):
        load_pytree({"v": torch.empty((2, 2), device="meta")}, d,
                    device="cpu")


def _bf16_cfgs(arch="olmo_1b"):
    over = dict(n_layers=2, param_dtype="bfloat16")
    return (jconfigs.get_reduced(arch).scaled(**over),
            tconfigs.get_reduced(arch).scaled(**over))


@pytest.mark.parametrize("arch", ["olmo_1b", "recurrentgemma_9b"])
def test_jax_checkpoint_restores_into_port(tmp_path, arch):
    """A checkpoint written by ``repro.checkpoint.save_pytree`` from the
    reference's bf16 parameters (and its AdamW state) restores into the
    port's train-step specs: bit for bit what converting the JAX tree
    directly gives."""
    jcfg, tcfg = _bf16_cfgs(arch)
    params = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    jo = jopt.make_optimizer(jcfg, jopt.constant(1e-3))
    st = jo.init(params)
    st = {**st, "count": jnp.asarray(3, jnp.int32)}
    d = str(tmp_path / "jax_ckpt")
    jckpt.save_pytree({"params": params, "opt_state": st}, d,
                      metadata={"step": 3})
    _, specs = step_lib.make_train_step(tcfg, batch_size=2, seq_len=8,
                                        device="cpu")
    out = load_pytree({"params": specs.params,
                       "opt_state": specs.opt_state}, d, device="cpu")
    direct = convert.train_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    got, want = _flat(out["params"]), _flat(direct)
    assert set(got) == set(want)
    assert any(t.dtype == torch.bfloat16 for t in want.values())
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)
    assert int(out["opt_state"]["count"]) == 3
    jst = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path): v
           for path, v in jax.tree_util.tree_flatten_with_path(st)[0]}
    for k, t in _flat(out["opt_state"]).items():
        np.testing.assert_array_equal(_bits(t), _jbits(jst[k]), k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port checkpoint (training-layout params after a step, and AdamW
    state) loads in ``repro.checkpoint.load_pytree`` against the
    reference's own tree: the same keys, the same bits."""
    jcfg, tcfg = _bf16_cfgs()
    tcfg32 = tcfg.scaled(param_dtype="float32")
    fn, specs = step_lib.make_train_step(tcfg32, batch_size=2, seq_len=8,
                                         lr_fn=topt.constant(1e-3),
                                         device="cpu")
    tp = convert.train_from_jax(jax.tree.map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(0),
                                      jcfg.scaled(param_dtype="float32"))),
        tcfg32, device="cpu")
    opt = topt.make_optimizer(tcfg32, topt.constant(1e-3))
    st = opt.init(tp)
    batch = {"tokens": torch.randint(0, tcfg32.vocab_size, (2, 8),
                                     dtype=torch.int32)}
    tp, st, _ = fn(tp, st, batch)
    tree = {"params": tp, "opt_state": st,
            "extra": {"h": torch.randn(5).to(torch.bfloat16)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    jparams = jax.eval_shape(lambda: jmodel.init_model(
        jax.random.PRNGKey(0), jcfg.scaled(param_dtype="float32")))
    jst = jax.eval_shape(jopt.make_optimizer(
        jcfg, jopt.constant(1e-3)).init, jparams)
    target = {"params": jparams, "opt_state": jst,
              "extra": {"h": jax.ShapeDtypeStruct((5,), jnp.bfloat16)}}
    out = jckpt.load_pytree(target, mgr.path(1))
    flat_j = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(out)[0]}
    flat_t = _flat(tree)
    assert set(flat_j) == set(flat_t)
    for k, t in flat_t.items():
        np.testing.assert_array_equal(_jbits(flat_j[k]), _bits(t), k)
