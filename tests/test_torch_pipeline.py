"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) on
four logical CPU stages against the reference: its loss against the JAX
``loss_fn``, one step against the port's own ``make_train_step`` and
against the JAX pipeline step run on four forced host devices, and its
refusals.

The setup is ``tests/test_distributed.py::test_pipeline_matches_reference``'s:
reduced olmo_1b at f32, 4 layers, no remat, tied embeddings, batch
8 x 16 in 4 microbatches; the weights are the reference's
``init_model(PRNGKey(0))`` in the training layout
(``models.convert.train_from_jax``).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.distributed import step as step_lib
from repro_torch.distributed.pipeline import (make_pipeline_train_step,
                                              stage_split_params)
from repro_torch.launch.mesh import BatchMesh, make_batch_mesh
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.tree import flatten_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_TOL = 1e-4     # tests/test_distributed.py's pipeline bar
PARAM_TOL = 1e-5    # an updated parameter, against either reference
OVER = dict(n_layers=4, remat=False, tie_embeddings=True)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_reduced("olmo_1b").scaled(**OVER)
    tcfg = tconfigs.get_reduced("olmo_1b").scaled(**OVER)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                jcfg.vocab_size, jnp.int32)
    jloss, _ = jmodel.loss_fn(jparams, {"tokens": tokens}, jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return dict(jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                tokens=np.array(tokens), jloss=float(jloss))


def _params(setup):
    return convert.train_from_jax(setup["np_params"], setup["tcfg"],
                                  device="cpu")


def _mesh(n=4):
    return make_batch_mesh(n, axis="stage", device="cpu")


def _pipeline_step(setup):
    step, opt = make_pipeline_train_step(setup["tcfg"], _mesh(), n_micro=4)
    params = _params(setup)
    state = opt.init(params)
    params, state, m = step(params, state,
                            {"tokens": torch.from_numpy(setup["tokens"])})
    return params, m


def test_pipeline_loss_matches_jax_loss_fn(setup):
    params, m = _pipeline_step(setup)
    np.testing.assert_allclose(float(m["loss"]), setup["jloss"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    moved = sum(float((a - b).abs().sum()) for (_, a), (_, b) in zip(
        flatten_with_path(params), flatten_with_path(_params(setup))))
    assert moved > 0


def test_pipeline_step_matches_train_step(setup):
    """One pipeline step against ``make_train_step`` (no microbatches, no
    bf16 wire: the reference's pipeline casts its gradients to f32 and
    nothing else) on the same weights, batch and schedule."""
    got, m = _pipeline_step(setup)
    fn, _ = step_lib.make_train_step(
        setup["tcfg"], batch_size=8, seq_len=16,
        lr_fn=warmup_cosine(3e-4, 100, 10_000), grad_wire="none",
        device="cpu")
    params = _params(setup)
    state = make_optimizer(setup["tcfg"],
                           warmup_cosine(3e-4, 100, 10_000)).init(params)
    want, _, mw = fn(params, state,
                     {"tokens": torch.from_numpy(setup["tokens"])})
    np.testing.assert_allclose(float(m["loss"]), float(mw["loss"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(mw["grad_norm"]), rtol=1e-5)
    w = dict(flatten_with_path(want))
    for key, t in flatten_with_path(got):
        np.testing.assert_allclose(t.numpy(), w[key].numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=key)


JAX_STEP = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.distributed.pipeline import make_pipeline_train_step
from repro.models import model as M

cfg = get_reduced("olmo_1b").scaled(n_layers=4, remat=False,
                                    tie_embeddings=True)
mesh = jax.make_mesh((4,), ("stage",))
params = M.init_model(jax.random.PRNGKey(0), cfg)
tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                            cfg.vocab_size, jnp.int32)
step, opt = make_pipeline_train_step(cfg, mesh, n_micro=4)
with mesh:
    p2, _, m = step(params, opt.init(params), {"tokens": tokens})
flat, _ = jax.tree_util.tree_flatten_with_path(p2)
out = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
       np.asarray(v) for path, v in flat}
out["__loss__"] = np.asarray(m["loss"])
out["__grad_norm__"] = np.asarray(m["grad_norm"])
np.savez(sys.argv[1], **out)
"""


def test_pipeline_step_matches_jax_pipeline(setup, tmp_path):
    """The reference's ``make_pipeline_train_step`` on 4 forced host
    devices, in a subprocess (JAX fixes its device count at first use),
    as ``tests/test_distributed.py`` runs it."""
    path = str(tmp_path / "jax_step.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_STEP),
                        path], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    want = dict(np.load(path))
    got, m = _pipeline_step(setup)
    np.testing.assert_allclose(float(m["loss"]), float(want.pop("__loss__")),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(want.pop("__grad_norm__")), rtol=1e-4)
    flat = dict(flatten_with_path(got))
    assert set(flat) == set(want)
    for key, t in flat.items():
        np.testing.assert_allclose(t.numpy(), want[key], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=key)


def test_stage_split_params():
    cfg = tconfigs.get_reduced("olmo_1b").scaled(n_layers=8)
    params = step_lib.param_specs(cfg)
    split = stage_split_params(params, 4)
    wq = split["stack"]["sub0"]["attn"]["wq"]["w"]
    assert tuple(wq.shape) == (4, 2) + tuple(
        params["stack"]["sub0"]["attn"]["wq"]["w"].shape[1:])
    assert split["embed"] is params["embed"]
    with pytest.raises(ValueError, match="stages"):
        stage_split_params(params, 3)


@pytest.mark.parametrize("arch,over,mesh,match", [
    ("recurrentgemma_9b", dict(n_layers=7), 1, "tail"),
    ("olmo_1b", dict(n_layers=6), 4, "split"),
    ("internvl2_2b", dict(n_layers=4), 4, "frontend"),
    ("olmo_1b", dict(n_layers=4, tina_lowering="kernel"), 4, "kernel"),
])
def test_pipeline_refusals(arch, over, mesh, match):
    cfg = tconfigs.get_reduced(arch).scaled(**over)
    with pytest.raises(ValueError, match=match):
        make_pipeline_train_step(cfg, _mesh(mesh), n_micro=4)


def test_pipeline_refuses_batch_and_mesh_misfits():
    cfg = tconfigs.get_reduced("olmo_1b").scaled(**OVER)
    with pytest.raises(ValueError, match="stage"):
        make_pipeline_train_step(cfg, make_batch_mesh(4, device="cpu"),
                                 n_micro=4)
    step, opt = make_pipeline_train_step(cfg, _mesh(), n_micro=4)
    params = convert.stack_params(tmodel.init_model(cfg, device="cpu"))
    state = opt.init(params)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, state, {"tokens": torch.zeros((6, 16),
                                                   dtype=torch.int32)})


def test_pipeline_on_two_stages_matches_four(setup):
    """The schedule's result does not depend on the stage count."""
    losses = []
    for n in (2, 4):
        step, opt = make_pipeline_train_step(
            setup["tcfg"], BatchMesh(("cpu",) * n, axis="stage"), n_micro=4)
        params = _params(setup)
        _, _, m = step(params, opt.init(params),
                       {"tokens": torch.from_numpy(setup["tokens"])})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
