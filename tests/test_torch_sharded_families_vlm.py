"""The port's sharded LM steps for internvl2 (the vision frontend: patches
before tokens, the loss on the text), on a (data 4, model 2) mesh of
logical CPU shards, against the reference's sharded steps (in this
file's own subprocess) and the port's one-device steps; and every
config's steps at every layout against its one-device steps. The cases,
oracle, helpers and bars are ``tests/test_torch_sharded_families.py``'s.
"""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import make_batch as jmake_batch
from repro_torch import configs as tconfigs
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.optim import constant, make_optimizer

# one_thread: the autouse fixture, imported so that it runs here too
from test_torch_sharded_families import (B, LR, MESH, OVER, PROMPT, S,
                                         _mesh, check_serve,
                                         check_serve_one_device, check_train,
                                         check_train_one_device,
                                         family_cases, one_thread,
                                         run_oracle, serve_case)

A = "internvl2_2b"
TRAIN = family_cases(A)
SERVE = [serve_case(A, "tp"), serve_case(A, "sp")]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(TRAIN + SERVE, tmp_path_factory.mktemp("jax_vlm"))


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


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_every_layout_builds_and_runs(arch):
    """Every config's sharded steps at ``tp``, ``fsdp`` and ``sp`` (the
    train step also with Megatron-SP), from its own random weights: the
    train step's loss that of the one-device step (1e-5 relative), the
    prefill's logits the one-device prefill's (1e-4 of the largest), a
    decode step's finite."""
    cfg = tconfigs.get_reduced(arch).scaled(**OVER.get(arch, {}))
    jcfg = jconfigs.get_reduced(arch).scaled(**OVER.get(arch, {}))
    p = convert.stack_params(tmodel.init_model(cfg, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             jmake_batch(jcfg, B, S).items()}
    one, _ = step_lib.make_train_step(cfg, batch_size=B, seq_len=S,
                                      device="cpu", donate=False)
    opt = make_optimizer(cfg, constant(LR))
    want = float(one(p, opt.init(p), batch)[2]["loss"])
    mesh = _mesh(MESH)
    for layout, sp in (("tp", False), ("fsdp", False), ("sp", False),
                       ("tp", True)):
        fn, specs = step_lib.make_train_step(
            cfg, mesh=mesh, batch_size=B, seq_len=S, layout=layout,
            sequence_parallel=sp)
        ps = convert.shard_params(p, mesh, specs.params_sh)
        _, _, m = fn(ps, [opt.init(x) for x in ps], batch)
        np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-5,
                                   err_msg=f"{layout} sp={sp}")
    params = tmodel.init_model(cfg, device="cpu")
    prompt = {k: torch.from_numpy(v) for k, v in
              jmake_batch(jcfg, B, PROMPT).items()}
    max_len = PROMPT + 1
    lg1, _ = step_lib.make_prefill_step(cfg, batch_size=B, seq_len=PROMPT)(
        params, prompt, tmodel.init_caches(cfg, B, max_len, device="cpu"))
    for layout in ("tp", "fsdp", "sp"):
        pre = step_lib.make_prefill_step(cfg, mesh=mesh, batch_size=B,
                                         seq_len=PROMPT, layout=layout)
        dec = step_lib.make_decode_step(cfg, mesh=mesh, batch_size=B,
                                        cache_len=max_len, layout=layout)
        ps = convert.shard_params(params, mesh, dec.specs.params_sh,
                                  copy=False)
        cs = step_lib.init_sharded_caches(dec.specs, B, max_len)
        lg, cs = pre(ps, prompt, cs)
        np.testing.assert_allclose(lg.numpy(), lg1.numpy(), rtol=0,
                                   atol=1e-4 * float(lg1.abs().max()),
                                   err_msg=layout)
        if cfg.family != "audio":
            _, lg, _ = dec(ps, torch.argmax(lg, -1).to(torch.int32), cs)
            assert bool(torch.isfinite(lg).all()), layout
