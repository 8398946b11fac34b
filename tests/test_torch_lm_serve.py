"""The model zoo's serving path on the port: bf16 compute against the
JAX package, the prefill and decode steps, the data pipeline, the
launcher, and the families not yet ported.

Weights come from the JAX ``init_model`` through
``repro_torch.models.convert.from_jax``; inputs from numpy with a fixed
seed.  At bf16 the whole model is held to 2e-2 of max, the JAX suite's
own decode tolerance (``tests/test_system.py``), not to bits: XLA on the
CPU fuses a chain of bf16 elementwise ops and rounds once at its end,
while torch on the CPU rounds after each op, so the two differ by
rounding at every layer.  Each GEMM itself rounds once in both (its
kernel test holds it to one bf16 ulp).
"""
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipeline
from repro_torch.distributed import step as tstep
from repro_torch.kernels import matmul as mmk
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model as tmodel

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["olmo_1b", "qwen2_7b", "stablelm_3b", "stablelm_1_6b"]
BF16_RTOL = 2e-2    # of max: the JAX suite's decode tolerance (see above)
NOT_PORTED = {"moe": "kimi_k2_1t_a32b", "moe_dense_residual": "arctic_480b",
              "hybrid": "recurrentgemma_9b", "ssm": "rwkv6_3b",
              "vlm": "internvl2_2b", "audio": "hubert_xlarge"}


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_prefill_and_decode_match_jax_kernel(arch):
    """compute_dtype bfloat16: the port's kernel lowering (bf16 GEMMs)
    against JAX's pallas lowering (its GEMM in interpret mode), through
    the port's serving steps: the forward, prefill + 4 greedy decode
    steps fed the same tokens, and the next tokens where JAX's choice is
    clear."""
    jcfg = jconfigs.get_reduced(arch).scaled(
        tina_lowering="pallas", compute_dtype="bfloat16", attn_chunk=8)
    tcfg = tconfigs.get_reduced(arch).scaled(
        tina_lowering="kernel", compute_dtype="bfloat16", attn_chunk=8)
    params = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.prepare(convert.from_jax(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu"), tcfg)
    b, s = 2, 12
    tokens = _rng("bf16", arch).integers(0, jcfg.vocab_size,
                                         (b, s)).astype(np.int32)
    want, _, _ = jmodel.forward(params, {"tokens": jnp.asarray(tokens)},
                                jcfg, remat=False)
    got, _, _ = tmodel.forward(tp, {"tokens": torch.from_numpy(tokens)},
                               tcfg)
    assert got.dtype == torch.float32
    _close(got, want, BF16_RTOL, f"{arch} forward")

    prefill = tstep.make_prefill_step(tcfg, batch_size=b, seq_len=s - 4)
    decode = tstep.make_decode_step(tcfg, batch_size=b, cache_len=s)
    tc = tmodel.init_caches(tcfg, b, s, device="cpu")
    jc = jmodel.init_caches(jcfg, b, max_len=s)
    want, jc, _ = jmodel.forward(params, {"tokens": jnp.asarray(
        tokens[:, :s - 4])}, jcfg, caches=jc, remat=False)
    got, tc = prefill(tp, {"tokens": torch.from_numpy(tokens[:, :s - 4])},
                      tc)
    _close(got, _np(want)[:, -1], BF16_RTOL, f"{arch} prefill")
    for i in range(s - 4, s):
        want, jc = jmodel.decode_step(params, jnp.asarray(tokens[:, i]), jc,
                                      jcfg)
        nxt, got, tc = decode(tp, torch.from_numpy(tokens[:, i]), tc)
        _close(got, want, BF16_RTOL, f"{arch} decode {i}")
        w = np.sort(_np(want), -1)
        clear = w[:, -1] - w[:, -2] > 2 * BF16_RTOL * np.abs(w).max()
        np.testing.assert_array_equal(nxt.numpy()[clear],
                                      np.argmax(_np(want), -1)[clear])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """The port's decode equals its teacher-forced forward (cache
    correctness): the shapes and tolerance of the JAX suite's
    test_decode_matches_forward, at the reduced config's f32."""
    cfg = tconfigs.get_reduced(arch).scaled(attn_chunk=8)
    params = tmodel.prepare(tmodel.init_model(cfg, seed=0, device="cpu"),
                            cfg)
    b, s = 2, 12
    tokens = torch.from_numpy(_rng("dmf", arch).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    full, _, _ = tmodel.forward(params, {"tokens": tokens}, cfg)
    caches = tmodel.init_caches(cfg, b, s, device="cpu")
    _, caches, _ = tmodel.forward(params, {"tokens": tokens[:, :s - 4]}, cfg,
                                  caches=caches)
    for i in range(s - 4, s):
        lg, caches = tmodel.decode_step(params, tokens[:, i], caches, cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   rtol=2e-2, atol=2e-2,
                                   err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ["olmo_1b", "internvl2_2b",
                                  "hubert_xlarge"])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_gives_the_reference_tokens(arch, seed):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    for structured in (True, False):
        want = jpipeline.make_batch(jcfg, 3, 40, seed=seed,
                                    structured=structured)
        got = tpipeline.make_batch(tcfg, 3, 40, seed=seed,
                                   structured=structured)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    assert tpipeline.batch_shapes(tcfg, 2, 300) == \
        jpipeline.batch_shapes(jcfg, 2, 300)


@pytest.mark.parametrize("family", sorted(NOT_PORTED))
def test_families_not_yet_ported_raise(family):
    """Building any piece of a model the port lacks raises; nothing else
    runs in its place."""
    cfg = tconfigs.get_reduced(NOT_PORTED[family])
    builders = [
        lambda: tmodel.init_model(cfg, device="cpu"),
        lambda: tmodel.init_caches(cfg, 2, 8, device="cpu"),
        lambda: convert.from_jax({}, cfg, device="cpu"),
        lambda: tstep.make_prefill_step(cfg, batch_size=2, seq_len=8),
        lambda: tstep.make_decode_step(cfg, batch_size=2, cache_len=8),
    ]
    for build in builders:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            build()


def test_steps_refuse_shapes_they_were_not_built_for():
    cfg = tconfigs.get_reduced("olmo_1b")
    params = tmodel.prepare(tmodel.init_model(cfg, device="cpu"), cfg)
    prefill = tstep.make_prefill_step(cfg, batch_size=2, seq_len=8)
    decode = tstep.make_decode_step(cfg, batch_size=2, cache_len=12)
    caches = tmodel.init_caches(cfg, 2, 12, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        prefill(params, {"tokens": torch.zeros(2, 9, dtype=torch.int32)},
                caches)
    with pytest.raises(ValueError, match="built for"):
        decode(params, torch.zeros(3, dtype=torch.int32), caches)
    with pytest.raises(ValueError, match="built for"):
        decode(params, torch.zeros(2, dtype=torch.int32),
               tmodel.init_caches(cfg, 2, 10, device="cpu"))


def test_serve_main_runs_the_reduced_config_on_the_cpu():
    """``main`` returns its summary; the kernel lowering on CPU tensors
    runs the kernels' plain versions (no launch)."""
    before = (mmk.LAUNCHES, mmk.BF16_LAUNCHES)
    out = tserve.main(["--device", "cpu", "--arch", "olmo_1b", "--batch",
                       "2", "--prompt-len", "8", "--steps", "5"])
    assert (mmk.LAUNCHES, mmk.BF16_LAUNCHES) == before
    assert out["lowering"] == "kernel" and out["device"] == "cpu"
    assert not out["full"] and out["arch"] == "olmo-1b"
    gen = np.asarray(out["generated"])
    assert gen.shape == (2, 5)
    assert ((gen >= 0) & (gen < tconfigs.get_reduced("olmo_1b").vocab_size)
            ).all()
    # the same weights and prompts at the native lowering choose the same
    # tokens (f32 compute on the reduced config)
    nat = tserve.main(["--device", "cpu", "--arch", "olmo_1b", "--batch",
                       "2", "--prompt-len", "8", "--steps", "5",
                       "--lowering", "native"])
    assert nat["generated"] == out["generated"]
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--device", "cpu", "--arch", "hubert_xlarge"])


def test_serve_module_runs_as_a_script():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "olmo_1b", "--batch", "2", "--steps", "3"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "prefill: 2x32" in run.stdout and "decode : 2 steps" in run.stdout
