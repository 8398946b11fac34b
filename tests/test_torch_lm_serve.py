"""The model zoo's serving path on the port: bf16 compute against the
JAX package, the prefill and decode steps of every family, the data
pipeline and the launcher.

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
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipeline
from repro_torch.distributed import step as tstep
from repro_torch.kernels import matmul as mmk
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from test_torch_lm import OVER, model_inputs, prompt_of
from test_torch_moe import _kept

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["olmo_1b", "qwen2_7b", "stablelm_3b", "stablelm_1_6b"]
BF16_RTOL = 2e-2    # of max: the JAX suite's decode tolerance (see above)
FAMILIES = {"moe": "kimi_k2_1t_a32b", "moe_dense_residual": "arctic_480b",
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


def _serve_run(forward, prefill, decode, batch, s, t0):
    """Logits of the serving sequence: the forward over the whole batch,
    a prefill of the first ``t0`` text tokens (its last position) and a
    decode step for each later token, fed the batch's tokens."""
    out = [forward(batch)]
    if "tokens" not in batch:
        return out
    tokens = batch["tokens"]
    logits, caches = prefill(prompt_of(batch, t0))
    out.append(logits)
    for i in range(t0, tokens.shape[1]):
        logits, caches = decode(tokens[:, i], caches)
        out.append(logits)
    return out


def _routed(log, shape, cfg):
    """What each token of a call routed, layer by layer: its experts and
    which of them kept it, (layers, B, S, 2k), from a recorder's log."""
    out = []
    for e in log:
        e = np.asarray(e)
        kept = _kept(e, tmoe.capacity(e.shape[0], cfg), cfg.n_experts)
        out.append(np.concatenate([e, kept], -1).reshape(shape + (-1,)))
    return np.stack(out)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_bf16_prefill_and_decode_match_jax_kernel(arch, monkeypatch):
    """compute_dtype bfloat16: the port's kernel lowering (bf16 GEMMs)
    against JAX's pallas lowering (its GEMM in interpret mode), through
    the port's serving steps: the forward, prefill + 4 greedy decode
    steps fed the same tokens, and the next tokens where JAX's choice is
    clear.  hubert (encoder-only) runs the forward.

    The bar is 2e-2 of max for the dense decoders.  For the other archs
    it is 2e-2 or twice the reference's own distance from the model at
    f32 compute (the port's f32 run, which the f32 test holds to JAX's
    within 1e-4), whichever is larger: each GEMM's one rounding of its
    f32 sums differs by an ulp between the two frameworks, and some
    blocks amplify it past 2e-2 in the reference itself (a WKV head's
    group norm where r·k cancels; the RG-LRU over 5 layers), so two bf16
    runs may lie twice that far apart.  MoE rows are compared only where
    the token routed alike in every layer in both runs, its experts and
    which of them kept it (at least 3 rows in 4): a near tie in the
    router flips on an ulp, and a flip moves the capacity's cut for the
    later tokens of its expert."""
    over = dict(compute_dtype="bfloat16", attn_chunk=8, **OVER.get(arch, {}))
    jcfg = jconfigs.get_reduced(arch).scaled(tina_lowering="pallas", **over)
    tcfg = tconfigs.get_reduced(arch).scaled(tina_lowering="kernel", **over)
    if jcfg.moe:     # the unrolled stack, so a recorder sees each layer
        jcfg = jcfg.scaled(use_scan=False)
    params = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    b = 2
    s = 12 + (jcfg.num_patches if jcfg.frontend == "vision_stub" else 0)
    batch = model_inputs(jcfg, b, s, _rng("bf16", arch))
    t0 = batch["tokens"].shape[1] - 4 if "tokens" in batch else 0
    jlog, tlog = [], []

    def jrecord(p, x, cfg):
        n = x.shape[0] * x.shape[1]
        logits = x.reshape(n, -1).astype(jnp.float32) @ \
            p["router"]["w"].astype(jnp.float32)
        jlog.append(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                  cfg.n_experts_per_token)[1])
        return real_j(p, x, cfg)

    def trecord(p, x, cfg):
        y, aux = real_t(p, x, cfg)
        tlog.append(aux["moe_experts"])
        return y, aux

    real_j, real_t = jmoe.moe_block, tmoe.moe_block
    monkeypatch.setattr(jmoe, "moe_block", jrecord)
    monkeypatch.setattr(tmoe, "moe_block", trecord)

    def jax_steps():
        jc = jmodel.init_caches(jcfg, b, max_len=s)

        def pre(bt):
            nonlocal jc
            lg, jc, _ = jmodel.forward(
                params, {k: jnp.asarray(v) for k, v in bt.items()}, jcfg,
                caches=jc, remat=False)
            return _np(lg)[:, -1], None

        def dec(tok, _):
            nonlocal jc
            lg, jc = jmodel.decode_step(params, jnp.asarray(tok), jc, jcfg)
            return _np(lg), None

        return (lambda bt: _np(jmodel.forward(
            params, {k: jnp.asarray(v) for k, v in bt.items()}, jcfg,
            remat=False)[0]), pre, dec)

    def port_steps(cfg):
        tp = tmodel.prepare(convert.from_jax(tree, cfg, device="cpu"), cfg)
        prefill = tstep.make_prefill_step(cfg, batch_size=b, seq_len=s - 4)
        decode = tstep.make_decode_step(cfg, batch_size=b, cache_len=s)
        caches = tmodel.init_caches(cfg, b, s, device="cpu")

        def t(bt):
            return {k: torch.from_numpy(v) for k, v in bt.items()}

        def fwd(bt):
            lg = tmodel.forward(tp, t(bt), cfg)[0]
            assert lg.dtype == torch.float32
            return lg.numpy()

        def dec(tok, c):
            nxt, lg, c = decode(tp, torch.from_numpy(tok), c)
            assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))
            return lg.numpy(), c

        return fwd, lambda bt: prefill(tp, t(bt), caches), dec

    calls = ["forward", "prefill"] + [f"decode {i}" for i in range(4)]
    runs, routes = {}, {}
    for name, steps in (("jax", jax_steps()), ("port", port_steps(tcfg)),
                        ("f32", port_steps(tcfg.scaled(
                            compute_dtype="float32")))):
        fwd, pre, dec = steps
        log = jlog if name == "jax" else tlog
        outs, rts = [], []

        def call(fn, *args, shape):
            log.clear()
            out = fn(*args)
            rts.append(_routed(log, shape, tcfg) if log else None)
            return out

        outs.append(call(fwd, batch, shape=(b, s)))
        if "tokens" in batch:
            lg, c = call(pre, prompt_of(batch, t0), shape=(b, s - 4))
            outs.append(np.asarray(lg))
            for i in range(t0, batch["tokens"].shape[1]):
                lg, c = call(dec, batch["tokens"][:, i], c, shape=(b, 1))
                outs.append(np.asarray(lg))
        runs[name], routes[name] = outs, rts

    # MoE: the rows to compare, those that routed alike in every layer
    compared = []
    for i, what in enumerate(calls[:len(runs["jax"])]):
        want, got, ref = (runs[k][i] for k in ("jax", "port", "f32"))
        rows = np.ones(want.shape[:-1], bool)
        if routes["jax"][i] is not None:
            same = (routes["jax"][i] == routes["port"][i]).all(-1).all(0)
            rows = same if want.ndim == 3 else same[:, -1]
        compared.extend(rows.reshape(-1))
        want, got, ref = want[rows], got[rows], ref[rows]
        scale = np.abs(want).max()
        d_ref = np.abs(want - ref).max() / scale
        bar = BF16_RTOL if arch in DENSE else max(BF16_RTOL, 2 * d_ref)
        _close(got, want, bar, f"{arch} {what} (reference bf16 vs f32: "
                               f"{d_ref:.4f})")
        if i >= 2:
            w = np.sort(want, -1)
            clear = w[:, -1] - w[:, -2] > 2 * bar * scale
            np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                          np.argmax(want, -1)[clear])
    assert np.mean(compared) >= 0.75, f"{arch}: routes differ {compared}"


@pytest.mark.parametrize("arch", DENSE + ["recurrentgemma_9b", "rwkv6_3b"])
def test_decode_matches_forward(arch):
    """The port's decode equals its teacher-forced forward (cache and
    recurrent-state correctness): the archs, shapes and tolerance of the
    JAX suite's test_decode_matches_forward, at the reduced config's
    f32.  Not MoE: a call's capacity depends on its token count."""
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


def _shapes(tree, path=""):
    """{path: (shape, dtype)} of every tensor of a parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: (tuple(tree.shape), tree.dtype)}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_family_builds(family):
    """Every family's model, caches, converted weights and both steps
    build at its reduced size, and each step runs one call (hubert, the
    encoder, no decode: its server has none)."""
    arch = FAMILIES[family]
    jcfg, cfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    b, s = 2, 12 + (cfg.num_patches if cfg.frontend == "vision_stub" else 0)
    tp = tmodel.init_model(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jmodel.init_model(jax.random.PRNGKey(0),
                                                      jcfg))
    conv = convert.from_jax(tree, cfg, device="cpu")
    # the reference's tree lands in the port's layout, leaf for leaf
    assert _shapes(conv) == _shapes(tp)
    for params in (tp, conv):
        params = tmodel.prepare(params, cfg)
        caches = tmodel.init_caches(cfg, b, s, device="cpu")
        prefill = tstep.make_prefill_step(cfg, batch_size=b, seq_len=s - 4)
        decode = tstep.make_decode_step(cfg, batch_size=b, cache_len=s)
        batch = {k: torch.from_numpy(v) for k, v in tpipeline.make_batch(
            cfg, b, s - 4).items()}
        logits, caches = prefill(params, batch, caches)
        assert tuple(logits.shape) == (b, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        if family == "audio":
            continue
        tok = torch.argmax(logits, -1).to(torch.int32)
        nxt, logits, caches = decode(params, tok, caches)
        assert tuple(nxt.shape) == (b,) and bool(torch.isfinite(logits).all())


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


@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {"audio"}))
def test_serve_main_serves_every_decoder_family(family):
    """Each decoder family's reduced config through the launcher on the
    CPU: prefill, then lock-step greedy decode (the vlm's prompt is its
    patches, then tokens)."""
    arch = FAMILIES[family]
    layers = ["--layers", "1"] if family == "moe" else []
    before = (mmk.LAUNCHES, mmk.BF16_LAUNCHES)
    out = tserve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                       "--prompt-len", "16", "--steps", "4"] + layers)
    assert (mmk.LAUNCHES, mmk.BF16_LAUNCHES) == before
    assert out["layers"] == (1 if layers else
                             tconfigs.get_reduced(arch).n_layers)
    gen = np.asarray(out["generated"])
    assert gen.shape == (2, 4) and out["arch"] == tconfigs.get(arch).name
    assert ((gen >= 0) & (gen < tconfigs.get_reduced(arch).vocab_size)).all()
    if family == "vlm":
        with pytest.raises(SystemExit, match="no token after"):
            tserve.main(["--device", "cpu", "--arch", arch,
                         "--prompt-len", "8"])


def test_serve_module_runs_as_a_script():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "olmo_1b", "--batch", "2", "--steps", "3"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "prefill: 2x32" in run.stdout and "decode : 2 steps" in run.stdout
