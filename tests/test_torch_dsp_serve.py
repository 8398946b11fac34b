"""The port's serving launcher (``repro_torch.launch.dsp_serve``), its
one-flow path (compile -> autotune -> stream -> serve) and the fault
points serving consults, on the CPU.

Twins of ``tests/test_opdefs.py``'s ``test_prewarm_measures_despite_
cached_mode``, ``test_dsp_serve_cli_new_pipeline`` and
``test_new_pipeline_end_to_end`` (``kernel`` where the reference says
``pallas``, ``device="cpu"``), and of the serving cases of
``tests/test_faults.py``: the ``device_run`` point, its lowering tags
(``kernel``), its poison-payload rule and the service's strict spec
validation, with the port's harness held to the JAX package's fire
sequence under one spec and seed.  Responses are held to the numpy
oracle within 2e-3 (the JAX suite's pipeline tolerance), a stream to its
offline plan within 1e-6 (the JAX suite's streaming bar).
"""
import os

import numpy as np
import pytest
import torch

from repro.obs import faults as jfaults
from repro_torch import graph
from repro_torch.core.registry import PIPELINES, pipelines
from repro_torch.graph import autotune
from repro_torch.graph import plan as plan_lib
from repro_torch.graph.service import PipelineService, replay_batches
from repro_torch.launch import dsp_serve
from repro_torch.obs import faults

pipelines()
RNG = np.random.default_rng(41)
TOL = 2e-3

pytestmark = pytest.mark.timeout(180)

NEW_PIPELINES = ("stft_overlap_add", "correlate", "cascaded_channelizer")


@pytest.fixture
def clean_faults(monkeypatch):
    """No ambient chaos config; the env-driven state is restored after."""
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    monkeypatch.delenv(faults.SEED_VAR, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# ---------------------------------------------------------------------------
# deploy-time pre-warm and the launcher
# ---------------------------------------------------------------------------
def test_prewarm_measures_despite_cached_mode(tmp_path, monkeypatch):
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("TINA_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")   # production serving mode
    autotune._MEM.clear()
    plan_lib.clear_cache()

    g = graph.Graph("one_fir")
    taps = np.hanning(31).astype(np.float32)
    g.output(g.apply("fir", g.input("x"), g.const(taps, "taps")))
    delta = dsp_serve.prewarm(g, 2, 300, lowering="kernel", device="cpu",
                              repeats=1)
    assert delta["measured"] >= 1          # measured despite cached mode
    assert cache.exists()
    assert os.environ["TINA_AUTOTUNE"] == "cached"   # mode restored

    # the (cached-mode) serving compile picks the tuned config without
    # measuring anything
    before = autotune.stats()["measured"]
    p = graph.compile(g, {"x": (2, 300)}, lowering="kernel",
                      block_configs="auto", device="cpu")
    assert autotune.stats()["measured"] == before
    x = RNG.standard_normal((2, 300)).astype(np.float32)
    np.testing.assert_allclose(
        p(torch.from_numpy(x)).numpy(),
        np.stack([np.convolve(r, taps, mode="valid") for r in x]),
        rtol=TOL, atol=TOL)


def test_dsp_serve_cli_new_pipeline(tmp_path, monkeypatch, capsys):
    """The launcher end to end on an OpDef-layer workload."""
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    monkeypatch.setenv("TINA_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    out = dsp_serve.main(["--pipeline", "correlate", "--requests", "6",
                          "--batch", "2", "--signal-len", "128",
                          "--check", "2", "--device", "cpu"])
    assert out["served"] == 6 and out["checked"] == 2
    assert out["compiled_while_serving"] == 0
    assert "2 response(s) verified" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--mesh", "2"], ["--devices", "4"]])
def test_dsp_serve_mesh_flags_not_yet_ported(flag):
    """Ported: ``--mesh N`` takes N of the devices ``--devices`` gives
    (logical shards under ``--device cpu``, one without it); with its
    partner each flag serves oracle-checked responses."""
    if flag[0] == "--mesh":
        with pytest.raises(ValueError, match="2 devices requested, 1 "
                                             "available"):
            dsp_serve.main(["--device", "cpu", *flag])
        flag = [*flag, "--devices", "2"]
    else:
        flag = [*flag, "--mesh", "4"]
    out = dsp_serve.main(["--device", "cpu", *flag, "--batch", "4",
                          "--requests", "8", "--signal-len", "1024",
                          "--check", "2"])
    assert out["served"] == 8 and out["checked"] == 2


def test_dsp_serve_continuous_kernel_int8_tenants(capsys):
    out = dsp_serve.main(["--pipeline", "pfb_power", "--device", "cpu",
                          "--lowering", "kernel", "--precision", "int8",
                          "--batching", "continuous", "--batch", "4",
                          "--signal-len", "512", "--requests", "10",
                          "--tenants", "fir_decimate", "--priority", "mix",
                          "--check", "4"])
    assert out["served"] == 10 and out["checked"] == 4
    s = out["stats"]
    assert s["priorities"] == {"rt": 5, "batch": 5}
    assert s["tenants"]["fir_decimate"]["requests"] == 5
    assert "min SQNR" in capsys.readouterr().out


def test_dsp_serve_async_and_trace(tmp_path):
    path = tmp_path / "serve.json"
    was_on = __import__("repro_torch").obs.REGISTRY.enabled
    try:
        out = dsp_serve.main(["--pipeline", "spectrogram", "--device",
                              "cpu", "--batching", "continuous", "--async",
                              "--requests", "9", "--batch", "4",
                              "--signal-len", "256", "--trace",
                              str(path)])
    finally:
        if not was_on:
            __import__("repro_torch").obs.REGISTRY.disable()
    assert out["served"] == 9
    from repro_torch import tina
    assert tina.main(["trace", str(path), "--require", "service.dispatch",
                      "service.device_run"]) == 0


def test_dsp_serve_torch_profiler(tmp_path):
    """The profiler brackets the serving window: a trace file, and the
    five host ops with the most self time per batch."""
    out = dsp_serve.main(["--pipeline", "spectrogram", "--device", "cpu",
                          "--lowering", "kernel", "--requests", "8",
                          "--batch", "4", "--signal-len", "256",
                          "--torch-profiler", str(tmp_path / "prof")])
    prof = out["profile"]
    assert os.path.isfile(prof["trace"])
    assert prof["batches"] == out["stats"]["batches"] == 2
    assert 1 <= len(prof["top_host_ops"]) <= 5
    us = [r["self_host_us_per_batch"] for r in prof["top_host_ops"]]
    assert us == sorted(us, reverse=True) and us[0] > 0


# ---------------------------------------------------------------------------
# compile -> autotune -> stream -> serve, one flow
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NEW_PIPELINES)
def test_new_pipeline_end_to_end(name, monkeypatch, tmp_path):
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    monkeypatch.setenv("TINA_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    spec = PIPELINES[name]
    n = spec.valid_len(1024)
    (x,) = spec.make_args(RNG, 1024)
    g = spec.build()
    xt = torch.from_numpy(np.asarray(x))

    # autotuned compile (cached mode: deterministic defaults)
    p = graph.compile(g, {g.inputs[0]: tuple(xt.shape)}, lowering="auto",
                      device="cpu")
    np.testing.assert_allclose(p(xt).numpy(), spec.oracle(x), rtol=TOL,
                               atol=TOL)

    # chunked streaming == offline
    offline = graph.compile(g, {g.inputs[0]: tuple(xt.shape)},
                            device="cpu")(xt).numpy()
    got = graph.stream_execute(g, x, 300, device="cpu").numpy()
    np.testing.assert_allclose(got, offline, rtol=1e-6, atol=1e-6)

    # batched serving matches the oracle; no plan compiled while serving
    xs = [spec.make_args(RNG, 1024)[0] for _ in range(3)]
    svc = graph.PipelineService(g, signal_len=n, batch_size=2,
                                device="cpu")
    misses = graph.cache_stats()["misses"]
    futs = [svc.submit(s) for s in xs]
    svc.flush()
    for s, f in zip(xs, futs):
        np.testing.assert_allclose(f.result(timeout=5), spec.oracle(s),
                                   rtol=TOL, atol=TOL)
    assert graph.cache_stats()["misses"] == misses


# ---------------------------------------------------------------------------
# the fault points serving consults (tests/test_faults.py's serving cases)
# ---------------------------------------------------------------------------
def _fires(mod, point="device_run", n=1, **kw):
    hits = 0
    for _ in range(n):
        try:
            mod.check(point, **kw)
        except mod.InjectedFault:
            hits += 1
    return hits


def test_kernel_tag_matches_only_its_tag(clean_faults):
    faults.configure("device_run@kernel:always")
    assert _fires(faults, tag="kernel", n=3) == 3
    assert _fires(faults, tag="reference", n=3) == 0
    assert _fires(faults, n=3) == 0          # untagged check: no match


def test_untagged_entry_matches_every_tag(clean_faults):
    faults.configure("device_run:once")
    assert _fires(faults, tag="kernel", n=3) == 1


def test_nan_spec_fires_only_on_poison_payload(clean_faults):
    faults.configure("device_run:nan")
    clean = np.ones(8, np.float32)
    poison = clean.copy()
    poison[3] = np.nan
    assert _fires(faults, payload=clean, n=5) == 0
    with pytest.raises(faults.InjectedFault) as ei:
        faults.check("device_run", payload=poison)
    assert ei.value.persistent and ei.value.point == "device_run"


def test_transient_faults_are_not_persistent(clean_faults):
    faults.configure("device_run:always")
    with pytest.raises(faults.InjectedFault) as ei:
        faults.check("device_run")
    assert not ei.value.persistent


@pytest.mark.parametrize("spec", ["device_run:0.3", "device_run:x3",
                                  "device_run@kernel:0.5"])
def test_fire_sequence_matches_jax_harness(clean_faults, spec):
    """Same spec and seed, same checks: the port's harness fires exactly
    where the JAX package's does (an entry's RNG is seeded from its text,
    tag included, so both get the same spec)."""
    jfaults.configure(spec, seed=42)
    faults.configure(spec, seed=42)
    want = [bool(_fires(jfaults, tag="kernel")) for _ in range(64)]
    got = [bool(_fires(faults, tag="kernel")) for _ in range(64)]
    assert got == want and any(got)


def test_service_validates_the_spec_at_construction(clean_faults,
                                                    monkeypatch):
    """A typo'd chaos spec fails the launch, not the Nth request."""
    monkeypatch.setenv(faults.ENV_VAR, "device_rnu:0.5")
    faults.reset()
    with pytest.raises(ValueError, match="unknown fault point"):
        PipelineService(PIPELINES["spectrogram"].build(), 256,
                        batch_size=2, device="cpu")


def test_staging_payload_poison_is_isolated(clean_faults, monkeypatch):
    """The chaos path end to end: TINA_FAULTS from the environment, the
    launcher's --poison rows fail typed, healthy rows are served."""
    monkeypatch.setenv(faults.ENV_VAR, "device_run:nan")
    faults.reset()
    out = dsp_serve.main(["--pipeline", "spectrogram", "--device", "cpu",
                          "--batching", "continuous", "--lowering",
                          "kernel", "--requests", "12", "--batch", "4",
                          "--signal-len", "256", "--poison", "3"])
    s = out["stats"]
    assert out["served"] == 9 and s["quarantined"] == 3
    # the reference's rule: each poisoned batch is a failed dispatch of
    # its bucket, and the third in a row degrades the bucket (how the
    # batcher thread groups the poison depends on arrival timing)
    assert 1 <= s["failed_batches"] <= 3
    down = out["downgrades"]["default"]
    assert set(down.values()) <= {"kernel"}
    assert len(down) == s["degraded"] <= s["failed_batches"] // 3


def test_replay_after_fault_run_is_bit_exact(clean_faults):
    faults.configure("device_run:0.4", seed=5)
    spec = PIPELINES["correlate"]
    svc = PipelineService(spec.build(), 256, batch_size=4,
                          batching="continuous", lowering="kernel",
                          record_batches=True, retry_backoff_ms=0.0,
                          device="cpu")
    xs = [RNG.standard_normal(256).astype(np.float32) for _ in range(14)]
    with svc:
        futs = [svc.submit(x) for x in xs]
        for f in futs:
            f.exception(timeout=60)
    served = sum(f.exception(timeout=0) is None for f in futs)
    assert svc.stats()["retries"] >= 1
    assert replay_batches(svc) == served
