"""The port's measuring autotuner (``repro_torch.graph.autotune``) and the
``"auto"`` compile options, on the CPU -- the cases of the JAX suite's
``tests/test_autotune.py`` (and the precision-auto cases of
``tests/test_precision.py``) that apply to the port.

Every case runs in an isolated cache (``tune_env``) and, where it is
about what the tuner decides rather than about timing, with
``measure`` replaced by :func:`_fake_measure`: it still calls the
candidate once (so a candidate that raises still raises), and answers a
scripted or constant time, so the decisions are deterministic.  This
file imports neither JAX nor the JAX package; its ``cuda``-marked case
runs on the card with ``python -m pytest -q -m cuda
tests/test_torch_autotune.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import graph, obs
from repro_torch.core.opdefs import OPDEFS, Budget, sqnr_db
from repro_torch.core.registry import PIPELINES, pipelines
from repro_torch.graph import autotune, plan as plan_lib
from repro_torch.kernels import fir as fir_kernel
from repro_torch.kernels import ops
from repro_torch.kernels import tune as ktune

pipelines()
ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(3)
CPU = {"device": "cpu"}


@pytest.fixture()
def tune_env(tmp_path, monkeypatch):
    """Isolated autotune cache + explicit mode, clean in-process state."""
    cache = tmp_path / "autotune_torch.json"
    monkeypatch.setenv("TINA_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv("TINA_AUTOTUNE", "on")
    autotune._MEM.clear()
    plan_lib.clear_cache()
    return cache


def _fake_measure(times=None, default=1e-3):
    """A stand-in for ``autotune.measure``: one call of the candidate
    (ValueError -> inf, as the real one), then the next scripted time."""
    it = iter(times or ())

    def measure(fn, args, **kw):
        try:
            fn(*args)
        except ValueError:
            return float("inf")
        return next(it, default)
    return measure


@pytest.fixture()
def fake(monkeypatch):
    """Install :func:`_fake_measure` with a constant time."""
    monkeypatch.setattr(autotune, "measure", _fake_measure())


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*a, **kw)


def _spec():
    return PIPELINES["spectrogram"].build()


def _one_fir(name="one_fir"):
    g = graph.Graph(name)
    g.output(g.apply("fir", g.input("x"),
                     g.const(np.hanning(31).astype(np.float32), "taps")))
    return g


def _one_matmul(n=64):
    g = graph.Graph("one_qmm")
    w = RNG.standard_normal((n, n)).astype(np.float32)
    g.output(g.apply("matmul", g.input("x"), g.const(w, "w")))
    return g


def _avals(g, shape):
    return plan_lib.infer(g, plan_lib._norm_specs(g, {"x": shape},
                                                  "float32"))


# ---------------------------------------------------------------------------
# TINA_AUTOTUNE modes
# ---------------------------------------------------------------------------
def _unmeasured_defaults(p) -> bool:
    """Every node at its fixed default: the kernel at its default tile
    where the op has one, else native."""
    return all(lw == ("kernel" if "kernel" in OPDEFS[p.graph.nodes[n].op]
                      .lowerings else "native")
               and not p.configs.get(n) for n, lw in p.lowerings.items())


def test_mode_off_uses_fixed_defaults(tune_env, fake, monkeypatch):
    monkeypatch.setenv("TINA_AUTOTUNE", "off")
    before = autotune.stats()["measured"]
    p = graph.compile(_spec(), {"x": (300,)}, lowering="auto", **CPU)
    assert autotune.stats()["measured"] == before
    assert _unmeasured_defaults(p)
    assert "kernel" in p.lowerings.values()
    assert not tune_env.exists()
    x = RNG.standard_normal(300).astype(np.float32)
    want = graph.compile(_spec(), {"x": (300,)}, lowering="kernel", **CPU)
    assert torch.equal(p(x), want(x))


def test_every_candidate_inf_answers_the_kernel(tune_env, monkeypatch):
    """When no candidate fits a measurement (all ``inf``), the tuner's
    answer is still the kernel at its default tile, not native."""
    monkeypatch.setattr(autotune, "measure",
                        lambda fn, args, **kw: float("inf"))
    g = _one_fir("one_fir_all_inf")
    avals = _avals(g, (600,))
    node = next(n for n in g.topo() if n.op == "fir")
    assert autotune.pick(g, node, avals, **CPU) == ("kernel", {})


def test_mode_cached_never_measures(tune_env, fake, monkeypatch):
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    before = autotune.stats()["measured"]
    p = graph.compile(_spec(), {"x": (300,)}, lowering="auto", **CPU)
    assert autotune.stats()["measured"] == before
    assert not tune_env.exists()        # nothing persisted either
    x = RNG.standard_normal(300).astype(np.float32)
    np.testing.assert_allclose(p(x).numpy(),
                               PIPELINES["spectrogram"].oracle(x),
                               rtol=2e-3, atol=2e-3)


def test_mode_on_measures_and_cached_then_reuses(tune_env, monkeypatch):
    # decisive kernel wins: the scripted times make the tuner pick kernel
    # for every node, so the replay must find non-default winners on disk
    monkeypatch.setattr(autotune, "measure", _fake_measure(
        [1.0, 2.0, 0.1] * 8, default=1.0))
    g = _spec()
    p1 = graph.compile(g, {"x": (300,)}, lowering="auto",
                       autotune_kwargs={"repeats": 1}, **CPU)
    assert tune_env.exists()
    assert "kernel" in p1.lowerings.values()
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    monkeypatch.setattr(autotune, "measure",
                        lambda *a, **k: pytest.fail("measured in cached"))
    autotune._MEM.clear()
    plan_lib.clear_cache()
    before = autotune.stats()["measured"]
    p2 = graph.compile(g, {"x": (300,)}, lowering="auto",
                       autotune_kwargs={"repeats": 1}, **CPU)
    assert autotune.stats()["measured"] == before
    assert p2.lowerings == p1.lowerings and p2.configs == p1.configs


def test_mode_invalid_raises(monkeypatch):
    monkeypatch.setenv("TINA_AUTOTUNE", "sometimes")
    with pytest.raises(ValueError, match="TINA_AUTOTUNE"):
        autotune.mode()


def test_cache_file_and_key_are_the_ports_own(tune_env, monkeypatch):
    """The default file is not the JAX package's, and a key names the
    card: a winner measured on one card is not taken on another."""
    monkeypatch.delenv("TINA_AUTOTUNE_CACHE")
    assert autotune.cache_path().endswith(
        os.path.join(".cache", "tina", "autotune_torch.json"))
    assert autotune.backend_of("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert autotune.backend_of(torch.device("cuda", 0)) == \
        "cuda:NVIDIA H100 80GB HBM3"
    g = _one_fir()
    node = next(n for n in g.topo() if n.op == "fir")
    av = _avals(g, (600,))
    key = autotune.node_key(node, [av[i] for i in node.inputs], "cpu")
    assert key.startswith("fir|(600,):torch.float32,(31,):torch.float32|")
    assert key.endswith("|cpu")


# ---------------------------------------------------------------------------
# cache schema: v1 migration, mtime invalidation, quarantine, IO faults
# ---------------------------------------------------------------------------
def test_cache_v1_entries_migrate_and_are_honored(tune_env, fake,
                                                  monkeypatch):
    g = graph.build_fir_decimate(taps1=31, taps2=15)
    avals = _avals(g, (600,))
    v1 = {}
    for node in g.topo():
        if node.op == "fir":
            key = autotune.node_key(
                node, [avals[i] for i in node.inputs], "cpu")
            v1[key] = {"lowering": "conv", "backend": "cpu"}
    tune_env.write_text(json.dumps(v1))
    autotune._MEM.clear()

    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    p = graph.compile(g, {"x": (600,)}, lowering="auto", **CPU)
    fir_lw = [p.lowerings[n.name] for n in p.graph.topo() if n.op == "fir"]
    assert fir_lw == ["conv", "conv"]   # the v1 winners, not defaults
    assert all(not c for c in p.configs.values())

    # a later save upgrades the file, keeping the v1 entries
    monkeypatch.setenv("TINA_AUTOTUNE", "on")
    autotune._save(str(tune_env), {"new_key": {"lowering": "native",
                                               "config": {}}})
    raw = json.load(open(tune_env))
    assert raw["schema"] == autotune.SCHEMA_VERSION
    assert set(v1) | {"new_key"} == set(raw["entries"])


def test_mem_cache_invalidated_on_mtime_change(tune_env):
    autotune._save(str(tune_env), {"a": {"lowering": "native", "config": {}}})
    assert set(autotune._load(str(tune_env))) == {"a"}
    # another process rewrites the file: same path, new content + mtime
    tune_env.write_text(json.dumps(
        {"schema": 2, "entries": {"b": {"lowering": "conv", "config": {}}}}))
    os.utime(tune_env, ns=(1, int(os.stat(tune_env).st_mtime_ns) + 10 ** 9))
    assert set(autotune._load(str(tune_env))) == {"b"}


@pytest.mark.parametrize("garbage, why", [
    ("{not json", "unparseable JSON"),
    ("[1, 2, 3]", "not a JSON object"),
    (json.dumps({"schema": 2, "entries": [1]}), "not an object"),
], ids=["bad-json", "non-dict", "bad-entries"])
def test_corrupt_cache_quarantined_to_bak(tune_env, garbage, why):
    tune_env.write_text(garbage)
    before = autotune.stats()["cache_corrupt"]
    with pytest.warns(UserWarning, match=why):
        entries = autotune._read_file(str(tune_env))
    assert entries == {}
    assert autotune.stats()["cache_corrupt"] == before + 1
    bak = tune_env.with_suffix(tune_env.suffix + ".bak")
    assert bak.read_text() == garbage       # evidence preserved
    assert not tune_env.exists()            # fresh start
    autotune._save(str(tune_env), {"k": {"lowering": "native",
                                         "config": {}}})
    assert json.load(open(tune_env))["schema"] == autotune.SCHEMA_VERSION


def test_missing_cache_is_not_corrupt(tune_env):
    before = autotune.stats()["cache_corrupt"]
    assert autotune._read_file(str(tune_env)) == {}
    assert autotune.stats()["cache_corrupt"] == before


def test_cache_io_fault_falls_back_to_memory(tune_env):
    from repro_torch.obs import faults
    tune_env.write_text(json.dumps({"schema": 2, "entries": {
        "k": {"lowering": "conv", "config": {}}}}))
    faults.configure("cache_io:x2", seed=0)
    try:
        assert autotune._read_file(str(tune_env)) == {}     # injected read
        autotune._save(str(tune_env), {"j": {"lowering": "native",
                                             "config": {}}})  # injected write
        assert tune_env.exists()            # file untouched, not .bak'd
        assert set(autotune._read_file(str(tune_env))) == {"k"}
    finally:
        faults.reset()


def test_stale_cached_config_falls_back_not_crashes(tune_env, fake,
                                                    monkeypatch):
    """A persisted config the current TuneSpace rejects is ignored, not
    fed to the kernel boundary where it would raise."""
    g = _one_fir("one_fir_stale")
    avals = _avals(g, (600,))
    node = next(n for n in g.topo() if n.op == "fir")
    key = autotune.node_key(node, [avals[i] for i in node.inputs],
                            "cpu") + "|only=kernel"
    tune_env.write_text(json.dumps({"schema": 2, "entries": {key: {
        "lowering": "kernel", "config": {"bn": 1024, "threads": 128},
        "backend": "cpu"}}}))
    autotune._MEM.clear()
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    stale = autotune.stats()["stale"]
    p = graph.compile(g, {"x": (600,)}, lowering="kernel",
                      block_configs="auto", **CPU)
    assert all(not c for c in p.configs.values())   # defaults, no crash
    assert autotune.stats()["stale"] == stale + 1
    p(RNG.standard_normal(600).astype(np.float32))


# ---------------------------------------------------------------------------
# candidates: never an invalid config, restrictions honoured
# ---------------------------------------------------------------------------
def test_tuner_never_selects_invalid_config(tune_env, monkeypatch):
    """Candidates failing the validity predicate are filtered before
    measurement, even if the declared candidate list holds them."""
    sp = dataclasses.replace(
        fir_kernel.TUNE_SPACE,
        candidates=lambda ctx: ({"bn": 1000, "threads": 128},   # invalid
                                {"bn": 4096, "threads": 256}))  # valid
    monkeypatch.setitem(ktune.SPACES, "fir", sp)
    # the valid non-default tile wins its scan and its playoff
    monkeypatch.setattr(autotune, "measure", _fake_measure([2.0, 1.0]))
    monkeypatch.setattr(autotune, "_playoff", lambda a, b, args, **k:
                        (2.0, 1.0))
    taps = np.hanning(31).astype(np.float32)
    g = _one_fir()
    p = graph.compile(g, {"x": (600,)}, lowering="kernel",
                      block_configs="auto", autotune_kwargs={"repeats": 1},
                      **CPU)
    (cfg,) = [c for c in p.configs.values() if c]
    assert cfg == {"bn": 4096, "threads": 256}
    entries = json.load(open(tune_env))["entries"]
    assert entries
    for entry in entries.values():
        assert not any("bn=1000" in label for label in entry["times_us"])
    x = RNG.standard_normal(600).astype(np.float32)
    np.testing.assert_allclose(p(x).numpy(),
                               np.convolve(x, taps, mode="valid"),
                               rtol=2e-3, atol=2e-3)


def test_default_tile_kept_inside_the_playoff_margin(tune_env, monkeypatch):
    """A scan winner only marginally faster than the default tile loses
    the interleaved playoff (PLAYOFF_MARGIN hysteresis)."""
    monkeypatch.setattr(autotune, "measure", _fake_measure([2.0, 1.0]))
    monkeypatch.setattr(autotune, "_playoff", lambda a, b, args, **k:
                        (1.0, 0.99))
    p = graph.compile(_one_fir("one_fir_margin"), {"x": (600,)},
                      lowering="kernel", block_configs="auto", **CPU)
    (cfg,) = p.configs.values()
    assert cfg == fir_kernel.TUNE_SPACE.default({"k": 31})


def test_restricted_candidates_honored_in_cached_mode(tune_env, fake,
                                                      monkeypatch):
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    g = graph.build_fir_decimate()
    avals = _avals(g, (600,))
    node = next(n for n in g.topo() if n.op == "fir")
    lw, cfg = autotune.pick(g, node, avals, lowerings=("conv", "kernel"),
                            **CPU)
    assert (lw, cfg) == ("kernel", {})
    lw, cfg = autotune.pick(g, node, avals, lowerings=("conv", "native"),
                            **CPU)
    assert (lw, cfg) == ("native", {})


def test_explicit_block_configs_win_over_tuned(tune_env, fake):
    g = graph.build_fir_decimate(taps1=31, taps2=15)
    names = [n.name for n in g.topo() if n.op == "fir"]
    cfgs = {names[0]: {"bn": 4096, "threads": 256}}
    p = graph.compile(g, {"x": (600,)}, lowering="auto",
                      block_configs=cfgs, **CPU)
    assert p.configs[names[0]] == {"bn": 4096, "threads": 256}
    x = RNG.standard_normal(600).astype(np.float32)
    np.testing.assert_allclose(p(x).numpy(),
                               PIPELINES["fir_decimate"].oracle(x),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# a broken kernel is never hidden behind another lowering
# ---------------------------------------------------------------------------
def test_kernel_error_propagates_from_lowering_auto(tune_env, monkeypatch):
    """A kernel that fails to build or launch raises RuntimeError: the
    tuner must not answer native in its place."""
    def broken(*a, **k):
        raise RuntimeError("tina_pfb: CUDA error 700 at launch")
    monkeypatch.setattr(ops, "pfb", broken)
    g = graph.build_pfb_power(16, 8)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        graph.compile(g, {"x": (16 * 32,)}, lowering="auto",
                      autotune_kwargs={"repeats": 1}, **CPU)
    plan_lib.clear_cache()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        graph.compile(g, {"x": (16 * 32,)}, lowering="kernel",
                      precision="auto", autotune_kwargs={"repeats": 1},
                      **CPU)


def test_shape_misfit_measures_inf_and_faults_too(tune_env):
    """What measure swallows: a candidate that does not fit the shapes
    (ValueError) and an injected autotune_measure fault."""
    from repro_torch.obs import faults

    def misfit():
        raise ValueError("taps do not fit")
    assert autotune.measure(misfit, ()) == float("inf")
    with pytest.raises(RuntimeError, match="boom"):
        autotune.measure(lambda: (_ for _ in ()).throw(RuntimeError("boom")),
                         ())
    faults.configure("autotune_measure:once", seed=0)
    try:
        assert autotune.measure(lambda: None, ()) == float("inf")
    finally:
        faults.reset()
    t = autotune.measure(lambda: None, (), repeats=2)
    assert 0.0 <= t < 1.0


def test_measure_prunes_after_one_repeat_above_incumbent():
    calls = []
    pruned = autotune.stats()["pruned"]
    autotune.measure(lambda: calls.append(1), (), repeats=5, warmup=1,
                     prune_above=-1.0)
    assert len(calls) == 2                  # warm-up + one timed repeat
    assert autotune.stats()["pruned"] == pruned + 1


def test_dummy_inputs_are_seeded_and_typed():
    meta = torch.empty((3, 5), dtype=torch.complex64, device="meta")
    a, b = autotune._dummy(meta, "cpu"), autotune._dummy(meta, "cpu")
    assert a.dtype == torch.complex64 and a.shape == (3, 5)
    assert torch.equal(a, b)
    r = autotune._dummy(torch.empty(4, device="meta"), "cpu")
    assert torch.equal(r, a.real.reshape(-1)[:4])


# ---------------------------------------------------------------------------
# precision="auto": budget-gated joint search
# ---------------------------------------------------------------------------
def test_pick_joint_rejects_budget_violations(tune_env, fake, monkeypatch):
    """An impossible budget forces the f32 answer, and the measured
    verdict (ok=False) is persisted."""
    monkeypatch.setitem(
        OPDEFS, "matmul",
        dataclasses.replace(OPDEFS["matmul"],
                            budgets=(("bf16", Budget(sqnr_db=1000.0)),
                                     ("int8", Budget(sqnr_db=1000.0)))))
    g = _one_matmul()
    avals = _avals(g, (8, 64))
    node = next(n for n in g.topo() if n.op == "matmul")
    lw, cfg, prec = autotune.pick_joint(g, node, avals, repeats=1, **CPU)
    assert prec == "f32"
    entries = autotune._load(str(tune_env))
    (key,) = [k for k in entries if k.endswith("|prec=auto")]
    acc = entries[key]["accuracy"]
    assert acc["int8"]["ok"] is False and acc["bf16"]["ok"] is False
    assert entries[key]["precision"] == "f32"


def test_pick_joint_takes_a_faster_tier_within_budget(tune_env,
                                                      monkeypatch):
    """f32 at 1.0, bf16 at 0.5, int8 at 0.9: bf16 passes its budget and
    wins; the times and achieved SQNR are stored beside the winner."""
    monkeypatch.setattr(autotune, "measure", _fake_measure(
        [1.0, 0.5, 0.9], default=0.9))
    g = _one_matmul()
    avals = _avals(g, (8, 64))
    node = next(n for n in g.topo() if n.op == "matmul")
    lw, cfg, prec = autotune.pick_joint(g, node, avals, repeats=1,
                                        lowerings=("native",), **CPU)
    assert (lw, prec) == ("native", "bf16")
    (entry,) = [v for k, v in autotune._load(str(tune_env)).items()
                if k.endswith("|prec=auto")]
    assert entry["accuracy"]["bf16"]["ok"] is True
    assert entry["accuracy"]["bf16"]["sqnr_db"] >= 30.0
    assert set(entry["times_us"]) >= {"f32:native", "bf16:native"}


def test_precision_auto_plan_honors_budgets(tune_env, monkeypatch):
    """compile(..., precision="auto") end to end: whatever tier wins per
    node, every probed tier in the cache carries a budget verdict, a
    winner is never one that failed it, and a cached replay resolves the
    same plan without measuring."""
    monkeypatch.setattr(autotune, "measure", _fake_measure(
        [1.0, 0.5, 0.4, 0.3] * 20, default=0.3))
    spec = PIPELINES["pfb_power"]
    g = spec.build()
    (x,) = spec.make_args(RNG, 1024)
    p = _quiet(graph.compile, g, {"x": x.shape}, lowering="auto",
               precision="auto", autotune_kwargs={"repeats": 1}, **CPU)
    q = sqnr_db(spec.oracle(x), p(x).numpy())
    assert q >= 26.0, (p.precisions, q)
    entries = autotune._load(str(tune_env))
    joint = {k: v for k, v in entries.items() if k.endswith("|prec=auto")}
    assert joint, "precision=auto persisted no joint entries"
    for k, v in joint.items():
        for tier, verdict in v.get("accuracy", {}).items():
            if v["precision"] == tier:
                assert verdict["ok"] is True, (k, tier, verdict)
    m0 = autotune.stats()["measured"]
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    plan_lib.clear_cache()
    p2 = _quiet(graph.compile, g, {"x": x.shape}, lowering="auto",
                precision="auto", autotune_kwargs={"repeats": 1}, **CPU)
    assert autotune.stats()["measured"] == m0
    assert p2.precisions == p.precisions and p2.lowerings == p.lowerings


def test_int8_winners_cached_under_distinct_prec_keys(tune_env, fake,
                                                      monkeypatch):
    g = _one_matmul()
    shapes = {"x": (32, 64)}
    graph.compile(g, shapes, lowering="auto",
                  autotune_kwargs={"repeats": 1}, **CPU)
    p8 = graph.compile(g, shapes, lowering="auto", precision="int8",
                       autotune_kwargs={"repeats": 1}, **CPU)
    entries = json.load(open(tune_env))["entries"]
    int8_keys = [k for k in entries if k.endswith("|prec=int8")]
    f32_keys = [k for k in entries if "|prec=" not in k]
    assert len(int8_keys) == 1 and len(f32_keys) == 1
    assert int8_keys[0] == f32_keys[0] + "|prec=int8"
    labels = entries[int8_keys[0]]["times_us"]
    assert any(lbl.startswith("kernel[") for lbl in labels)
    assert set(p8.node_precisions.values()) == {"int8"}
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    autotune._MEM.clear()
    plan_lib.clear_cache()
    before = autotune.stats()["measured"]
    p8b = graph.compile(g, shapes, lowering="auto", precision="int8",
                        autotune_kwargs={"repeats": 1}, **CPU)
    assert autotune.stats()["measured"] == before
    assert p8b.lowerings == p8.lowerings and p8b.configs == p8.configs


# ---------------------------------------------------------------------------
# fuse="auto": fused against unfused per chain
# ---------------------------------------------------------------------------
def _fused(p):
    return any(n.op == "fused_ew" for n in p.graph.topo())


def test_fusion_verdict_measured_persisted_and_replayed(tune_env,
                                                       monkeypatch):
    g = graph.build_spectrogram(window=64)       # abs2 -> scale chain
    # pick_fusion measures fused first, unfused second: unfused by 2x
    monkeypatch.setattr(autotune, "measure", _fake_measure([1.0, 0.4],
                                                           default=0.4))
    p = graph.compile(g, {"x": (300,)}, fuse="auto",
                      autotune_kwargs={"repeats": 1}, **CPU)
    assert not _fused(p)
    entries = json.load(open(tune_env))["entries"]
    fkeys = [k for k in entries if k.startswith("fusion|")]
    assert fkeys and entries[fkeys[0]]["fused"] is False
    assert entries[fkeys[0]]["times_us"]["unfused"] < \
        entries[fkeys[0]]["times_us"]["fused"]
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    monkeypatch.setattr(autotune, "measure",
                        lambda *a, **k: pytest.fail("measured in cached"))
    autotune._MEM.clear()
    plan_lib.clear_cache()
    assert not _fused(graph.compile(g, {"x": (300,)}, fuse="auto", **CPU))


def test_fusion_auto_keeps_fused_when_not_decisively_slower(tune_env,
                                                           monkeypatch):
    monkeypatch.setattr(autotune, "measure", _fake_measure([1.0, 0.99],
                                                           default=0.99))
    p = graph.compile(graph.build_spectrogram(window=64), {"x": (300,)},
                      fuse="auto", autotune_kwargs={"repeats": 1}, **CPU)
    assert _fused(p)
    entries = json.load(open(tune_env))["entries"]
    (fe,) = [v for k, v in entries.items() if k.startswith("fusion|")]
    assert fe["fused"] is True


def test_fusion_auto_off_and_cold_cached_keep_fused_default(tune_env, fake,
                                                            monkeypatch):
    for m in ("off", "cached"):
        monkeypatch.setenv("TINA_AUTOTUNE", m)
        plan_lib.clear_cache()
        p = graph.compile(graph.build_spectrogram(window=64),
                          {"x": (300,)}, fuse="auto", **CPU)
        assert _fused(p), m
        assert not tune_env.exists()


def test_fuse_default_resolves_to_auto_for_auto_plans(tune_env, fake,
                                                      monkeypatch):
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")

    def verdicts():
        return (obs.counter("plan.fusion.fused").value,
                obs.counter("plan.fusion.unfused").value)

    g = graph.build_spectrogram(window=64)
    f0, u0 = verdicts()
    p = graph.compile(g, {"x": (512,)}, lowering="auto", **CPU)
    f1, u1 = verdicts()
    assert f1 > f0 and u1 == u0 and _fused(p)
    p3 = graph.compile(g, {"x": (640,)}, **CPU)    # not auto: no verdicts
    assert verdicts() == (f1, u1) and _fused(p3)


# ---------------------------------------------------------------------------
# plan cache: tuned plans are hits after the tuner writes, never stale
# ---------------------------------------------------------------------------
def test_auto_plan_cache_hit_after_tuning_writes(tune_env, fake):
    g = _spec()
    p1 = graph.compile(g, {"x": (300,)}, lowering="auto",
                       autotune_kwargs={"repeats": 1}, **CPU)
    assert tune_env.exists()
    p2 = graph.compile(g, {"x": (300,)}, lowering="auto",
                       autotune_kwargs={"repeats": 1}, **CPU)
    assert p2 is p1


def test_auto_plan_not_stale_across_mode_switch(tune_env, fake,
                                                monkeypatch):
    g = _spec()
    p_on = graph.compile(g, {"x": (300,)}, lowering="auto",
                         autotune_kwargs={"repeats": 1}, **CPU)
    monkeypatch.setenv("TINA_AUTOTUNE", "off")
    p_off = graph.compile(g, {"x": (300,)}, lowering="auto", **CPU)
    assert p_off is not p_on
    assert _unmeasured_defaults(p_off)


def test_auto_plans_do_not_pile_up_across_stream_windows(tune_env, fake):
    """Each tuner write bumps the cache file's mtime; the tuned plan it
    orphans (same shapes and options, older mtime) leaves the plan cache,
    so windows A, B, A keep one plan per window length."""
    g = _spec()
    kw = dict(lowering="auto", autotune_kwargs={"repeats": 1}, **CPU)
    graph.compile(g, {"x": (300,)}, **kw)                   # A: tunes
    size_a = plan_lib.cache_stats()["size"]
    mtime_a = autotune._mtime(str(tune_env))
    graph.compile(g, {"x": (556,)}, **kw)                   # B: tunes
    assert autotune._mtime(str(tune_env)) != mtime_a
    size_ab = plan_lib.cache_stats()["size"]
    assert size_ab == size_a + 1
    before = autotune.stats()["measured"]
    p_a = graph.compile(g, {"x": (300,)}, **kw)             # A again
    assert autotune.stats()["measured"] == before
    assert plan_lib.cache_stats()["size"] == size_ab
    assert graph.compile(g, {"x": (300,)}, **kw) is p_a


def test_streaming_with_tuned_plans_equals_offline(tune_env, fake):
    spec = PIPELINES["spectrogram"]
    (x,) = spec.make_args(RNG, 1024)
    g = spec.build()
    offline = graph.compile(g, {"x": x.shape}, **CPU)(x).numpy()
    got = graph.stream_execute(g, x, 400, lowering="auto",
                               autotune_kwargs={"repeats": 1}, **CPU)
    np.testing.assert_allclose(got.numpy(), offline, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the CLI, with real measurement
# ---------------------------------------------------------------------------
def test_cli_tunes_and_round_trips_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "TINA_AUTOTUNE": "on",
           "TINA_AUTOTUNE_CACHE": str(tmp_path / "cli.json")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.graph.autotune", "--pipeline",
         "spectrogram", "--n", "512", "--repeats", "1", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "cache roundtrip: OK (re-measured 0)" in r.stdout
    assert json.load(open(tmp_path / "cli.json"))["entries"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_cache_round_trip(tune_env, monkeypatch):
    """On the card: block configs of the kernel plan tuned with CUDA
    events, persisted under the card's name, replayed from ``cached``
    without measuring, and the replayed plan's output equal to the
    tuned one's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    g = graph.build_fir_decimate()
    shapes = {"x": (4, 1 << 16)}
    p1 = graph.compile(g, shapes, lowering="kernel", block_configs="auto",
                       autotune_kwargs={"repeats": 2})
    entries = json.load(open(tune_env))["entries"]
    name = torch.cuda.get_device_name(0)
    assert entries and all(k.endswith(f"cuda:{name}|only=kernel")
                           for k in entries)
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    autotune._MEM.clear()
    plan_lib.clear_cache()
    before = autotune.stats()["measured"]
    p2 = graph.compile(g, shapes, lowering="kernel", block_configs="auto",
                       autotune_kwargs={"repeats": 2})
    assert autotune.stats()["measured"] == before
    assert p2.configs == p1.configs
    x = torch.randn(shapes["x"], device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    assert torch.equal(p1(x), p2(x))


@pytest.mark.cuda
def test_cuda_unmeasured_auto_plan_launches_the_kernels(tune_env,
                                                        monkeypatch):
    """On the card: a ``lowering="auto"`` plan under ``TINA_AUTOTUNE=off``
    measures nothing and runs the path's kernels (the PFB and the abs2
    chain), equal to the kernel plan bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.kernels import elementwise as ewk
    from repro_torch.kernels import pfb as pfbk
    monkeypatch.setenv("TINA_AUTOTUNE", "off")
    g = graph.build_pfb_power(256, 8)
    shapes = {"x": (4, 256 * 64)}
    before = autotune.stats()["measured"]
    p = graph.compile(g, shapes, lowering="auto")
    assert autotune.stats()["measured"] == before and not tune_env.exists()
    assert _unmeasured_defaults(p)
    x = torch.randn(shapes["x"], device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    pfbk.LAUNCHES = ewk.LAUNCHES = 0
    got = p(x)
    assert (pfbk.LAUNCHES, ewk.LAUNCHES) == (1, 1)
    want = graph.compile(g, shapes, lowering="kernel")
    assert torch.equal(got, want(x))
