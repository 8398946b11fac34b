"""The port's serving API on the CPU: the twin of
``tests/test_serving_api.py`` -- ``CompileOptions`` as the one front
door, the double-buffered scheduler's telemetry contract, multi-tenant
priority serving, the asyncio surface -- and the ``python -m
repro_torch.tina`` umbrella CLI, whose routes name only the port's
modules.

The port's ``compile`` takes keyword arguments naming the options'
fields as a first-class spelling (applied over ``options=``), where the
reference has a deprecated shim; the twins hold the port to its own
rule: both spellings reach one cached plan, and the service and the
runner (which the reference holds to one spelling at a time) refuse a
mix.  Responses are held to the numpy oracle within 2e-3, the JAX
suite's pipeline tolerance.
"""
import asyncio
import importlib
import time
import warnings

import numpy as np
import pytest

from repro_torch import graph, obs
from repro_torch.core.registry import PIPELINES, pipelines
from repro_torch.graph.plan import CompileOptions
from repro_torch.graph.service import (PRIORITIES, PipelineService,
                                       replay_batches)
from repro_torch.graph.stream import ChunkedRunner
from repro_torch.obs.trace import validate_nesting

pipelines()
RNG = np.random.default_rng(31)
TOL = 2e-3

pytestmark = pytest.mark.timeout(120)


def _signals(n_req, n=256):
    return [RNG.standard_normal(n).astype(np.float32) for _ in range(n_req)]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# CompileOptions: one object, one cache key
# ---------------------------------------------------------------------------
def test_compile_options_and_keyword_spelling_share_plans():
    g = PIPELINES["spectrogram"].build()
    shapes = {g.inputs[0]: (512,)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no shim, no warning
        p1 = graph.compile(g, shapes, lowering="native", device="cpu")
        p2 = graph.compile(g, shapes, options=CompileOptions(
            lowering="native", device="cpu"))
    assert p1 is p2
    # keywords apply over options= in the port: the same cache entry
    assert graph.compile(g, shapes, options=CompileOptions(device="cpu"),
                         lowering="native") is p1


def test_compile_options_replace_and_defaults():
    o = CompileOptions()
    assert o.dtype == "float32" and o.lowering == "native"
    assert o.device is None
    o2 = o.replace(precision="bf16")
    assert o2.precision == "bf16" and o2.device is None
    assert o.precision == "f32"                  # frozen: replace copies


def test_compile_rejects_unknown_and_mixed_kwargs():
    g = PIPELINES["spectrogram"].build()
    shapes = {g.inputs[0]: (512,)}
    with pytest.raises(TypeError, match="unexpected keyword"):
        graph.compile(g, shapes, bogus=1, device="cpu")
    with pytest.raises(TypeError, match="options="):
        ChunkedRunner(g, options=CompileOptions(device="cpu"),
                      lowering="native")
    with pytest.raises(TypeError, match="options="):
        PipelineService(g, signal_len=512,
                        options=CompileOptions(device="cpu"),
                        lowering="native")
    with pytest.raises(TypeError, match="dtype"):
        PipelineService(g, signal_len=512, dtype="float64",
                        options=CompileOptions(dtype="float32",
                                               device="cpu"))


def test_service_and_runner_build_on_compile_options():
    spec = PIPELINES["spectrogram"]
    opts = CompileOptions(lowering="native", device="cpu")
    svc = PipelineService(spec.build(), signal_len=256, batch_size=4,
                          batching="continuous", options=opts)
    r = ChunkedRunner(spec.build(), options=opts)
    x = _signals(1, 1024)[0]
    out = r.run(x, chunk_len=300).numpy()
    fut = svc.submit(x[:256])
    svc.flush()
    _close(fut.result(timeout=30), spec.oracle(x[:256]))
    _close(out, spec.oracle(x))
    svc.close()


def test_stats_is_a_method():
    spec = PIPELINES["spectrogram"]
    svc = PipelineService(spec.build(), signal_len=256, batch_size=2,
                          device="cpu")
    s = svc.stats()
    assert isinstance(s, dict) and s["requests"] == 0
    assert set(s["host_ms"]) == {"pack", "copy_in", "plan", "copy_out",
                                 "deliver"}
    with pytest.raises(TypeError):
        svc.stats["requests"]                    # the old attribute form
    svc.close()


# ---------------------------------------------------------------------------
# overlapped scheduler: device spans on their own track, bitwise replay
# ---------------------------------------------------------------------------
def test_overlap_scheduler_device_spans_and_replay():
    was_on = obs.REGISTRY.enabled
    obs.REGISTRY.enable()
    ev0 = len(obs.REGISTRY.events())
    try:
        spec = PIPELINES["spectrogram"]
        svc = PipelineService(spec.build(), signal_len=256, batch_size=4,
                              batching="continuous", record_batches=True,
                              device="cpu")
        assert svc.overlap                       # continuous -> auto-on
        assert svc.plan is graph.compile(        # the offline plan
            svc.graph, {svc.graph.inputs[0]: (4, 256)}, device="cpu")
        xs = _signals(17)
        with svc:
            futs = [svc.submit(x) for x in xs]
            outs = [f.result(timeout=60) for f in futs]
        for x, o in zip(xs, outs):
            _close(o, spec.oracle(x))
        assert replay_batches(svc) == len(xs)    # bitwise per packing
        evs = obs.REGISTRY.events()[ev0:]
        runs = sorted((e for e in evs
                       if e["name"] == "service.device_run"),
                      key=lambda e: e["ts"])
        assert runs, "overlap mode must still emit device_run spans"
        assert all(e["tid"] == "device" for e in runs)
        for a, b in zip(runs, runs[1:]):
            assert b["ts"] >= a["ts"] + a["dur"] - 1e-6
        validate_nesting(evs)
        s = svc.stats()
        assert s["host_ms"]["plan"]["count"] == s["batches"]
        assert s["card_ms"]["plan"]["count"] == 0    # no card events here
    finally:
        if not was_on:
            obs.REGISTRY.disable()


def test_overlap_off_is_the_blocking_scheduler():
    spec = PIPELINES["spectrogram"]
    svc = PipelineService(spec.build(), signal_len=256, batch_size=4,
                          batching="continuous", overlap=False,
                          record_batches=True, device="cpu")
    assert not svc.overlap
    xs = _signals(9)
    with svc:
        outs = [f.result(timeout=60) for f in [svc.submit(x) for x in xs]]
    for x, o in zip(xs, outs):
        _close(o, spec.oracle(x))
    assert replay_batches(svc) == len(xs)


# ---------------------------------------------------------------------------
# multi-tenant priorities: fairness / starvation soak
# ---------------------------------------------------------------------------
def test_multi_tenant_priority_fairness_soak():
    spec_a = PIPELINES["spectrogram"]
    spec_b = PIPELINES["pfb_power"]
    svc = PipelineService(spec_a.build(), signal_len=256, batch_size=4,
                          batching="continuous", record_batches=True,
                          device="cpu")
    tb = svc.add_tenant("b", spec_b.build(), 512, record_batches=True)
    assert tb.device.type == "cpu"               # inherited the device
    lat = {}
    metas, futs = [], []
    for i in range(40):
        tn = None if i % 2 == 0 else "b"
        pr = "rt" if i % 4 < 2 else "batch"      # both tenants mix classes
        x = RNG.standard_normal(256 if tn is None else 512) \
               .astype(np.float32)
        t0 = time.perf_counter()
        fut = svc.submit(x, priority=pr, tenant=tn)
        fut.add_done_callback(
            lambda f, i=i, t0=t0: lat.__setitem__(
                i, time.perf_counter() - t0))
        metas.append((tn, pr, x))
        futs.append(fut)
    svc.start()
    for f in futs:
        f.result(timeout=120)                    # every future resolves
    svc.close()
    for (tn, pr, x), f in zip(metas, futs):
        spec = spec_a if tn is None else spec_b
        _close(f.result(timeout=0), spec.oracle(x))
    rt = [lat[i] for i, (_, pr, _x) in enumerate(metas) if pr == "rt"]
    bt = [lat[i] for i, (_, pr, _x) in enumerate(metas) if pr == "batch"]
    assert len(rt) == len(bt) == 20
    assert np.percentile(rt, 99) < np.percentile(bt, 99)
    assert replay_batches(svc, tenant="default") == 20
    assert replay_batches(svc, tenant="b") == 20
    s = svc.stats()
    assert s["priorities"] == {"rt": 20, "batch": 20}
    assert s["tenants"]["default"]["requests"] == 20
    assert s["tenants"]["b"]["requests"] == 20
    assert s["tenants"]["b"]["batches"] >= 1


def test_tenant_validation():
    spec = PIPELINES["spectrogram"]
    svc = PipelineService(spec.build(), signal_len=256, batch_size=2,
                          device="cpu")
    with pytest.raises(ValueError, match="already exists"):
        svc.add_tenant("default", spec.build(), 256)
    svc.add_tenant("t2", PIPELINES["pfb_power"].build(), 512)
    with pytest.raises(KeyError):
        svc.submit(np.zeros(256, np.float32), tenant="nope")
    with pytest.raises(ValueError, match="priority="):
        svc.submit(np.zeros(256, np.float32), priority="urgent")
    with pytest.raises(ValueError, match="512"):
        svc.submit(np.zeros(256, np.float32), tenant="t2")
    sharded = svc.add_tenant("sharded", spec.build(), 256, mesh=2)
    assert str(sharded.device) == "cpu" and sharded.mesh.size == 2
    with pytest.raises(ValueError, match="batch divisibility"):
        svc.add_tenant("odd", spec.build(), 256, mesh=4)
    assert tuple(PRIORITIES) == ("rt", "batch")
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.add_tenant("late", spec.build(), 256)


def test_int8_tenant_through_add_tenant():
    """The chip run's second tenant at small size: int8 kernel plans
    beside an f32 default, each tenant replaying bit for bit."""
    from repro_torch.core.opdefs import sqnr_db
    spec = PIPELINES["pfb_power"]
    svc = PipelineService(spec.build(), 512, batch_size=4,
                          batching="continuous", lowering="kernel",
                          record_batches=True, device="cpu")
    t8 = svc.add_tenant("pfb_int8", spec.build(), 512, lowering="kernel",
                        precision="int8")
    assert t8.device.type == "cpu"
    assert "int8" in t8.plan.precisions.values()
    xs = _signals(10, 512)
    with svc:
        f32 = [svc.submit(x, priority="rt") for x in xs[:5]]
        i8 = [svc.submit(x, tenant="pfb_int8") for x in xs[5:]]
        outs = [f.result(timeout=60) for f in f32 + i8]
    for x, o in zip(xs[:5], outs[:5]):
        _close(o, spec.oracle(x))
    for x, o in zip(xs[5:], outs[5:]):
        assert sqnr_db(spec.oracle(x), o) >= 26.0     # the pfb budget
    assert replay_batches(svc) == 10


# ---------------------------------------------------------------------------
# asyncio surface
# ---------------------------------------------------------------------------
def test_asyncio_soak_gather_100():
    spec = PIPELINES["spectrogram"]
    xs = _signals(100)

    async def soak():
        async with PipelineService(spec.build(), signal_len=256,
                                   batch_size=8, batching="continuous",
                                   device="cpu") as svc:
            outs = await asyncio.wait_for(asyncio.gather(
                *(svc.submit_async(x) for x in xs)), timeout=120)
            return svc, outs

    svc, outs = asyncio.run(soak())
    assert len(outs) == 100
    for x, o in zip(xs[:8], outs[:8]):
        _close(o, spec.oracle(x))
    assert svc.stats()["requests"] == 100


def test_asyncio_close_mid_flight_raises_cleanly():
    spec = PIPELINES["spectrogram"]
    xs = _signals(24)

    async def run():
        svc = PipelineService(spec.build(), signal_len=256, batch_size=4,
                              batching="continuous", device="cpu")
        async with svc:
            tasks = [asyncio.ensure_future(svc.submit_async(x))
                     for x in xs]
            await asyncio.sleep(0)               # let submissions land
        outs = await asyncio.wait_for(
            asyncio.gather(*tasks, return_exceptions=True), timeout=120)
        with pytest.raises(RuntimeError, match="service closed"):
            await svc.submit_async(xs[0])
        return outs

    outs = asyncio.run(run())
    assert len(outs) == 24
    assert not any(isinstance(o, Exception) for o in outs)
    for x, o in zip(xs, outs):
        _close(o, spec.oracle(x))


def test_async_priorities_compose():
    spec = PIPELINES["spectrogram"]
    xs = _signals(12)

    async def run():
        async with PipelineService(spec.build(), signal_len=256,
                                   batch_size=4, batching="continuous",
                                   device="cpu") as svc:
            outs = await asyncio.wait_for(asyncio.gather(
                *(svc.submit_async(x, priority=("rt" if i % 2 else
                                                "batch"))
                  for i, x in enumerate(xs))), timeout=120)
            return svc.stats()["priorities"], outs

    prios, outs = asyncio.run(run())
    assert prios == {"rt": 6, "batch": 6}
    for x, o in zip(xs, outs):
        _close(o, spec.oracle(x))


# ---------------------------------------------------------------------------
# umbrella CLI
# ---------------------------------------------------------------------------
def test_umbrella_cli_routes(tmp_path, capsys):
    from repro_torch import tina
    assert tina.main([]) == 0
    out = capsys.readouterr().out
    for cmd in ("serve", "tune", "trace"):
        assert cmd in out
    with pytest.raises(SystemExit, match="unknown command"):
        tina.main(["bogus"])
    was_on = obs.REGISTRY.enabled
    obs.REGISTRY.enable()
    try:
        with obs.span("cli.smoke", cat="test"):
            pass
        p = tmp_path / "t.json"
        obs.export_chrome_trace(str(p))
    finally:
        if not was_on:
            obs.REGISTRY.disable()
    assert tina.main(["trace", str(p), "--require", "cli.smoke"]) == 0
    assert "nested OK" in capsys.readouterr().out


def test_umbrella_cli_routes_only_to_the_port():
    """Every route is a module of the port: importable, with a main(),
    and never one of the JAX package's."""
    from repro_torch import tina
    from repro.tina import COMMANDS as JCOMMANDS
    assert set(tina.COMMANDS) == set(JCOMMANDS)
    for cmd, (mod, _) in tina.COMMANDS.items():
        assert mod.startswith("repro_torch."), (cmd, mod)
        assert not mod.startswith("repro."), (cmd, mod)
        assert callable(importlib.import_module(mod).main)
        # the same tool as the reference's route, under the port
        assert mod == "repro_torch." + JCOMMANDS[cmd][0].split(".", 1)[1]


def test_umbrella_cli_serves_on_the_cpu(capsys):
    from repro_torch import tina
    assert tina.main(["serve", "--pipeline", "spectrogram", "--device",
                      "cpu", "--requests", "6", "--batch", "2",
                      "--signal-len", "256", "--check", "3",
                      "--batching", "continuous"]) == 0
    out = capsys.readouterr().out
    assert "6/6 requests served" in out
    assert "3 response(s) verified" in out
