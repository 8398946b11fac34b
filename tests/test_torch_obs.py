"""The port's telemetry on the push path: ``ChunkedRunner``'s spans
(``stream.carry`` beside ``stream.push``; ``plan.lookup``, ``plan.run``
and one ``node.<op>`` a node inside it), the ``torch.profiler`` host
range each span opens on the profiler's clock, and the off mode, which
records and opens nothing.  The last test is marked ``cuda`` and skips
without a card; the file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_obs.py
"""
import gc
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import graph, obs
from repro_torch.obs import validate_nesting

PROGRAM = ("stream.", "plan.", "node.")


def _pfb_power(tag: str):
    """x -> pfb (P 16, M 4) -> abs2, with taps of its own: a graph whose
    first push misses the plan cache."""
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    g = graph.Graph(f"obs_{tag}")
    x = g.input("x")
    t = g.const(rng.standard_normal((4, 16)).astype(np.float32), "taps")
    g.output(g.apply("abs2", g.apply("pfb", x, t)))
    return g


def _chunk(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (2, 256)).astype(np.float32)


@pytest.fixture
def spans_on():
    was = obs.REGISTRY.enabled
    obs.enable()
    try:
        yield
    finally:
        if not was:
            obs.disable()


def _recorded(fn) -> list:
    """The buffered events ``fn()`` adds."""
    n = len(obs.events())
    fn()
    return obs.events()[n:]


def _inside(child: dict, parent: dict) -> bool:
    return (child["tid"] == parent["tid"] and child is not parent
            and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def _one(events: list, name: str) -> dict:
    found = [e for e in events if e["name"] == name]
    assert len(found) == 1, (name, [e["name"] for e in events])
    return found[0]


def test_push_spans_nest_per_layer(spans_on):
    g = _pfb_power("nest")
    runner = graph.ChunkedRunner(g, lowering="native", device="cpu")
    for i in range(2):     # the first window, then the steady one
        runner.push(_chunk(i))
    ev = _recorded(lambda: runner.push(_chunk(2)))
    validate_nesting(ev)
    carry, push = _one(ev, "stream.carry"), _one(ev, "stream.push")
    assert carry["args"]["seq"] == push["args"]["seq"] == 2
    # the carry runs beside the push, before it
    assert carry["ts"] + carry["dur"] <= push["ts"]
    lookup, run = _one(ev, "plan.lookup"), _one(ev, "plan.run")
    assert _inside(lookup, push) and _inside(run, push)
    assert lookup["args"]["hit"] is True
    assert lookup["ts"] + lookup["dur"] <= run["ts"]
    pfb, abs2 = _one(ev, "node.pfb"), _one(ev, "node.abs2")
    assert _inside(pfb, run) and _inside(abs2, run)
    assert pfb["ts"] + pfb["dur"] <= abs2["ts"]
    assert "plan.compile" not in {e["name"] for e in ev}


def test_cache_miss_compiles_after_the_lookup(spans_on):
    g = _pfb_power("miss")
    runner = graph.ChunkedRunner(g, lowering="native", device="cpu")
    ev = _recorded(lambda: runner.push(_chunk(3)))
    validate_nesting(ev)
    push, lookup = _one(ev, "stream.push"), _one(ev, "plan.lookup")
    comp = _one(ev, "plan.compile")
    assert lookup["args"]["hit"] is False
    assert _inside(comp, push) and not _inside(comp, lookup)
    assert lookup["ts"] + lookup["dur"] <= comp["ts"]
    assert comp["ts"] + comp["dur"] <= _one(ev, "plan.run")["ts"]


def test_sharded_plan_run_holds_its_shards(spans_on):
    g = _pfb_power("mesh")
    x = np.random.default_rng(3).standard_normal((4, 256)).astype(np.float32)
    p = graph.compile(g, {"x": x.shape}, lowering="native", device="cpu",
                      mesh=2)
    ev = _recorded(lambda: p(x))
    validate_nesting(ev)
    runs = sorted((e for e in ev if e["name"] == "plan.run"),
                  key=lambda e: -e["dur"])
    assert len(runs) == 3
    assert all(_inside(r, runs[0]) for r in runs[1:])
    nodes = [e for e in ev if e["name"].startswith("node.")]
    assert len(nodes) == 4
    assert all(any(_inside(n, r) for r in runs[1:]) for n in nodes)


def _host_ranges(prof) -> list:
    """The profiler's host events named as the program's spans:
    (name, start ns, end ns), by start."""
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type().name == "CPU" and e.name().startswith(PROGRAM)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def test_spans_open_profiler_ranges_on_its_clock(spans_on):
    g = _pfb_power("prof")
    runner = graph.ChunkedRunner(g, lowering="native", device="cpu")
    for i in range(2):
        runner.push(_chunk(4 + i))
    n = len(obs.events())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            runner.push(_chunk(6 + i))
    spans = sorted(obs.events()[n:], key=lambda e: (e["ts"], -e["dur"]))
    ranges = _host_ranges(prof)
    names = [e["name"] for e in spans]
    assert {"stream.carry", "stream.push", "plan.lookup", "plan.run",
            "node.pfb", "node.abs2"} <= set(names)
    assert [r[0] for r in ranges] == names
    for e, (_, a, b) in zip(spans, ranges):
        span_us, range_us = e["dur"], (b - a) / 1e3
        assert abs(range_us - span_us) <= 0.1 * span_us + 20, (
            e["name"], span_us, range_us)
    # nested in the profiler's trace as in the buffer
    for i, (ei, ri) in enumerate(zip(spans, ranges)):
        for ej, rj in zip(spans[i + 1:], ranges[i + 1:]):
            assert _inside(ej, ei) == (ri[1] <= rj[1] and rj[2] <= ri[2]), (
                ei["name"], ej["name"])


def test_span_records_leave_the_collector():
    """A buffered span is one tuple of strings and numbers, which the
    collector stops tracking at its first pass: a long traced window
    adds nothing to walk in full collections."""
    reg = obs.Registry(enabled=True)
    for i in range(1000):
        with reg.span("node.pfb", cat="plan", node="pfb2", seq=i):
            pass
    reg.complete("service.device_run", 0, 10, tid="card", bucket=4)
    reg.instant("service.degrade", bucket=4)
    gc.collect(0)
    assert not any(gc.is_tracked(r) for r in reg._events)
    ev = reg.events()
    assert ev[7]["args"] == {"node": "pfb2", "seq": 7}
    assert ev[-2]["tid"] == "card" and ev[-1]["ph"] == "i"


def test_spans_off_record_and_open_nothing():
    was = obs.REGISTRY.enabled
    obs.disable()
    try:
        assert obs.span("stream.push", seq=0) is obs.NULL_SPAN
        assert obs.span("plan.run") is obs.span("node.pfb")
        g = _pfb_power("off")
        runner = graph.ChunkedRunner(g, lowering="native", device="cpu")
        assert _recorded(lambda: runner.push(_chunk(7))) == []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ev = _recorded(lambda: runner.push(_chunk(8)))
        assert ev == [] and _host_ranges(prof) == []
    finally:
        if was:
            obs.enable()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_program_spans_are_not_device_work(spans_on):
    """On the card the profiler draws each program span on the device
    timeline too (a ``gpu_user_annotation``); the benchmark's reducer
    (``tina_bench/harness/trace.py``) counts none of it as device work:
    a profiled push reduces to the same device intervals with spans on
    as with them off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    bench = Path(__file__).resolve().parents[1] / "tina_bench"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from harness import trace as trace_lib

    g = _pfb_power("cuda")
    runner = graph.ChunkedRunner(g, lowering="kernel")
    x = torch.randn(8, 1 << 16, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    for _ in range(2):     # the first window, then the steady one
        runner.push(x)
    torch.cuda.synchronize()

    def device_work(on: bool) -> list:
        (obs.enable if on else obs.disable)()
        prof = trace_lib.Profile(cuda=True)
        prof.begin()
        with prof.span(trace_lib.WINDOW):
            runner.push(x)
            torch.cuda.synchronize()
        return sorted(n for n, _, _ in prof.reduce()["kernels"])

    off = device_work(False)
    on = device_work(True)
    assert off and on == off
    assert not any(n.startswith(PROGRAM) for n in on)
