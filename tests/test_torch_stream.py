"""The port's streaming executor (``repro_torch.graph.stream``) against
the JAX package's, on the CPU.

The same seeded numpy signals go through the JAX ``stream_execute`` (its
default ``native`` lowering) and the port's, at ``native`` and at
``kernel`` (on CPU tensors the kernel wrappers run their plain torch
versions), and through the port's offline plan.  Tolerances are the JAX
suite's streaming bars: 1e-6 at f32 (``tests/test_graph.py``, streamed
against offline) and 1e-5 at bf16 and int8
(``tests/test_precision.py``), as rtol and as atol of the output's max
(:func:`_close`); streamed int8 is also held bit for bit
against the port's own offline int8 plan, since every int8 scale is
taken per row, per FIR window or per (frame, branch).
"""
import functools
import warnings
import zlib

import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core.registry import PIPELINES as JPIPELINES
from repro.core.registry import pipelines as jpipelines
from repro.graph import stream as jstream
from repro_torch import graph
from repro_torch.core.registry import PIPELINES, pipelines
from repro_torch.graph import plan as plan_lib
from repro_torch.graph import stream

jpipelines()
pipelines()
PIPES = sorted(PIPELINES)
LOWERINGS = ["native", "kernel"]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _signal(name, n, *key):
    (x,) = PIPELINES[name].make_args(_rng(name, n, *key), n)
    return x


def _quiet(fn, *a, **kw):
    """Run ``fn`` with the (expected, separately tested) precision
    downgrade warnings of elementwise ops that declare no int8 silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*a, **kw)


@functools.lru_cache(maxsize=None)
def _jax_streamed(name, n, chunk, prec):
    x = _signal(name, n)
    g = JPIPELINES[name].build()
    return np.asarray(_quiet(jgraph.stream_execute, g, x, chunk,
                             precision=prec))


def _port_offline(name, x, lowering, prec):
    g = PIPELINES[name].build()
    plan = _quiet(graph.compile, g, {"x": x.shape}, lowering=lowering,
                  precision=prec, device="cpu")
    return plan(torch.from_numpy(x)).numpy()


def _port_streamed(name, x, chunk, lowering, prec, **kw):
    g = PIPELINES[name].build()
    return _quiet(graph.stream_execute, g, x, chunk, lowering=lowering,
                  precision=prec, device="cpu", **kw).numpy()


def _close(got, want, tol, what):
    """|got - want| <= tol * |want| + tol * max|want|: the JAX suite's
    rtol, with its atol taken relative to the output's scale (a pfb power
    spectrum reaches 1e2, and two float32 sums of the same terms in
    another order differ by ulps of the largest term, not of each
    value)."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.max(np.abs(want))),
                               err_msg=what)


# ---------------------------------------------------------------------------
# stream_spec: the composed (block, receptive, tail) is the reference's
# ---------------------------------------------------------------------------
SPEC_CASES = [
    ("pfb_power", ()), ("spectrogram", ()), ("fir_decimate", ()),
    ("stft_overlap_add", ()), ("correlate", ()),
    ("cascaded_channelizer", ()),
    # the reference's own cases (tests/test_graph.py, tests/test_opdefs.py)
    ("fir_decimate", (31, 15)), ("pfb_power", (16, 8)),
    ("spectrogram", (64,)), ("stft_overlap_add", (64, 32)),
    ("correlate", (63,)), ("cascaded_channelizer", (31, 16, 4)),
    ("pfb_power", (1024, 8)), ("stft_overlap_add", (1024, 512)),
]


@pytest.mark.parametrize("name, args", SPEC_CASES,
                         ids=[f"{n}{a}" for n, a in SPEC_CASES])
def test_stream_spec_matches_jax(name, args):
    build = getattr(graph, f"build_{name}")
    jbuild = getattr(jgraph, f"build_{name}")
    s = stream.stream_spec(build(*args))
    js = jstream.stream_spec(jbuild(*args))
    assert (s.block, s.receptive, s.tail_dims) == \
        (js.block, js.receptive, js.tail_dims)
    assert s.concat_axis == js.concat_axis


def test_stream_spec_composition_values():
    """The reference's literal expectations (tests/test_graph.py)."""
    s = graph.stream_spec(graph.build_fir_decimate(taps1=31, taps2=15))
    assert (s.block, s.receptive, s.tail_dims) == (4, 31 + 14 * 2, 0)
    s = graph.stream_spec(graph.build_stft_overlap_add(window=64, hop=32))
    assert (s.block, s.receptive, s.tail_dims) == (32, 96, 0)
    s = graph.stream_spec(graph.build_cascaded_channelizer(31, 16, 4))
    assert (s.block, s.receptive, s.tail_dims) == (32, 157, 1)


# ---------------------------------------------------------------------------
# streamed == JAX streamed == the port's offline plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [96, 256, 1000])
@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("name", PIPES)
def test_streamed_f32_equals_jax_and_offline(name, lowering, chunk):
    n = 2048
    x = _signal(name, n)
    got = _port_streamed(name, x, chunk, lowering, "f32")
    _close(got, _jax_streamed(name, n, chunk, "f32"), 1e-6,
           f"{name} {lowering} chunk={chunk} vs JAX streamed")
    _close(got, _port_offline(name, x, lowering, "f32"), 1e-6,
           f"{name} {lowering} chunk={chunk} vs offline")


@pytest.mark.parametrize("prec", ["bf16", "int8"])
@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("name", PIPES)
def test_streamed_reduced_tiers_equal_jax_and_offline(name, lowering, prec):
    n, chunk = 4096, 1024
    x = _signal(name, n)
    got = _port_streamed(name, x, chunk, lowering, prec)
    offline = _port_offline(name, x, lowering, prec)
    _close(got, _jax_streamed(name, n, chunk, prec), 1e-5,
           f"{name} {lowering} {prec} vs JAX streamed")
    _close(got, offline, 1e-5, f"{name} {lowering} {prec} vs offline")
    if prec == "int8":
        assert np.array_equal(got, offline), (name, lowering)


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_batched_chunks_equal_offline(lowering):
    """(batch, chunk_len) pushes: the carry runs on the last axis and the
    strided window of each push is copied into dense rows by the first
    kernel wrapper."""
    x = np.stack([_signal("fir_decimate", 1500, i) for i in range(3)])
    got = _port_streamed("fir_decimate", x, 333, lowering, "f32")
    _close(got, _port_offline("fir_decimate", x, lowering, "f32"), 1e-6,
           "batched fir_decimate")
    x = np.stack([_signal("pfb_power", 2048, i) for i in range(2)])
    got = _port_streamed("pfb_power", x, 300, lowering, "int8")
    assert np.array_equal(got, _port_offline("pfb_power", x, lowering,
                                             "int8"))


# ---------------------------------------------------------------------------
# the runner: buckets, carry, plan reuse, errors
# ---------------------------------------------------------------------------
def _drive(runner, x, sizes):
    outs, i = [], 0
    for s in sizes:
        o = runner.push(x[..., i:i + s])
        i += s
        if o is not None:
            outs.append(np.asarray(o))
    o = runner.finalize()
    if o is not None:
        outs.append(np.asarray(o))
    return np.concatenate(outs, axis=runner.spec.concat_axis)


@pytest.mark.parametrize("name", ["spectrogram", "pfb_power",
                                  "fir_decimate"])
def test_step_buckets_window_lens_match_jax(name):
    """Irregular pushes with step_buckets=True plus finalize(): the same
    compiled window lengths as the JAX runner on the same schedule,
    fewer than a free-running runner's, output equal to offline."""
    x = _signal(name, 2048)
    sizes = [97, 411, 64, 801, 333, 342]            # sums to 2048
    offline = _port_offline(name, x, "kernel", "f32")
    windows = {}
    for buckets in (False, True):
        runner = graph.ChunkedRunner(PIPELINES[name].build(),
                                     step_buckets=buckets,
                                     lowering="kernel", device="cpu")
        jrunner = jgraph.ChunkedRunner(JPIPELINES[name].build(),
                                       step_buckets=buckets)
        got = _drive(runner, x, sizes)
        _drive(jrunner, x, sizes)
        _close(got, offline, 1e-6, f"{name} buckets={buckets}")
        assert runner.window_lens == jrunner.window_lens
        windows[buckets] = runner.window_lens
    assert len(windows[True]) < len(windows[False])


def test_pushes_smaller_than_receptive_field_are_buffered():
    x = _signal("spectrogram", 300)
    runner = graph.ChunkedRunner(graph.build_spectrogram(), device="cpu")
    r = runner.spec.receptive                       # 64
    outs = []
    for i in range(0, 300, 40):
        o = runner.push(x[i:i + 40])
        if i + 40 < r:
            assert o is None and runner.carry_len == i + 40
        if o is not None:
            outs.append(o.numpy())
    got = np.concatenate(outs, axis=runner.spec.concat_axis)
    _close(got, _port_offline("spectrogram", x, "native", "f32"), 1e-6,
           "tiny pushes")
    assert runner.carry_len == r - 1


def test_signal_shorter_than_receptive_field_raises():
    g = graph.build_pfb_power()
    x = _signal("pfb_power", 256)[:100]
    with pytest.raises(ValueError, match="shorter than the pipeline's "
                                         "receptive field"):
        graph.stream_execute(g, x, 64, device="cpu")


def _bad_graphs(G):
    """Non-streamable graphs, built the same way in either package."""
    taps = np.hanning(9).astype(np.float32)
    out = {}
    g = G("two_in")
    g.output(g.apply("ew_add", g.input("a"), g.input("b")))
    out["two_inputs"] = g
    g = G("two_out")
    x = g.input("x")
    g.output(g.apply("abs2", x))
    g.output(g.apply("scale", x, factor=2.0))
    out["two_outputs"] = g
    g = G("sum")
    g.output(g.apply("summation", g.input("x")))
    out["summation"] = g
    g = G("dft_raw")
    g.output(g.apply("dft", g.input("x")))
    out["frame_before_framing"] = g
    g = G("fd_raw")
    g.output(g.apply("frame_decimate", g.input("x"), factor=2))
    out["framed_before_framing"] = g
    g = G("fir_after_unfold")
    f = g.apply("unfold", g.input("x"), window=8)
    g.output(g.apply("fir", f, g.const(taps, "taps")))
    out["time_after_framing"] = g
    g = G("fir_after_ola")
    f = g.apply("unfold", g.input("x"), window=8)
    o = g.apply("overlap_add", f, hop=8, window=8)
    g.output(g.apply("fir", o, g.const(taps, "taps")))
    out["time_after_overlap_add"] = g
    g = G("fir_same")
    g.output(g.apply("fir", g.input("x"), g.const(taps, "taps"),
                     mode="same"))
    out["fir_same"] = g
    g = G("ola_no_window")
    f = g.apply("unfold", g.input("x"), window=8)
    g.output(g.apply("overlap_add", f, hop=4))
    out["overlap_add_no_window"] = g
    return out


@pytest.mark.parametrize("case", sorted(_bad_graphs(graph.Graph)))
def test_non_streamable_graph_raises_the_reference_message(case):
    with pytest.raises(ValueError) as want:
        jstream.stream_spec(_bad_graphs(jgraph.Graph)[case])
    with pytest.raises(ValueError) as got:
        stream.stream_spec(_bad_graphs(graph.Graph)[case])
    assert str(got.value) == str(want.value)


def test_steady_push_is_a_plan_cache_hit():
    plan_lib.clear_cache()
    g = graph.build_fir_decimate()
    runner = graph.ChunkedRunner(g, lowering="kernel", device="cpu")
    x = _signal("fir_decimate", 4096)
    runner.push(x[:1024])
    runner.push(x[1024:2048])      # first push of the steady window
    before = plan_lib.cache_stats()
    for i in range(2048, 4096, 1024):
        runner.push(torch.from_numpy(x[i:i + 1024]))   # a tensor chunk
    after = plan_lib.cache_stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] == before["hits"] + 2
    assert after["size"] == before["size"]
    # the push's dtype spelling shares the offline compile's plan
    assert len(runner.window_lens) == 2     # the first push, the steady one
    w = max(runner.window_lens)
    assert graph.compile(g, {"x": (w,)}, lowering="kernel",
                         device="cpu") in plan_lib._CACHE.values()
    assert plan_lib.cache_stats()["misses"] == after["misses"]


def test_mesh_not_yet_ported():
    """Ported: a 2-shard runner equals the offline plan within the JAX
    suite's streaming bar (the sharded cases are in test_torch_mesh.py)."""
    g = graph.build_spectrogram()
    x = np.stack([_signal("spectrogram", 1024, i) for i in range(2)])
    runner = graph.ChunkedRunner(g, mesh=2, device="cpu")
    assert runner.mesh.size == 2
    want = graph.compile(g, {"x": x.shape}, device="cpu")(x)
    _close(runner.run(x, 300).numpy(), want.numpy(), 1e-6, "mesh=2")


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        graph.ChunkedRunner(graph.build_spectrogram())


def test_options_and_keywords_are_exclusive():
    with pytest.raises(TypeError, match="both options="):
        graph.ChunkedRunner(graph.build_spectrogram(),
                            options=graph.CompileOptions(device="cpu"),
                            lowering="kernel")
    runner = graph.ChunkedRunner(
        graph.build_spectrogram(),
        options=graph.CompileOptions(device="cpu", lowering="kernel"))
    out = runner.run(np.zeros(256, np.float32), 100)
    assert out.device.type == "cpu" and out.shape == (193, 64)
