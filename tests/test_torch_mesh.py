"""The port's batch-sharded plans, streams and services
(``repro_torch.launch.mesh``, ``mesh=`` on ``graph.compile``,
``ChunkedRunner``, ``PipelineService`` and ``dsp_serve``) on the CPU, held
to the JAX package's ``tests/test_mesh_plan.py``.

A CPU mesh is ``n`` logical shards of the one CPU device, the port's
counterpart of the reference's forced host devices.  Every sharded plan
is held bit for bit to its per-shard plan run on each slice and
concatenated, as the reference's ``shard_map`` is; against the global
(unsharded) plan within the reference's 1e-4 / 1e-5 (rtol / atol), the
first row against the numpy oracle within 2e-3 (the JAX suite's pipeline
tolerance), and the 1-device mesh against the JAX ``mesh=1`` plan within
that 2e-3.  A subprocess runs the reference on 8 forced host devices
(``pallas`` in interpret mode) beside the port's 8-shard ``kernel`` plan
on the same numpy input, within 1e-4 of the output's max (two float32
sums of the same terms in another order).  Streams: f32 within 1e-6 of
the output's max (the JAX suite's streaming bar), int8 bit for bit
against the port's own offline plan.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core.registry import PIPELINES as JPIPELINES
from repro.core.registry import pipelines as jpipelines
from repro_torch import graph
from repro_torch.core.registry import PIPELINES, pipelines
from repro_torch.graph import autotune
from repro_torch.graph import plan as plan_lib
from repro_torch.graph.service import PipelineService, replay_batches
from repro_torch.launch import dsp_serve
from repro_torch.launch.mesh import (BatchMesh, Shards, make_batch_mesh)

jpipelines()
pipelines()
PIPES = sorted(PIPELINES)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 2e-3            # the JAX suite's pipeline-vs-oracle tolerance
CPU = torch.device("cpu")

pytestmark = pytest.mark.timeout(300)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _batch(name, rows, n=512):
    """``rows`` scaled copies of one seeded signal, as the reference's
    multi-device sweep builds them."""
    (x,) = PIPELINES[name].make_args(_rng(name, rows, n), n)
    return np.stack([x * (1.0 + 0.1 * i) for i in range(rows)]).astype(
        np.float32)


def _compile(g, shape, **kw):
    with warnings.catch_warnings():
        # elementwise ops that declare no int8 run f32, warned once
        warnings.simplefilter("ignore", UserWarning)
        return graph.compile(g, {g.inputs[0]: shape}, device="cpu", **kw)


def _per_shard(g, xb, shards, **kw):
    """The per-shard single-device plan run on each slice, concatenated:
    what every logical shard runs."""
    k = xb.shape[0] // shards
    one = _compile(g, (k,) + xb.shape[1:], **kw)
    return torch.cat([one(xb[i:i + k]) for i in range(0, xb.shape[0], k)])


def _storage(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


def _owns(out, *inputs) -> bool:
    o0, o1 = _storage(out)
    return out.is_contiguous() and not any(
        o0 < _storage(t)[1] and _storage(t)[0] < o1 for t in inputs)


# ---------------------------------------------------------------------------
# the 1-device mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", PIPES)
def test_one_device_mesh_matches_unsharded_and_jax(name):
    xb = _batch(name, 4)
    g = PIPELINES[name].build()
    p0 = _compile(g, xb.shape, lowering="kernel")
    p1 = _compile(g, xb.shape, lowering="kernel", mesh=1)
    assert p1 is not p0                  # the mesh is in the cache key
    assert p1.mesh.size == 1 and p1.batch_axis == "batch"
    assert len(p1.input_shardings) == 1
    assert p1.shard_plans == {CPU: p0}   # one shard: the unsharded plan
    x = torch.from_numpy(xb)
    got = p1(x)
    assert torch.equal(got, p0(x))
    assert _owns(got, x)
    assert _compile(g, xb.shape, lowering="kernel", mesh=1) is p1
    jg = JPIPELINES[name].build()
    want = np.asarray(jgraph.compile(
        jg, {jg.inputs[0]: xb.shape},
        options=jgraph.CompileOptions(lowering="pallas", mesh=1))(
            jnp.asarray(xb)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# 8 logical shards: every pipeline x every lowering
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lowering", ["native", "conv", "kernel"])
@pytest.mark.parametrize("name", PIPES)
def test_eight_shards_bit_identical_to_per_shard_plan(name, lowering):
    spec = PIPELINES[name]
    assert lowering in spec.lowerings
    xb = _batch(name, 8)
    g = spec.build()
    p = _compile(g, xb.shape, lowering=lowering, mesh=8)
    assert p.mesh.size == 8 and p.mesh.distinct == (CPU,)
    x = torch.from_numpy(xb)
    got = p(p.shard_inputs(x))
    assert torch.equal(got, _per_shard(g, xb, 8, lowering=lowering)), \
        f"{name}/{lowering} not bit-identical"
    assert _owns(got, x)
    glob = _compile(g, xb.shape, lowering=lowering)(x)
    np.testing.assert_allclose(got.numpy(), glob.numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=f"{name}/{lowering}")
    np.testing.assert_allclose(got[0].numpy(), spec.oracle(xb[0]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", PIPES)
def test_eight_shards_int8_bit_identical_to_per_shard_plan(name):
    xb = _batch(name, 8)
    g = PIPELINES[name].build()
    p = _compile(g, xb.shape, lowering="kernel", precision="int8", mesh=8)
    got = p(xb)
    assert torch.equal(got, _per_shard(g, xb, 8, lowering="kernel",
                                       precision="int8"))


def test_run_shards_and_gather():
    """``run_shards`` leaves each shard's output apart; the gathered
    output is a tensor of its own, not a view of a shard's."""
    xb = _batch("fir_decimate", 4)
    g = PIPELINES["fir_decimate"].build()
    mesh = BatchMesh((CPU,) * 4)
    p = _compile(g, xb.shape, lowering="kernel", mesh=mesh)
    shards = p.shard_inputs(xb)
    assert isinstance(shards, Shards) and len(shards) == 4
    assert all(tuple(s.shape) == (1, 512) for s in shards)
    outs = p.run_shards(shards)
    assert len(outs) == 4
    got = p.gather(outs)
    assert torch.equal(got, torch.cat(outs))
    assert _owns(got, *outs, *shards)
    with pytest.raises(ValueError, match="compiled for x"):
        p(xb[:, :256])
    with pytest.raises(ValueError, match="3 shards"):
        p.run_shards(Shards(shards[:3]))
    with pytest.raises(ValueError, match="not sharded"):
        _compile(g, xb.shape, lowering="kernel").run_shards(xb)


# ---------------------------------------------------------------------------
# the reference on 8 forced host devices, beside the port's 8 shards
# ---------------------------------------------------------------------------
def test_distributed_jax_eight_devices_match_port(tmp_path):
    names = ("pfb_power", "fir_decimate")
    xs = {n: _batch(n, 8) for n in names}
    np.savez(tmp_path / "in.npz", **xs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("TINA_AUTOTUNE", "cached")
    body = f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro import graph
        from repro.core.registry import PIPELINES, pipelines
        pipelines()
        assert len(jax.devices()) == 8
        xs = np.load({str(tmp_path / "in.npz")!r})
        out = {{}}
        for name in {names!r}:
            g = PIPELINES[name].build()
            p = graph.compile(g, {{g.inputs[0]: xs[name].shape}},
                              options=graph.CompileOptions(
                                  lowering="pallas", mesh=8))
            out[name] = np.asarray(p(p.shard_inputs(
                jnp.asarray(xs[name]))))
        np.savez({str(tmp_path / "out.npz")!r}, **out)
        print("OK")
        """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, env=env, timeout=280)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    want = np.load(tmp_path / "out.npz")
    for name in names:
        g = PIPELINES[name].build()
        got = _compile(g, xs[name].shape, lowering="kernel", mesh=8)(
            xs[name]).numpy()
        scale = float(np.max(np.abs(want[name])))
        np.testing.assert_allclose(got, want[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# argument forms, errors, refusals
# ---------------------------------------------------------------------------
def test_mesh_arg_forms_and_cache_key():
    g = PIPELINES["spectrogram"].build()
    shapes = {"x": (4, 512)}
    p_int = graph.compile(g, shapes, device="cpu", mesh=1)
    p_mesh = graph.compile(g, shapes, device="cpu",
                           mesh=make_batch_mesh(1, device="cpu"))
    assert p_int is p_mesh                # same topology, same entry
    # shard="batch" alone: every device (one logical CPU shard)
    assert graph.compile(g, shapes, device="cpu", shard="batch") is p_int
    assert graph.compile(g, shapes, backend="cpu", mesh=1) is p_int
    p4 = graph.compile(g, shapes, device="cpu", mesh=4)
    assert p4 is not p_int and p4.key[-2] == (
        "batch", 4, ("cpu",) * 4)
    assert graph.compile(g, shapes, device="cpu",
                         mesh=BatchMesh(("cpu",) * 4)) is p4
    with pytest.raises(ValueError, match="only 'batch'"):
        graph.compile(g, shapes, device="cpu", shard="time")
    with pytest.raises(TypeError, match="mesh="):
        graph.compile(g, shapes, device="cpu", mesh="everything")
    with pytest.raises(ValueError, match="contradicts"):
        graph.compile(g, shapes, device="cuda",
                      mesh=make_batch_mesh(2, device="cpu"))


def test_mesh_requires_batch_axis_and_divisibility():
    g = PIPELINES["spectrogram"].build()
    with pytest.raises(ValueError, match="batch axis"):
        graph.compile(g, {"x": (512,)}, device="cpu", shard="batch")
    with pytest.raises(ValueError, match="batch divisibility"):
        graph.compile(g, {"x": (6, 512)}, device="cpu", mesh=4)
    with pytest.raises(ValueError, match="divisible"):
        PipelineService(g, signal_len=256, batch_size=6, mesh=4,
                        device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        graph.ChunkedRunner(g, mesh=2, device="cpu").push(
            np.zeros(512, np.float32))


def test_refusals_mixed_and_oversized_meshes():
    with pytest.raises(ValueError, match="mix types"):
        BatchMesh((torch.device("cpu"), torch.device("cuda", 0)))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"{cards + 1} devices requested, "
                                         f"{cards} available"):
        make_batch_mesh(cards + 1, device="cuda")
    with pytest.raises(ValueError, match="card"):
        BatchMesh((torch.device("cuda", cards),))
    with pytest.raises(ValueError, match="no devices"):
        BatchMesh(())
    with pytest.raises(ValueError, match="at least one"):
        make_batch_mesh(0, device="cpu")
    g = PIPELINES["spectrogram"].build()
    with pytest.raises(ValueError, match="available"):
        graph.compile(g, {"x": (4, 512)}, mesh=cards + 1)   # the card
    with pytest.raises(ValueError, match=f"{cards} card"):
        dsp_serve.main(["--devices", str(cards + 1)])
    m = BatchMesh(("cpu",) * 3)
    assert m.size == 3 and m.shape == {"batch": 3} and m.distinct == (CPU,)
    assert make_batch_mesh(device="cpu").size == 1


# ---------------------------------------------------------------------------
# the service and the stream on 1 and 4 shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("lowering", ["native", "kernel"])
def test_sharded_service_ladder_replay_oracle(shards, lowering):
    spec = PIPELINES["spectrogram"]
    rng = _rng("svc", shards, lowering)
    xs = [rng.standard_normal(256).astype(np.float32) for _ in range(11)]
    with PipelineService(spec.build(), signal_len=256, batch_size=8,
                         batching="continuous", mesh=shards, device="cpu",
                         lowering=lowering, record_batches=True) as svc:
        outs = [f.result(timeout=60) for f in [svc.submit(x) for x in xs]]
    assert svc.buckets[0] == shards and svc.buckets[-1] == 8
    assert all(b % shards == 0 for b, _ in svc.batch_log)
    assert svc.plan.mesh.size == shards
    assert replay_batches(svc) == len(xs)
    for x, o in zip(xs, outs):
        np.testing.assert_allclose(o, spec.oracle(x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", ["spectrogram", "pfb_power",
                                  "stft_overlap_add"])
def test_sharded_chunked_runner_matches_offline(name, shards):
    xb = _batch(name, 4, 2048)
    g = PIPELINES[name].build()
    runner = graph.ChunkedRunner(g, mesh=shards, device="cpu",
                                 lowering="kernel")
    assert runner.mesh.size == shards
    got = runner.run(xb, 600).numpy()
    want = _compile(g, xb.shape, lowering="kernel")(xb).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.max(np.abs(want))))
    r8 = graph.ChunkedRunner(g, mesh=shards, device="cpu",
                             lowering="kernel", precision="int8",
                             step_buckets=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got8 = r8.run(xb, 700)
    assert torch.equal(got8, _compile(g, xb.shape, lowering="kernel",
                                      precision="int8")(xb))


def test_sharded_autotune_uses_per_shard_shapes(tmp_path, monkeypatch):
    """The tuner sees the per-shard problem: the keys a sharded compile
    writes carry the per-shard batch (8 / 8 = 1), never the global one."""
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("TINA_AUTOTUNE", "on")
    monkeypatch.setenv("TINA_AUTOTUNE_CACHE", str(cache))
    autotune._MEM.clear()
    g = PIPELINES["spectrogram"].build()
    p = graph.compile(g, {"x": (8, 512)}, mesh=8, lowering="auto",
                      device="cpu", autotune_kwargs={"repeats": 1})
    keys = list(json.loads(cache.read_text())["entries"])
    assert keys, "the tuner wrote nothing"
    assert any("(1, " in k for k in keys), keys
    assert not any("(8, " in k for k in keys), keys
    assert p.shard_plans[CPU].input_specs["x"][0] == (1, 512)
    # the sharded plan is the cache's hit after the tuner's write
    assert graph.compile(g, {"x": (8, 512)}, mesh=8, lowering="auto",
                         device="cpu",
                         autotune_kwargs={"repeats": 1}) is p
    autotune._MEM.clear()
    plan_lib.clear_cache()


def test_dsp_serve_cpu_mesh_four_devices(capsys):
    out = dsp_serve.main(["--device", "cpu", "--mesh", "4", "--devices",
                          "4", "--pipeline", "pfb_power", "--lowering",
                          "kernel", "--batching", "continuous", "--batch",
                          "8", "--requests", "12", "--signal-len", "1024",
                          "--check", "4"])
    assert out["served"] == 12 and out["checked"] == 4
    assert out["compiled_while_serving"] == 0
    assert all(b % 4 == 0 for b, n in out["stats"]["bucket_batches"].items()
               if n)
    assert "mesh {'batch': 4} (2 rows/device)" in capsys.readouterr().out
