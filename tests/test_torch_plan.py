"""The port's planner and the ``pfb_power`` slice end to end, against the
JAX package's compiled plan and the numpy oracle, on the CPU.

The JAX plan runs ``lowering="pallas"`` (Pallas in interpret mode
off-TPU); the port runs ``lowering="kernel"`` with ``device="cpu"``, so
its kernel wrappers take their plain torch versions.  Tolerance: the
JAX suite's pipeline-vs-oracle 2e-3 (``tests/test_graph.py``).
"""
import ast
import warnings
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro_torch import graph
from repro_torch.core.pfb import pfb_window
from repro_torch.graph import plan as plan_lib
from repro_torch.kernels import elementwise as ewk
from repro_torch.kernels import pfb as pfbk

ROOT = Path(__file__).resolve().parents[1]
P, M = 16, 8


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _spec_of(g) -> dict:
    """A JAX-built graph as the plain dict ``load_graph`` takes."""
    return {"name": g.name,
            "nodes": [(n.name, n.op, n.inputs, n.attrs) for n in g.topo()],
            "inputs": list(g.inputs), "outputs": list(g.outputs),
            "consts": {k: np.asarray(v) for k, v in g.consts.items()}}


def _jax_plan(g, shape):
    return jgraph.compile(g, {g.inputs[0]: shape},
                          options=jgraph.CompileOptions(lowering="pallas"))


@pytest.mark.parametrize("shape", [(P * 40,), (3, P * 40)],
                         ids=["1d", "batched"])
def test_pfb_power_kernel_plan_matches_jax_and_oracle(shape):
    x = _rng("pfb_power", shape).standard_normal(shape).astype(np.float32)
    g = graph.build_pfb_power(P, M)
    plan = graph.compile(g, {"x": shape}, lowering="kernel", device="cpu")
    assert [n.op for n in plan.graph.topo()] == ["input", "const", "pfb",
                                                 "abs2"]
    assert set(plan.node_lowerings.values()) == {"kernel"}
    assert plan.downgrades == {}
    got = plan(torch.from_numpy(x)).numpy()
    want_jax = np.asarray(_jax_plan(jgraph.build_pfb_power(P, M), shape)(
        jnp.asarray(x)))
    want = graph.pfb_power_oracle(P, M)(x)
    assert got.shape == want.shape == want_jax.shape
    np.testing.assert_allclose(got, want_jax, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("lowering", ["native", "conv", "reference"])
def test_pfb_power_other_lowerings_match_oracle(lowering):
    x = _rng("lw", lowering).standard_normal((2, P * 32)).astype(np.float32)
    g = graph.build_pfb_power(P, M)
    plan = graph.compile(g, {"x": x.shape}, lowering=lowering, device="cpu")
    np.testing.assert_allclose(plan(x).numpy(),
                               graph.pfb_power_oracle(P, M)(x),
                               rtol=2e-3, atol=2e-3)


def test_registered_pipelines_match_oracle_every_lowering():
    """The registry sweep, as the JAX suite runs it over its own
    registry: each registered pipeline at each of its lowerings."""
    from repro_torch.core.registry import pipelines
    specs = pipelines()
    assert [s.name for s in specs] == list(graph.BUILTINS)
    for spec in specs:
        (x,) = spec.make_args(_rng("registry", spec.name), spec.valid_len(500))
        g = spec.build()
        want = spec.oracle(x)
        for lw in spec.lowerings:
            got = graph.compile(g, {g.inputs[0]: x.shape}, lowering=lw,
                                device="cpu")(x).numpy()
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                       err_msg=f"{spec.name} {lw}")


def test_kernel_plan_on_cpu_launches_no_kernel():
    before = (pfbk.LAUNCHES, ewk.LAUNCHES)
    g = graph.build_pfb_power(P, M)
    plan = graph.compile(g, {"x": (P * 16,)}, lowering="kernel",
                         device="cpu")
    plan(torch.zeros(P * 16))
    assert (pfbk.LAUNCHES, ewk.LAUNCHES) == before


def test_second_compile_is_cache_hit():
    g = graph.build_pfb_power(P, 4)
    shapes = {"x": (2, P * 24)}
    first = graph.compile(g, shapes, lowering="kernel", device="cpu")
    hits = graph.cache_stats()["hits"]
    again = graph.compile(graph.build_pfb_power(P, 4), shapes,
                          options=graph.CompileOptions(lowering="kernel",
                                                       device="cpu"))
    assert again is first
    assert graph.cache_stats()["hits"] == hits + 1
    other = graph.compile(g, shapes, lowering="native", device="cpu")
    assert other is not first


def test_consts_become_device_tensors_at_compile():
    g = graph.build_pfb_power(P, M)
    plan = graph.compile(g, {"x": (P * 16,)}, lowering="kernel",
                         device="cpu")
    taps = plan.consts["taps"]
    assert isinstance(taps, torch.Tensor) and taps.dtype == torch.float32
    np.testing.assert_array_equal(taps.numpy(), g.consts["taps"])


def test_plan_rejects_other_input_shape():
    g = graph.build_pfb_power(P, M)
    plan = graph.compile(g, {"x": (P * 16,)}, device="cpu")
    with pytest.raises(ValueError, match="was compiled for"):
        plan(torch.zeros(P * 32))


def test_load_graph_signature_and_plan_equal_jax():
    jg = jgraph.build_pfb_power(P, M)
    g = graph.load_graph(_spec_of(jg))
    assert g.signature == jg.signature
    assert g.signature == graph.build_pfb_power(P, M).signature
    x = _rng("load").standard_normal((2, P * 32)).astype(np.float32)
    got = graph.compile(g, {"x": x.shape}, lowering="kernel",
                        device="cpu")(x).numpy()
    want = np.asarray(_jax_plan(jg, x.shape)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_fused_chain_matches_jax():
    """pfb -> abs2 -> scale fuses into one fused_ew node (one chain
    kernel launch), as in the reference."""
    def build(gmod):
        g = gmod.Graph("pfb_power_scaled")
        x = g.input("x")
        t = g.const(pfb_window(P, M).astype(np.float32), "taps")
        z = g.apply("pfb", x, t)
        p2 = g.apply("abs2", z)
        g.output(g.apply("scale", p2, factor=1.0 / P))
        return g

    x = _rng("fused").standard_normal((2, P * 24)).astype(np.float32)
    g = build(graph)
    plan = graph.compile(g, {"x": x.shape}, lowering="kernel", device="cpu")
    fused = [n for n in plan.graph.topo() if n.op == "fused_ew"]
    assert len(fused) == 1
    assert fused[0].attr["steps"] == (("abs2",), ("scale", 1.0 / P))
    assert plan.node_lowerings[fused[0].name] == "kernel"
    jg = build(jgraph)
    want = np.asarray(_jax_plan(jg, x.shape)(jnp.asarray(x)))
    np.testing.assert_allclose(plan(x).numpy(), want, rtol=2e-3, atol=2e-3)
    unfused = graph.compile(g, {"x": x.shape}, lowering="kernel",
                            device="cpu", fuse=False)
    assert "fused_ew" not in [n.op for n in unfused.graph.topo()]
    np.testing.assert_allclose(unfused(x).numpy(), want, rtol=2e-3,
                               atol=2e-3)


def test_block_configs_reach_the_kernel_boundary():
    g = graph.build_pfb_power(P, M)
    x = torch.zeros(P * 16)
    ok = graph.compile(g, {"x": (P * 16,)}, lowering="kernel", device="cpu",
                       block_configs={"pfb2": {"bt": 128, "bn": 64}})
    assert ok.configs == {"pfb2": {"bt": 128, "bn": 64}}
    ok(x)
    bad = graph.compile(g, {"x": (P * 16,)}, lowering="kernel", device="cpu",
                        block_configs={"pfb2": {"bt": 48}})
    with pytest.raises(ValueError, match="invalid block config"):
        bad(x)


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graph.build_pfb_power(P, M)
    with pytest.raises(RuntimeError, match="is_available"):
        graph.compile(g, {"x": (P * 16,)}, lowering="kernel")
    assert graph.CompileOptions().device is None


# the options the port once refused: each now compiles (under
# TINA_AUTOTUNE=cached with a cold cache, so nothing is measured and every
# tuned choice is its default: the kernel at its default tile) and equals
# the kernel plan of the precisions it resolved bit for bit; mesh= shards
# a batched input into the kernel plan of one shard, bit for bit
@pytest.mark.parametrize("changes", [
    {"precision": {"pfb2": "int8", "abs23": "auto"}},
    {"precision": {"pfb2": "auto", "abs23": "bf16"}},
    {"precision": "auto"}, {"lowering": "auto"},
    {"block_configs": "auto"}, {"fuse": "auto"}, {"mesh": 2}],
    ids=["int8", "bf16", "precision-auto", "lowering-auto", "blocks-auto",
         "fuse-auto", "mesh"])
def test_not_yet_ported_options_raise(changes, tmp_path, monkeypatch):
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    monkeypatch.setenv("TINA_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    g = graph.build_pfb_power(P, M)
    if "mesh" in changes:
        x = _rng("mesh").standard_normal((2, P * 16)).astype(np.float32)
        plan = graph.compile(g, {"x": x.shape}, device="cpu",
                             lowering="kernel", **changes)
        one = graph.compile(g, {"x": (1, P * 16)}, device="cpu",
                            lowering="kernel")
        assert plan.mesh.size == 2 and plan.shard_plans == {
            torch.device("cpu"): one}
        assert torch.equal(plan(x), torch.cat([one(x[:1]), one(x[1:])]))
        return
    opts = {"lowering": "kernel", **changes}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = graph.compile(g, {"x": (P * 16,)}, device="cpu", **opts)
        want = graph.compile(g, {"x": (P * 16,)}, device="cpu",
                             lowering="kernel", precision=plan.precisions)
    assert not (tmp_path / "tune.json").exists()    # nothing measured
    assert set(plan.precisions.values()) <= {"f32", "int8", "bf16"}
    x = _rng("auto", str(changes)).standard_normal(P * 16).astype(np.float32)
    assert set(plan.lowerings.values()) == {"kernel"}
    assert not any(plan.configs.values()) and not any(want.configs.values())
    assert torch.equal(plan(x), want(x))


def test_unknown_lowering_and_op_raise():
    g = graph.build_pfb_power(P, M)
    with pytest.raises(ValueError, match="'kernel' here"):
        graph.compile(g, {"x": (P * 16,)}, lowering="pallas", device="cpu")
    with pytest.raises(TypeError):
        graph.compile(g, {"x": (P * 16,)}, donate=True)
    with pytest.raises(ValueError, match="backend='tpu'"):
        graph.compile(g, {"x": (P * 16,)}, backend="tpu")
    with pytest.raises(ValueError, match="contradicts"):
        graph.compile(g, {"x": (P * 16,)}, backend="gpu", device="cpu")
    spec = _spec_of(jgraph.build_fir_decimate())
    spec["nodes"] = [(name, "fir_int8" if op == "fir" else op, inputs,
                      attrs) for name, op, inputs, attrs in spec["nodes"]]
    with pytest.raises(ValueError, match="unknown op 'fir_int8'"):
        graph.compile(graph.load_graph(spec), {"x": (256,)}, device="cpu")


def test_per_node_lowering_auto_raises():
    g = graph.build_pfb_power(P, M)
    with pytest.raises(ValueError, match="tunes the whole plan"):
        graph.compile(g, {"x": (P * 16,)}, device="cpu",
                      lowering={"pfb2": "auto", "abs23": "kernel"})


def test_per_node_lowering_dict():
    g = graph.build_pfb_power(P, M)
    x = _rng("dict").standard_normal(P * 20).astype(np.float32)
    plan = graph.compile(g, {"x": x.shape}, device="cpu",
                         lowering={"pfb2": "kernel", "abs23": "conv"})
    assert plan.node_lowerings == {"pfb2": "kernel", "abs23": "conv"}
    np.testing.assert_allclose(plan(x).numpy(),
                               graph.pfb_power_oracle(P, M)(x),
                               rtol=2e-3, atol=2e-3)


def test_downgrade_recorded_and_warned_once():
    from repro_torch.core import opdefs
    opdefs.register(opdefs.OpDef("negate_native_only",
                                 lambda a, at, lw, b=None: -a[0]))
    try:
        g = graph.Graph("downgrade_probe")
        g.output(g.apply("negate_native_only", g.input("x")))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            plan = graph.compile(g, {"x": (4,)}, lowering="kernel",
                                 device="cpu")
            plan_lib.clear_cache()
            graph.compile(g, {"x": (4,)}, lowering="kernel", device="cpu")
        assert plan.downgrades == {"negate_native_only1": "lowering:kernel"}
        assert plan.node_lowerings == {"negate_native_only1": "native"}
        assert sum("fell back" in str(w.message) for w in rec) == 1
        torch.testing.assert_close(plan(torch.ones(4)), -torch.ones(4))
    finally:
        del opdefs.OPDEFS["negate_native_only"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


# ---------------------------------------------------------------------------
# plan outputs own their memory, as the JAX plan's do
# ---------------------------------------------------------------------------
def _one_node(mod, op, **attrs):
    g = mod.Graph(f"one_{op}")
    g.output(g.apply(op, g.input("x"), **attrs))
    return g


# (the graph, built on either package; input shape; port lowering; JAX
# lowering): the view ops, unfold's as_strided at native, and
# fir_decimate's stride-2 tail
ALIAS_CASES = {
    "downsample": (lambda mod: _one_node(mod, "downsample", factor=2),
                   (4, 64), "kernel", "pallas"),
    "unfold": (lambda mod: _one_node(mod, "unfold", window=8),
               (4, 64), "native", "native"),
    "frame_decimate": (lambda mod: _one_node(mod, "frame_decimate",
                                             factor=2),
                       (4, 16, 8), "kernel", "pallas"),
    "fir_decimate": (lambda mod: mod.build_fir_decimate(), (2, 4096),
                     "kernel", "pallas"),
}


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    sa, sb = a.untyped_storage(), b.untyped_storage()
    return (sa.data_ptr() < sb.data_ptr() + sb.nbytes()
            and sb.data_ptr() < sa.data_ptr() + sa.nbytes())


@pytest.mark.parametrize("case", list(ALIAS_CASES))
@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_plan_output_is_dense_and_owns_its_memory_vs_jax(case, kind):
    """The JAX plan returns a fresh, dense array.  The port's output must
    be contiguous, share no storage with the caller's input, and still
    equal the JAX plan's after the caller edits that input in place."""
    build, shape, lw, jlw = ALIAS_CASES[case]
    x_np = _rng("alias", case).standard_normal(shape).astype(np.float32)
    want = np.asarray(jgraph.compile(
        build(jgraph), {"x": shape},
        options=jgraph.CompileOptions(lowering=jlw))(jnp.asarray(x_np)))
    plan = graph.compile(build(graph), {"x": shape}, lowering=lw,
                         device="cpu")
    x = torch.from_numpy(x_np.copy()) if kind == "torch" else x_np.copy()
    got = plan(x)
    assert got.is_contiguous()
    assert not _shares_storage(got, torch.as_tensor(x))
    if kind == "torch":
        x.add_(1.0)
    else:
        x[...] = -1.0
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
