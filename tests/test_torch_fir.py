"""The port's FIR slice and Table-1 view against the JAX package, on the
CPU: the FIR and matmul wrappers, ``fir`` / ``summation`` / ``matmul``
at every lowering, ``abs2`` of a real signal, the generated Table-1
registry swept at every lowering, and the ``fir_decimate``,
``correlate`` and ``cascaded_channelizer`` pipelines end to end.

Inputs come from numpy with a fixed seed and go to both packages.  The
JAX functions reach their Pallas kernels in interpret mode off-TPU, as
the JAX suite runs them; the port's wrappers run their kernels' plain
torch versions for CPU tensors (the CUDA kernels run only on a card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Tolerances are the
JAX suite's own: FIR 1e-4 and matmul 2e-5 (``tests/test_kernels.py``),
eager against plan 1e-5 and against the oracle 2e-3
(``tests/test_opdefs.py``), pipelines 2e-3 (``tests/test_graph.py``).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import functions as jfunctions
from repro.core import opdefs as jopdefs
from repro.core import registry as jregistry
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import graph
from repro_torch.core import functions, opdefs, registry
from repro_torch.kernels import dft as dftk
from repro_torch.kernels import elementwise as ewk
from repro_torch.kernels import fir as firk
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops, ref, tune
from repro_torch.kernels import pfb as pfbk

LOWERINGS = [("native", "native"), ("conv", "conv"), ("kernel", "pallas")]
LW_IDS = [lw for lw, _ in LOWERINGS]
JAX_LOWERING = dict(LOWERINGS)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# kernel wrappers against the JAX Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,n,k", [(2, 1024, 8), (8, 600, 31),
                                   (1, 2048, 129), (3, 64, 64)])
def test_ops_fir_vs_jax(b, n, k):
    rng = _rng("ops_fir", b, n, k)
    x = rng.standard_normal((b, n)).astype(np.float32)
    kern = rng.standard_normal(k).astype(np.float32)
    want = np.asarray(jops.fir(jnp.asarray(x), jnp.asarray(kern)))
    got = ops.fir(_t(x), _t(kern)).numpy()
    assert got.shape == want.shape == (b, n - k + 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jref.ref_fir_valid(jnp.asarray(x), jnp.asarray(kern))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,l,n", [(128, 128, 128), (8, 64, 32),
                                   (300, 100, 50), (1, 1, 1),
                                   (257, 129, 255)])
def test_ops_matmul_vs_jax(m, l, n):
    rng = _rng("ops_matmul", m, l, n)
    x = rng.standard_normal((m, l)).astype(np.float32)
    y = rng.standard_normal((l, n)).astype(np.float32)
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(y)))
    got = ops.matmul(_t(x), _t(y)).numpy()
    assert got.shape == want.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_ops_matmul_batched_vs_jax():
    rng = _rng("ops_matmul_batched")
    x = rng.standard_normal((3, 5, 40, 24)).astype(np.float32)
    y = rng.standard_normal((24, 17)).astype(np.float32)
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(y)))
    got = ops.matmul(_t(x), _t(y)).numpy()
    assert got.shape == (3, 5, 40, 17)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ref_twins_match_jax():
    rng = _rng("ref")
    x = rng.standard_normal((3, 200)).astype(np.float32)
    kern = rng.standard_normal(17).astype(np.float32)
    np.testing.assert_allclose(
        ref.ref_fir_valid(_t(x), _t(kern)).numpy(),
        np.asarray(jref.ref_fir_valid(jnp.asarray(x), jnp.asarray(kern))),
        rtol=1e-5, atol=1e-5)
    y = rng.standard_normal((200, 9)).astype(np.float32)
    np.testing.assert_allclose(
        ref.ref_matmul(_t(x), _t(y)).numpy(),
        np.asarray(jref.ref_matmul(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pads", [(0, 0), (3, 0), (0, 5), (6, 6)])
def test_fir_valid_plain_pads_implicitly(pads):
    rng = _rng("plain_pads", pads)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    kern = rng.standard_normal(7).astype(np.float32)
    got = firk.fir_valid(_t(x), _t(kern), pad_left=pads[0],
                         pad_right=pads[1]).numpy()
    xp = np.pad(x, ((0, 0), pads))
    want = ref.ref_fir_valid(_t(xp), _t(kern)).numpy()
    assert got.shape == (4, 300 + sum(pads) - 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pads", [(0, 0), (4, 3), (7, 7)])
def test_fir_valid_flip_reads_the_taps_reversed(pads):
    rng = _rng("plain_flip", pads)
    x = _t(rng.standard_normal((3, 200)).astype(np.float32))
    kern = _t(rng.standard_normal(8).astype(np.float32))
    got = firk.fir_valid(x, kern, pad_left=pads[0], pad_right=pads[1],
                         flip=True)
    want = firk.fir_valid(x, kern.flip(0).contiguous(), pad_left=pads[0],
                          pad_right=pads[1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["same", "full"])
@pytest.mark.parametrize("k", [8, 13])
def test_ops_fir_pads_vs_jax_modes(mode, k):
    """``ops.fir`` with a correlation's pads (``flip=False``) is the
    JAX wrapper's ``mode``, even K included."""
    rng = _rng("ops_fir_pads", mode, k)
    x = rng.standard_normal((2, 500)).astype(np.float32)
    kern = rng.standard_normal(k).astype(np.float32)
    want = np.asarray(jops.fir(jnp.asarray(x), jnp.asarray(kern), mode=mode))
    pad_left, pad_right = functions.mode_pads(k, mode, flip=False)
    got = ops.fir(_t(x), _t(kern), pad_left=pad_left,
                  pad_right=pad_right).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_matmul_plain_is_the_product():
    rng = _rng("mm_plain")
    x = rng.standard_normal((33, 20)).astype(np.float32)
    y = rng.standard_normal((20, 7)).astype(np.float32)
    np.testing.assert_allclose(mmk.matmul(_t(x), _t(y)).numpy(), x @ y,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# op mappings against the JAX functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("k", [8, 9, 13])
def test_fir_function_vs_jax_native(lw, jlw, flip, mode, k):
    """Every lowering follows the reference's native lowering, even K
    included; a true convolution also matches np.convolve."""
    rng = _rng("fir_fn", lw, flip, mode, k)
    x = rng.standard_normal((2, 150)).astype(np.float32)
    taps = rng.standard_normal(k).astype(np.float32)
    got = functions.fir(_t(x), _t(taps), mode=mode, flip=flip,
                        lowering=lw).numpy()
    want = np.asarray(jfunctions.fir(jnp.asarray(x), jnp.asarray(taps),
                                     mode=mode, flip=flip, lowering="native"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if flip:
        np.testing.assert_allclose(
            got, np.stack([np.convolve(r, taps, mode) for r in x]),
            rtol=1e-4, atol=1e-4)


def test_even_k_same_is_not_the_pallas_quirk():
    """The reference's Pallas wrapper centres an even-K 'same'
    convolution one sample off its native lowering and numpy; the port's
    kernel lowering follows native and numpy."""
    rng = _rng("even_k")
    x = rng.standard_normal(500).astype(np.float32)
    taps = rng.standard_normal(8).astype(np.float32)
    numpy_same = np.convolve(x, taps, "same")
    jax_pallas = np.asarray(jfunctions.fir(jnp.asarray(x), jnp.asarray(taps),
                                           mode="same", lowering="pallas"))
    assert np.abs(jax_pallas - numpy_same).max() > 1.0
    got = functions.fir(_t(x), _t(taps), mode="same",
                        lowering="kernel").numpy()
    np.testing.assert_allclose(got, numpy_same, rtol=1e-4, atol=1e-4)
    assert functions.mode_pads(8, "same", True) == (4, 3)
    assert functions.mode_pads(8, "same", False) == (3, 4)
    assert functions.mode_pads(9, "same", True) == functions.mode_pads(
        9, "same", False) == (4, 4)


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
def test_matmul_function_vs_jax(lw, jlw):
    rng = _rng("mm_fn", lw)
    x = rng.standard_normal((2, 30, 40)).astype(np.float32)
    y = rng.standard_normal((40, 25)).astype(np.float32)
    got = functions.matmul(_t(x), _t(y), lowering=lw).numpy()
    want = np.asarray(jfunctions.matmul(jnp.asarray(x), jnp.asarray(y),
                                        lowering=jlw))
    assert got.shape == want.shape == (2, 30, 25)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lw", LW_IDS)
def test_summation_vs_jax(lw):
    x = _rng("sum", lw).standard_normal((3, 4, 257)).astype(np.float32)
    got = functions.summation(_t(x), lowering=lw).numpy()
    want = np.asarray(jfunctions.summation(jnp.asarray(x)))
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# abs2 of a real signal (the matched filter's power)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
def test_abs2_of_real_bit_exact_vs_jax(lw, jlw):
    x = _rng("abs2_real", lw).standard_normal((3, 257)).astype(np.float32)
    jd, d = jopdefs.OPDEFS["abs2"], opdefs.OPDEFS["abs2"]
    want = np.asarray(jd.impl([jnp.asarray(x)], {}, jlw))
    got = d.impl([_t(x)], {}, lw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x * x)
    # and as a graph node: shape inference runs it on meta tensors
    g = graph.Graph("abs2_real")
    g.output(g.apply("abs2", g.input("x")))
    plan = graph.compile(g, {"x": x.shape}, lowering=lw, device="cpu")
    np.testing.assert_array_equal(plan(_t(x)).numpy(), want)


def test_real_abs2_chain_matches_jax_fused():
    x = _rng("abs2_chain").standard_normal((4, 100)).astype(np.float32)
    steps = (("abs2",), ("scale", 0.37))
    want = np.asarray(jops.fused_elementwise(jnp.asarray(x), (), steps))
    got = ops.fused_elementwise(_t(x), (), steps).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ewk.elementwise_chain_plain(_t(x), (), steps[1:],
                                    abs2_head=True).numpy(), want)


# ---------------------------------------------------------------------------
# the Table-1 view
# ---------------------------------------------------------------------------
def test_registry_is_generated_from_opdefs():
    table = {d.table_name for d in opdefs.table_ops()}
    assert set(registry.REGISTRY) == table
    assert list(registry.REGISTRY) == list(jregistry.REGISTRY)
    for d in opdefs.table_ops():
        op = registry.REGISTRY[d.table_name]
        assert op.fn is d.eager and op.oracle is d.oracle
        assert op.lowerings == d.lowerings
        jop = jregistry.REGISTRY[d.table_name]
        assert (op.section, op.building_block) == (jop.section,
                                                   jop.building_block)
        assert op.lowerings == tuple(
            "kernel" if lw == "pallas" else lw for lw in jop.lowerings)
    assert [o.name for o in registry.ops(["fir", "matmul"])] == \
        ["fir", "matmul"]


def _single_node_graph(d, args):
    """A one-node graph from an OpDef's make_args tuple: the first array
    is the input, later arrays are consts, non-arrays bind arg_attrs."""
    g = graph.Graph(f"one_{d.name}")
    refs, attrs = [], {}
    attr_names = list(d.arg_attrs)
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            refs.append(g.input("x") if not refs else g.const(a, f"c{i}"))
        else:
            attrs[attr_names.pop(0)] = a
    assert not attr_names, f"{d.name}: arg_attrs left unbound"
    g.output(g.apply(d.name, *refs, **attrs))
    return g


SWEEP = [(d.name, lw) for d in opdefs.table_ops() for lw in d.lowerings]


@pytest.mark.parametrize("name,lw", SWEEP,
                         ids=[f"{n}-{lw}" for n, lw in SWEEP])
def test_table1_sweep_vs_jax_and_oracle(name, lw):
    d = opdefs.OPDEFS[name]
    args = d.make_args(_rng("sweep", name), 16)
    jargs = d.make_args(_rng("sweep", name), 16)
    assert all(not isinstance(a, np.ndarray) or np.array_equal(a, b)
               for a, b in zip(args, jargs))
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    want = np.asarray(d.oracle(*args))
    eager = _np(d.eager(*targs, lowering=lw))
    jd = jopdefs.OPDEFS[name]
    jlw = JAX_LOWERING[lw] if lw in JAX_LOWERING else lw
    jeager = np.asarray(jd.eager(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in jargs],
        lowering=jlw))
    plan = graph.compile(_single_node_graph(d, args),
                         {"x": (args[0].shape, args[0].dtype)},
                         lowering=lw, device="cpu")
    assert plan.downgrades == {}
    planned = _np(plan(targs[0]))
    assert eager.shape == jeager.shape == want.shape
    np.testing.assert_allclose(planned, eager, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(eager, jeager, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(eager, want, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the three FIR pipelines end to end
# ---------------------------------------------------------------------------
PIPES = ["fir_decimate", "correlate", "cascaded_channelizer"]


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
@pytest.mark.parametrize("name", PIPES)
def test_fir_pipelines_vs_jax_and_oracle(name, lw, jlw):
    n = graph.pipelines._chan_len(400, 31, 16, 4) \
        if name == "cascaded_channelizer" else 400
    shape = (3, n)
    x = _rng("pipe", name, lw).standard_normal(shape).astype(np.float32)
    g = getattr(graph, f"build_{name}")()
    plan = graph.compile(g, {"x": shape}, lowering=lw, device="cpu")
    jplan = jgraph.compile(getattr(jgraph, f"build_{name}")(), {"x": shape},
                           options=jgraph.CompileOptions(lowering=jlw))
    assert [nd.op for nd in plan.graph.topo()] == \
        [nd.op for nd in jplan.graph.topo()]
    assert plan.downgrades == {} == jplan.downgrades
    for node, got_lw in plan.node_lowerings.items():
        op = plan.graph.nodes[node].op
        assert got_lw == ("native" if op == "downsample" else lw), (node,
                                                                    got_lw)
    got = plan(_t(x)).numpy()
    want_jax = np.asarray(jplan(jnp.asarray(x)))
    want = getattr(graph, f"{name}_oracle")()(x)
    assert got.shape == want_jax.shape == want.shape
    np.testing.assert_allclose(got, want_jax, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # the 1-D signal of the registry's make_args
    spec = registry.PIPELINES[name]
    (x1,) = spec.make_args(_rng("pipe1d", name), spec.valid_len(300))
    p1 = graph.compile(g, {"x": x1.shape}, lowering=lw, device="cpu")
    np.testing.assert_allclose(p1(_t(x1)).numpy(), spec.oracle(x1),
                               rtol=2e-3, atol=2e-3)


def test_correlate_fuses_abs2_and_scale_on_a_real_head():
    plan = graph.compile(graph.build_correlate(), {"x": (2, 300)},
                         lowering="kernel", device="cpu")
    fused = [nd for nd in plan.graph.topo() if nd.op == "fused_ew"]
    assert len(fused) == 1
    steps = fused[0].attr["steps"]
    assert steps[0] == ("abs2",) and steps[1][0] == "scale"


def test_builtins_in_the_reference_order():
    assert graph.BUILTINS == jgraph.BUILTINS
    for name in PIPES:
        assert getattr(graph, f"build_{name}")().signature == \
            getattr(jgraph, f"build_{name}")().signature


def _counts():
    return (firk.LAUNCHES, mmk.LAUNCHES, ewk.LAUNCHES, ewk.BINARY_LAUNCHES,
            pfbk.LAUNCHES)


def test_cpu_plans_launch_no_kernel():
    before = _counts()
    for name in PIPES:
        g = getattr(graph, f"build_{name}")()
        n = graph.pipelines._chan_len(300, 31, 16, 4)
        graph.compile(g, {"x": (2, n)}, lowering="kernel",
                      device="cpu")(torch.randn(2, n))
    x = torch.randn(3, 64)
    ops.matmul(x, x.T)
    ops.elementwise_add(x, x)
    assert _counts() == before


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------
def test_tune_spaces_describe_the_cuda_kernels():
    sp = tune.space("fir")
    assert sp is firk.TUNE_SPACE and sp.params == ("bn", "threads")
    # the compiled tiles: four quads of outputs a thread on 128 or 256
    # threads; no halo rule: a 4097-tap filter fits every tile's ring
    ctx = {"k": 4097, "n": 2 ** 20, "rows": 4}
    assert {(c["bn"], c["threads"]) for c in sp.configs(ctx)} == {
        (2048, 128), (4096, 256)}
    assert sp.check({}, ctx) == {"bn": 2048, "threads": 128}
    assert all(sp.valid(c, ctx) for c in sp.configs(ctx))
    assert firk.smem_bytes(4096, 4097) <= tune.SMEM_BUDGET
    # a tile is four quads a thread on 128 or 256 threads
    for bn, threads in ((1024, 128), (1024, 256), (4096, 128),
                        (8192, 512), (2048, 512)):
        assert not sp.valid({"bn": bn, "threads": threads}, ctx)
    msp = tune.space("matmul")
    assert msp is mmk.TUNE_SPACE
    assert {(c["bm"], c["bn"], c["bk"], c["order"]) for c in msp.configs(
        {"m": 4096, "n": 4096, "k": 4096})} == {
            t + (o,) for t in mmk.TILES for o in mmk.ORDERS}
    assert msp.check({}, {"m": 4096, "n": 4096, "k": 4096})["bn"] == 128
    assert msp.check({}, {"m": 300, "n": 50, "k": 100})["bn"] == 64
    assert all(mmk.smem_bytes(*t) <= tune.SMEM_BUDGET for t in mmk.TILES)


# ---------------------------------------------------------------------------
# csrc/fir.cu's host side: each tile's staged span and the ring, as
# kernels/fir.py describes them
# ---------------------------------------------------------------------------
def _fir_jobs(rows, n, k, pads, bn, xo, oo):
    """Every job's (row, t0, k0, kc, a, pa, staged): a row's tiles start
    0-3 outputs early, so that each quad of out is 16-byte aligned, and
    run the taps in chunks of TAP_CHUNK."""
    nout = n + pads[0] + pads[1] - k + 1
    for r in range(rows):
        e = (oo + r * nout) % 4
        for i in range(-(-(nout + 3) // bn)):
            for k0 in range(0, k, firk.TAP_CHUNK):
                kc = min(firk.TAP_CHUNK, k - k0)
                yield (r, i * bn - e, k0, kc) + firk.tile_span(
                    i * bn - e, k0, kc, pads[0], bn, xo + r * n)


FIR_GEOMETRY = [  # rows, n, k, pads, bn, x_offset, out_offset
    (3, 1000, 1, (0, 0), 2048, 0, 0), (2, 999, 8, (4, 3), 2048, 1, 0),
    (5, 4099, 15, (14, 14), 2048, 2, 3), (2, 70001, 31, (15, 15), 2048, 0, 1),
    (3, 3000, 63, (0, 0), 4096, 3, 2),
    (2, 9001, 4097, (2048, 2048), 2048, 1, 1),
    (3, 50, 31, (0, 0), 2048, 0, 0), (2, 0, 3, (2, 2), 4096, 0, 0),
    (4, 2 ** 16, 31, (0, 0), 4096, 0, 0)]


@pytest.mark.parametrize("rows,n,k,pads,bn,xo,oo", FIR_GEOMETRY)
def test_fir_staged_spans_cover_what_each_tile_reads(rows, n, k, pads, bn,
                                                     xo, oo):
    nout = n + pads[0] + pads[1] - k + 1
    tr = -(-min(k, firk.TAP_CHUNK) // 4) * 4       # taps region of a stage
    written = {r: [] for r in range(rows)}
    chunks = {}
    for r, t0, k0, kc, a, pa, staged in _fir_jobs(rows, n, k, pads, bn,
                                                  xo, oo):
        # staged sample 0 sits on a 16-byte boundary of x, a samples before
        # the first one the tile reads
        assert (xo + r * n + pa) % 4 == 0 and 0 <= a < 4
        assert pa + a == t0 + k0 - pads[0]
        # the last sample read, and the window's float4 loaded a step
        # ahead (quad at bn - 4, group ceil(kc / 4) - 1, slots 0-2 and one
        # more), fall inside the span, and the span inside its stage
        assert t0 + bn - 1 + k0 + kc - 1 - pads[0] < pa + staged
        assert (bn - 4) + 4 * (-(-kc // 4)) + 11 < staged
        assert staged <= firk.smem_bytes(bn, k) // (4 * firk.STAGES) - tr
        chunks.setdefault((r, t0), []).append((k0, kc))
        if k0 + kc == k:
            # quads start on 16 bytes of out
            assert (oo + r * nout + t0) % 4 == 0
            written[r].append(t0)
    # chunks ascend and cover the taps once; tiles cover each row once
    for got in chunks.values():
        assert [k0 for k0, _ in got] == list(range(0, k, firk.TAP_CHUNK))
        assert sum(kc for _, kc in got) == k
    for starts in written.values():
        assert starts[0] <= 0 and starts[-1] + bn >= nout > starts[-1]
        assert all(b - a == bn for a, b in zip(starts, starts[1:]))
    # the ring: three stages of taps and samples
    assert firk.smem_bytes(bn, k) == 4 * firk.STAGES * (tr + bn + tr + 8)


def test_fir_aligned_rows_copy_16_bytes_but_at_their_edges():
    # 4 x 2**16, K = 31, 2048-output tiles: every 16-byte piece of a span
    # inside its row is one 16-byte copy; sample by sample (or zeros) only
    # in a row's first and last tiles, where the span crosses the row's
    # edge
    n, bn = 2 ** 16, 2048
    last = -(-(n - 30 + 3) // bn) - 1
    vec = edge = 0
    for r, t0, k0, kc, a, pa, staged in _fir_jobs(4, n, 31, (0, 0), bn,
                                                  0, 0):
        inside = sum(1 for p in range(pa, pa + staged, 4)
                     if p >= 0 and p + 4 <= n)
        vec, edge = vec + inside, edge + staged // 4 - inside
        tile = (t0 + 3) // bn
        if 0 < tile < last:
            assert staged // 4 == inside
        if tile == last:
            assert staged // 4 > inside
    assert vec / (vec + edge) > 0.99


# ---------------------------------------------------------------------------
# the 3xTF32 GEMM's host side: y's TF32 planes, the plan's kernel pack,
# and the method's accuracy (emulated in torch on the CPU; the card's is
# chip_smoke.py's float64 check)
# ---------------------------------------------------------------------------
MM_RTOL = 2e-5        # the reference's matmul tolerance (test_kernels.py)
MM_F64_RTOL = 1e-5    # chip_smoke.py: the GEMM against a float64 product


@pytest.mark.parametrize("k,n", [(1, 1), (129, 255), (100, 50), (24, 17),
                                 (1027, 193)])
def test_tf32_planes_twin_matches_dft_tf32_planes(k, n):
    """The split pass's plain twin lays out y as the DFT's F side: hi then
    lo TF32 part of y^T, K-major; only the N padding differs (a multiple
    of the GEMM's widest tile, 128, against the DFT's 64), and it is
    zero.  The CPU wrapper runs the twin."""
    y = _t(_rng("planes", k, n).standard_normal((k, n)).astype(np.float32))
    got = mmk.tf32_planes_plain(y)
    assert tuple(got.shape) == mmk.planes_shape(k, n) == (
        2, -(-n // 128) * 128, -(-k // 32) * 32)
    assert got.dtype == torch.float32 and got.is_contiguous()
    want = dftk.tf32_planes(y, y, "4mult")[:2]
    assert torch.equal(got[:, :n, :k], want[:, :n, :k])
    pad = torch.ones(got.shape[1:], dtype=torch.bool)
    pad[:n, :k] = False
    assert not got[:, pad].any()
    assert torch.equal(mmk.tf32_planes(y), got)


def test_matmul_plan_kernel_pack_is_a_slot_for_the_planes():
    """An f32 kernel matmul plan with a const y holds a slot for y's TF32
    planes, filled at the first launch on the card only: a CPU plan (and
    a native one) never makes them."""
    w = _rng("kpack").standard_normal((64, 48)).astype(np.float32)
    g = graph.Graph("mm")
    node = g.apply("matmul", g.input("x"), g.const(w, "y"))
    g.output(node)
    plan = graph.compile(g, {"x": (32, 64)}, lowering="kernel", device="cpu")
    assert plan.kconsts == {node: [None]}
    x = _t(_rng("kpack", 1).standard_normal((32, 64)).astype(np.float32))
    np.testing.assert_allclose(plan(x).numpy(), x.numpy() @ w, rtol=MM_RTOL,
                               atol=MM_RTOL)
    assert plan.kconsts == {node: [None]}
    assert graph.compile(g, {"x": (32, 64)}, lowering="native",
                         device="cpu").kconsts == {}
    assert graph.compile(g, {"x": (32, 64)}, lowering="kernel",
                         precision="bf16", device="cpu").kconsts == {}


def _tf32_gemm(x, planes, k, n, passes, promote=True):
    """x (M, K) against y's planes as the kernel multiplies them, with f32
    sums: passes 3 is xhi yhi + xhi ylo + xlo yhi (each product of two
    TF32 values exact in f32), 1 a single TF32 pass; promote takes each
    32-deep chunk apart and adds it into the result in f32."""
    xh, xl = mmk.tf32_split(x)
    yh, yl = planes[0, :n, :k].t(), planes[1, :n, :k].t()
    step = mmk.BK if promote else k
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32)
    for k0 in range(0, k, step):
        c = slice(k0, k0 + step)
        part = xh[:, c] @ yh[c]
        if passes == 3:
            part = xl[:, c] @ yh[c] + xh[:, c] @ yl[c] + part
        acc = acc + part
    return acc


def test_3xtf32_gemm_emulation_within_float64_at_4096():
    """At K = 4096 the 3xTF32 GEMM with per-chunk promotion (emulated
    with f32 sums) stays within 1e-5 of max of a float64 product, and so
    within the reference's 2e-5; a single TF32 pass does not."""
    k, n = 4096, 64
    rng = _rng("3xtf32_gemm")
    x = _t(rng.standard_normal((64, k)).astype(np.float32))
    y = _t(rng.standard_normal((k, n)).astype(np.float32))
    planes = mmk.tf32_planes_plain(y)
    want = x.double() @ y.double()
    scale = float(want.abs().max())
    errs = {p: float((_tf32_gemm(x, planes, k, n, p).double() - want)
                     .abs().max()) / scale for p in (3, 1)}
    assert errs[3] <= MM_F64_RTOL
    assert errs[1] > MM_RTOL > 10 * errs[3]


def test_matmul_staging_is_decided_by_shape():
    """TMA reads x's rows where they are 16-byte multiples from an
    aligned start; anything else goes through the zero-padded copy."""
    assert mmk.staging(torch.zeros(4, 64)) == "tma"
    assert mmk.staging(torch.zeros(4, 129)) == "padded_copy"
    shifted = torch.zeros(4 * 64 + 1)[1:].view(4, 64)
    assert shifted.is_contiguous() and mmk.staging(shifted) == "padded_copy"


def test_invalid_block_configs_raise():
    x = torch.randn(2, 64)
    cases = [
        lambda: ops.fir(x, torch.randn(5), bn=1000),
        lambda: ops.fir(x, torch.randn(5), bn=256, threads=100),
        # a tile is four quads a thread on 128 or 256 threads
        lambda: ops.fir(x, torch.randn(5), bn=1024, threads=256),
        lambda: ops.fir(x, torch.randn(5), bn=1024, threads=128),
        lambda: ops.fir(x, torch.randn(5), bn=1536, threads=128),
        lambda: ops.fir(x, torch.randn(5), bn=8192, threads=256),
        lambda: ops.fir(x, torch.randn(5), bn=2048, threads=512),
        lambda: ops.matmul(x, x.T, bm=96),
        lambda: ops.matmul(x, x.T, bk=16),
        lambda: ops.matmul(x, x.T, order="km"),
    ]
    for case in cases:
        with pytest.raises(ValueError, match="invalid block config"):
            case()
    g = graph.build_fir_decimate()
    bad = graph.compile(g, {"x": (300,)}, lowering="kernel", device="cpu",
                        block_configs={"fir3": {"bn": 100}})
    with pytest.raises(ValueError, match="invalid block config"):
        bad(torch.zeros(300))


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="do not fit"):
        firk.fir_valid(torch.randn(2, 10), torch.randn(12))
    with pytest.raises(ValueError, match="unknown mode"):
        functions.fir(torch.randn(20), torch.randn(3), mode="causal")
    with pytest.raises(ValueError, match="shapes"):
        mmk.matmul(torch.randn(3, 4), torch.randn(5, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        firk.fir_valid(torch.empty(2, 8, device="meta"),
                       torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        mmk.matmul(torch.empty(2, 8, device="meta"),
                   torch.empty(8, 3, device="meta"))
