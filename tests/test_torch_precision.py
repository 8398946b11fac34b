"""The port's int8 and bf16 precision tiers against the JAX package, on
the CPU: ``core/quantize.py`` (quantize, the int8 DFM, the torch integer
ops and both engines), the int8 kernel wrappers (their plain torch
versions on CPU tensors) against the JAX Pallas int8 kernels in
interpret mode, the OpDef precision fields, and every pipeline compiled
at ``precision="int8"`` and ``"bf16"`` against the JAX compiled plan.

Inputs come from numpy with a fixed seed and go to both packages, at the
JAX suite's sizes (``tests/test_precision.py``: ``make_args(rng, 256 /
2048)``).  Tolerances are the reference's promises: bit for bit wherever
it promises bits (quantize, the DFM, real DFT, FIR, PFB, matmul); where
a complex value is recombined (the 4-matmul complex (I)DFT, and |z|² of
a complex z), XLA under ``jit`` contracts the last multiply into an FMA
and the reference itself allows 2 ulp of max|want|
(``tests/test_precision.py:376-382``); bf16 within one bf16 ulp of each
value.
"""
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import opdefs as jopdefs
from repro.core import quantize as jq
from repro.core.registry import PIPELINES as JPIPELINES
from repro.core.registry import pipelines as jpipelines
from repro.graph import plan as jplan
from repro.kernels import ops as jops
from repro_torch import graph
from repro_torch.core import opdefs, quantize
from repro_torch.core.pfb import pfb_window
from repro_torch.graph import plan as plan_lib
from repro_torch.kernels import dft as dftk
from repro_torch.kernels import fir as firk
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops, tune
from repro_torch.kernels import pfb as pfbk

jpipelines()                      # register the JAX built-ins
PIPES = ["pfb_power", "spectrogram", "fir_decimate", "stft_overlap_add",
         "correlate", "cascaded_channelizer"]
# pipelines whose JAX plan recombines a complex value under jit (|z|² of
# a complex spectrum, the complex idft): held to 2 ulp of max|want|
RECOMBINE = {"pfb_power", "spectrogram", "stft_overlap_add",
             "cascaded_channelizer"}
LOWERINGS = [("native", "native"), ("kernel", "pallas")]
LW_IDS = [lw for lw, _ in LOWERINGS]
EPS32 = np.float32(np.finfo(np.float32).eps)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bitwise(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    assert np.array_equal(got, want), float(np.max(np.abs(got - want)))


def _two_ulp(got, want):
    """The reference's carve-out: within 2 ulp of max|want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * EPS32 * np.abs(want).max())


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _quiet_compile(mod, g, shapes, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return mod.compile(g, shapes, **kw)


# ---------------------------------------------------------------------------
# quantize_symmetric and the int8 DFM, bit for bit
# ---------------------------------------------------------------------------
def _half_integer_input():
    """(x, a, s): x (4, 64, 128) f32 whose amax along every axis through
    x[0, 0, 1] is a, with scale s = max(a, 1e-12) * f32(1/127), and
    x[0, 0, 1] = 2.5 s, x[0, 0, 2] = -3.5 s, so x / s lands exactly on
    half-integers: round half to even gives 2 and -4, round half away
    from zero would give 3 and -4."""
    c = np.float32(1.0) / np.float32(127.0)
    for a in np.float32(1.0) + np.arange(1, 4096, dtype=np.float32) / 256:
        s = np.float32(np.maximum(a, np.float32(1e-12)) * c)
        h1, h2 = np.float32(2.5) * s, np.float32(-3.5) * s
        if (float(h1) == 2.5 * float(s) and float(h2) == -3.5 * float(s)
                and h1 / s == np.float32(2.5) and h2 / s == np.float32(-3.5)):
            break
    else:
        raise AssertionError("no scale with an exact half-integer quotient")
    x = (_rng("half").uniform(-0.4, 0.4, (4, 64, 128)) * a).astype(np.float32)
    x[0, 0, 0] = x[0, 1, 1] = x[1, 0, 1] = x[0, 1, 2] = x[1, 0, 2] = a
    x[0, 0, 1], x[0, 0, 2] = h1, h2
    return x, a, s


@pytest.mark.parametrize("axis", [None, -1, 0, -2])
def test_quantize_symmetric_bitwise_with_half_integer_quotient(axis):
    x, a, s = _half_integer_input()
    q, scale = quantize.quantize_symmetric(_t(x), axis=axis)
    jqv, jscale = jq.quantize_symmetric(jnp.asarray(x), axis=axis)
    _bitwise(q, jqv)
    _bitwise(scale, jscale)
    # the exact half-integer quotients are really exercised, and round to
    # even: 2.5 -> 2, -3.5 -> -4
    s_here = scale.numpy().reshape(-1)[0] if axis is None else s
    assert x[0, 0, 1] / s_here == np.float32(2.5)
    assert x[0, 0, 2] / s_here == np.float32(-3.5)
    assert (int(q[0, 0, 1]), int(q[0, 0, 2])) == (2, -4)


@pytest.mark.parametrize("n", [16, 64, 1024])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_qdfm_bitwise(n, inverse):
    (qr, sr), (qi, si) = quantize._qdfm(n, inverse)
    (jqr, jsr), (jqi, jsi) = jq._qdfm(n, inverse)
    for got, want in ((qr, jqr), (sr, jsr), (qi, jqi), (si, jsi)):
        _bitwise(got, want)
    tensors = quantize._qdfm_tensors(n, inverse, "cpu")
    for got, want in zip(tensors, (qr, sr, qi, si)):
        _bitwise(got, want)


@pytest.mark.parametrize("n", [7, 64, 1024])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_qdfm_kmajor_is_the_transpose_of_jax(n, inverse):
    """The s8 tensor-core GEMM's B operand for the complex qdft: the int8
    DFM's K-major copies, bit for bit the transpose of the reference's,
    made once per (n, inverse, device)."""
    (jqr, _), (jqi, _) = jq._qdfm(n, inverse)
    qrt, qit = quantize._qdfm_kmajor(n, inverse, "cpu")
    _bitwise(qrt, np.asarray(jqr).T)
    _bitwise(qit, np.asarray(jqi).T)
    assert qrt.is_contiguous() and qit.is_contiguous()
    assert quantize._qdfm_kmajor(n, inverse, "cpu")[0] is qrt


@pytest.mark.parametrize("k,n", [(64, 48), (3, 5), (129, 67)])
def test_qprep_matmul_pack_carries_the_kmajor_weight(k, n):
    """The plan-built int8 matmul pack: the reference's quantize_weights
    pack, and the K-major (N, K) copy of its int8 weight, bit for bit,
    made once at the first kernel launch that asks for it (none at plan
    build, so native and CPU plans hold one copy of the weight)."""
    w = _rng("kmajor", k, n).standard_normal((k, n)).astype(np.float32)
    d = opdefs.OPDEFS["matmul"]
    pack = d.qprep(d.bind({}), {1: _t(w)})
    wq, ws, wt = pack
    jwq, jws = jq.quantize_weights(w)
    _bitwise(wq, jwq)
    _bitwise(ws, np.asarray(jws).reshape(-1))
    assert wt is None
    wt = opdefs._int8_kmajor(pack)
    _bitwise(wt, np.asarray(jwq).T)
    assert wt.is_contiguous()
    assert opdefs._int8_kmajor(pack) is wt and pack[2] is wt


def test_qdft_resolves_the_tile_of_the_kernel_that_runs(monkeypatch):
    """A complex x runs four matmul_int8 launches and takes its tile from
    matmul_int8's space; a real x runs dft_int8 at dft_int8's tile."""
    seen = []
    resolve = ops._resolve
    monkeypatch.setattr(ops, "_resolve", lambda space, ctx, **kw: (
        seen.append(space.kernel), resolve(space, ctx, **kw))[1])
    rng = _rng("qdft_tile")
    z = _t(_cplx(rng, (8, 64)))
    x = _t(rng.standard_normal((8, 64)).astype(np.float32))
    ops.qdft(z, inverse=True)
    assert seen == ["matmul_int8"]
    seen.clear()
    ops.qdft(x)
    assert seen == ["dft_int8"]
    bm, bn, bk = mmk.TILES_INT8[-1]
    _bitwise(ops.qdft(z, bm=bm, bn=bn, bk=bk), ops.qdft(z))
    # dft_int8's 64-column tile is no matmul_int8 tile
    assert dftk.TILES_INT8[-1] not in mmk.TILES_INT8
    with pytest.raises(ValueError, match="invalid block config"):
        ops.qdft(z, **dict(zip(("bm", "bn", "bk"), dftk.TILES_INT8[-1])))


@pytest.mark.parametrize("inverse", [False, True], ids=["dft", "idft"])
def test_qdft_hands_dft_int8_the_kmajor_planes(monkeypatch, inverse):
    """A real x reaches dft_int8 with the int8 DFM's K-major copies, the
    s8 tensor cores' B operands, made once per (n, inverse, device)
    (quantize._qdfm_kmajor), not transposed per call."""
    seen = []
    real = dftk.dft_int8
    monkeypatch.setattr(dftk, "dft_int8", lambda *a, **kw: (
        seen.append((a, kw)), real(*a, **kw))[1])
    n = 64
    x = _t(_rng("qdft_kmajor", inverse).standard_normal(
        (8, n)).astype(np.float32))
    got = ops.qdft(x, inverse=inverse)
    ((args, kw),) = seen
    qrt, qit = quantize._qdfm_kmajor(n, inverse, "cpu")
    assert kw["frt"] is qrt and kw["fit"] is qit
    qr, _, qi, _ = quantize._qdfm_tensors(n, inverse, "cpu")
    assert args[1] is qr and args[2] is qi
    _bitwise(kw["frt"], qr.t().numpy())
    _bitwise(kw["fit"], qi.t().numpy())
    _bitwise(got, quantize.qdft(x, inverse=inverse))


def test_weight_packs_bitwise():
    rng = _rng("packs")
    w = rng.standard_normal((64, 48)).astype(np.float32)
    taps = rng.standard_normal(31).astype(np.float32)
    proto = pfb_window(16, 8).astype(np.float32)
    for got, want in (
            (quantize.quantize_weights(_t(w)), jq.quantize_weights(w)),
            (quantize.quantize_fir_taps(_t(taps)), jq.quantize_fir_taps(taps)),
            (quantize.quantize_fir_taps(_t(taps), flip=False),
             jq.quantize_fir_taps(taps, flip=False)),
            (quantize.quantize_pfb_taps(_t(proto)),
             jq.quantize_pfb_taps(proto))):
        _bitwise(got[0], want[0])
        _bitwise(got[1], want[1])


# ---------------------------------------------------------------------------
# the torch integer ops against JAX native, and the kernel wrappers (plain
# versions on the CPU) against the JAX Pallas int8 kernels in interpret mode
# ---------------------------------------------------------------------------
def _mm_args(m=96, l=200, n=72):
    rng = _rng("qmatmul", m, l, n)
    x = rng.standard_normal((m, l)).astype(np.float32)
    w = rng.standard_normal((l, n)).astype(np.float32)
    wq, ws = jq.quantize_weights(w)
    return x, np.asarray(wq), np.asarray(ws).reshape(-1)


def test_qmatmul_bitwise():
    x, wq, ws = _mm_args()
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jnp.asarray(wq),
                                 jnp.asarray(ws)))
    _bitwise(quantize.qmatmul(_t(x), _t(wq), _t(ws)), want)
    _bitwise(ops.qmatmul(_t(x), _t(wq), _t(ws)),
             jops.qmatmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws)))
    # weight-only quantization (activations stay float)
    np.testing.assert_allclose(
        quantize.qmatmul(_t(x), _t(wq), _t(ws),
                         quantize_activations=False).numpy(),
        np.asarray(jq.qmatmul(jnp.asarray(x), jnp.asarray(wq),
                              jnp.asarray(ws), quantize_activations=False)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,n", [(40, 64), (7, 48), (3, 16)])
@pytest.mark.parametrize("inverse", [False, True], ids=["dft", "idft"])
def test_qdft_real_bitwise(rows, n, inverse):
    x = _rng("qdft", rows, n, inverse).standard_normal(
        (rows, n)).astype(np.float32)
    want = np.asarray(jq.qdft(jnp.asarray(x), inverse=inverse))
    _bitwise(quantize.qdft(_t(x), inverse=inverse), want)
    _bitwise(ops.qdft(_t(x), inverse=inverse),
             jops.qdft(jnp.asarray(x), inverse=inverse))


@pytest.mark.parametrize("inverse", [False, True], ids=["dft", "idft"])
def test_qdft_complex_within_two_ulp(inverse):
    z = _cplx(_rng("qdft_c", inverse), (24, 64))
    want = np.asarray(jax.jit(lambda a: jq.qdft(a, inverse=inverse))(
        jnp.asarray(z)))
    _two_ulp(quantize.qdft(_t(z), inverse=inverse), want)
    _two_ulp(ops.qdft(_t(z), inverse=inverse), want)
    # the kernel route equals the torch integer route bit for bit
    _bitwise(ops.qdft(_t(z), inverse=inverse),
             quantize.qdft(_t(z), inverse=inverse))
    _bitwise(ops.qdft(_t(z), inverse=inverse),
             jops.qdft(jnp.asarray(z), inverse=inverse))


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
@pytest.mark.parametrize("b,n,k", [(3, 500, 31), (2, 257, 8), (1, 64, 64)])
def test_qfir_bitwise(flip, b, n, k):
    rng = _rng("qfir", b, n, k)
    x = rng.standard_normal((b, n)).astype(np.float32)
    taps = rng.standard_normal(k).astype(np.float32)
    want = np.asarray(jq.qfir(jnp.asarray(x), jnp.asarray(taps), flip=flip))
    _bitwise(quantize.qfir(_t(x), _t(taps), flip=flip), want)
    tq, ts = jq.quantize_fir_taps(jnp.asarray(taps), flip=flip)
    _bitwise(ops.qfir(_t(x), _t(np.asarray(tq)), _t(np.asarray(ts))),
             jops.qfir(jnp.asarray(x), tq, ts))
    _bitwise(ops.qfir(_t(x), _t(np.asarray(tq)), _t(np.asarray(ts))), want)


@pytest.mark.parametrize("p,m,frames", [(16, 8, 40), (48, 4, 23),
                                        (64, 8, 33)])
def test_qpfb_and_frontend_bitwise(p, m, frames):
    rng = _rng("qpfb", p, m, frames)
    x = rng.standard_normal((2, p * frames)).astype(np.float32)
    taps = pfb_window(p, m).astype(np.float32)
    _bitwise(quantize.qpfb_frontend(_t(x), _t(taps)),
             jq.qpfb_frontend(jnp.asarray(x), jnp.asarray(taps)))
    want = np.asarray(jq.qpfb(jnp.asarray(x), jnp.asarray(taps)))
    _bitwise(quantize.qpfb(_t(x), _t(taps)), want)
    tq, ts = jq.quantize_pfb_taps(jnp.asarray(taps))
    _bitwise(ops.qpfb(_t(x), _t(np.asarray(tq)), _t(np.asarray(ts))),
             jops.qpfb(jnp.asarray(x), tq, ts))
    _bitwise(ops.qpfb(_t(x), _t(np.asarray(tq)), _t(np.asarray(ts))), want)


def test_matmul_int8_headroom_saturated():
    """tests/test_kernels.py:136-160 at K = 2048: ±127 everywhere gives
    |acc| = K·127², inside int32; the plain version equals an int64 numpy
    sum rescaled in f32, bit for bit, at every int8 tile's wrapper."""
    m, n, k = 512, 512, 2048
    rng = _rng("headroom")
    signs = np.where(rng.random((m, k)) < 0.5, -1.0, 1.0).astype(np.float32)
    x = 7.0 * signs
    wq = np.where(rng.random((k, n)) < 0.5, -127, 127).astype(np.int8)
    ws = np.ones((n,), np.float32)
    xq, sx = quantize.quantize_symmetric(_t(x), axis=-1)
    assert int(xq.abs().min()) == 127
    acc = xq.numpy().astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(acc).max() < 2 ** 31          # int32 headroom holds
    want = acc.astype(np.float32) * sx.numpy() * ws
    for cfg in tune.space("matmul_int8").configs({"m": m, "n": n, "k": k}):
        _bitwise(ops.qmatmul(_t(x), _t(wq), _t(ws), **cfg), want)
    _bitwise(mmk.matmul_int8_plain(xq, _t(wq), sx.reshape(-1), _t(ws)), want)


# ---------------------------------------------------------------------------
# every quantized OpDef through apply_node, both lowerings, against JAX
# ---------------------------------------------------------------------------
QUANT_OPS = sorted(n for n, d in opdefs.OPDEFS.items() if d.qimpl is not None)


def _qnode(mod, d, args):
    g = mod.Graph(f"q_{d.name}")
    refs, attrs = [], {}
    names = list(d.arg_attrs)
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            refs.append(g.input("x") if not refs else g.const(a, f"c{i}"))
        else:
            attrs[names.pop(0)] = a
    return g.nodes[g.apply(d.name, *refs, **attrs)]


def test_quantized_ops_are_the_references():
    assert QUANT_OPS == sorted(n for n, d in jopdefs.OPDEFS.items()
                               if d.qimpl is not None)
    for name, d in opdefs.OPDEFS.items():
        jd = jopdefs.OPDEFS[name]
        assert d.precisions == jd.precisions, name
        assert d.budgets == tuple((p, opdefs.Budget(b.sqnr_db, b.atol))
                                  for p, b in jd.budgets), name
        assert d.q_lowerings == tuple("kernel" if lw == "pallas" else lw
                                      for lw in jd.q_lowerings), name
        assert d.qtune_space == jd.qtune_space, name
        assert (d.qprep is None) == (jd.qprep is None), name
        assert (d.qok is None) == (jd.qok is None), name


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
@pytest.mark.parametrize("name", QUANT_OPS)
def test_apply_node_int8_vs_jax(name, lw, jlw):
    d = opdefs.OPDEFS[name]
    args = d.make_args(_rng("node", name), 256)
    arrays = [a for a in args if isinstance(a, np.ndarray)]
    node, jnode = _qnode(graph, d, args), _qnode(jgraph, jopdefs.OPDEFS[name],
                                                 args)
    got = plan_lib.apply_node(node, [_t(a) for a in arrays], lw, None, "int8")
    want = np.asarray(jax.jit(lambda *a: jplan.apply_node(
        jnode, a, jlw, None, "int8"))(*[jnp.asarray(a) for a in arrays]))
    if any(np.iscomplexobj(a) for a in arrays):
        _two_ulp(got, want)
    else:
        _bitwise(got, want)
    # the kernel lowering equals the torch integer path bit for bit
    _bitwise(got, plan_lib.apply_node(node, [_t(a) for a in arrays],
                                      "native", None, "int8"))


# ---------------------------------------------------------------------------
# pipelines at int8 and bf16 against the JAX compiled plan
# ---------------------------------------------------------------------------
def _pipe(name, size=2048):
    spec = JPIPELINES[name]
    (x,) = spec.make_args(_rng("pipe", name, size), size)
    return spec, x, getattr(graph, f"build_{name}")(), spec.build()


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
@pytest.mark.parametrize("name", PIPES)
def test_int8_pipeline_vs_jax(name, lw, jlw):
    spec, x, g, jg = _pipe(name)
    p = _quiet_compile(graph, g, {"x": x.shape}, precision="int8",
                       lowering=lw, device="cpu")
    jp = _quiet_compile(jgraph, jg, {"x": x.shape}, precision="int8",
                        lowering=jlw)
    assert p.precisions == jp.precisions
    assert p.downgrades == {n: t.replace("pallas", "kernel")
                            for n, t in jp.downgrades.items()}
    assert "int8" in p.precisions.values()
    got = p(_t(x))
    want = np.asarray(jp(jnp.asarray(x)))
    if name in RECOMBINE:
        _two_ulp(got, want)
    else:
        _bitwise(got, want)
    if lw == "kernel":
        q_nodes = [n for n, pr in p.precisions.items() if pr == "int8"
                   and opdefs.OPDEFS[p.graph.nodes[n].op].qimpl is not None]
        assert q_nodes and all(
            p.node_lowerings[n] == ("kernel" if "kernel" in opdefs.OPDEFS[
                p.graph.nodes[n].op].q_lowerings else "native")
            for n in q_nodes)
        # the int8 kernels' plain versions == the torch integer path
        native = _quiet_compile(graph, g, {"x": x.shape}, precision="int8",
                                device="cpu")
        _bitwise(got, native(_t(x)))


def _bf16_ulp(v):
    """One bf16 ulp at |v| (bf16 keeps 8 of f32's 24 significant bits)."""
    return np.spacing(np.abs(v).astype(np.float32)) * np.float32(2 ** 16)


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
@pytest.mark.parametrize("name", PIPES)
def test_bf16_pipeline_vs_jax(name, lw, jlw):
    spec, x, g, jg = _pipe(name)
    p = graph.compile(g, {"x": x.shape}, precision="bf16", lowering=lw,
                      device="cpu")
    jp = jgraph.compile(jg, {"x": x.shape}, precision="bf16", lowering=jlw)
    assert p.precisions == jp.precisions
    assert set(p.precisions.values()) == {"bf16"} and p.downgrades == {}
    got = p(_t(x)).numpy()
    want = np.asarray(jp(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.all(np.abs(got - want)
                  <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


@pytest.mark.parametrize("name", PIPES)
def test_precision_budgets_vs_oracle(name):
    """tests/test_precision.py:48-75: int8 clears the strictest declared
    int8 budget, bf16 its 30 dB default, against the numpy oracle."""
    spec, x, g, _ = _pipe(name)
    floors = [d.budget("int8").sqnr_db for d in opdefs.OPDEFS.values()
              if d.budget("int8") is not None]
    want = spec.oracle(x)
    p8 = _quiet_compile(graph, g, {"x": x.shape}, precision="int8",
                        lowering="kernel", device="cpu")
    assert opdefs.sqnr_db(want, p8(_t(x))) >= min(floors)
    pb = graph.compile(g, {"x": x.shape}, precision="bf16", device="cpu")
    assert opdefs.sqnr_db(want, pb(_t(x))) >= 30.0
    assert opdefs.sqnr_db(want, want) == float("inf")


# ---------------------------------------------------------------------------
# planner contract: cache key, engines, errors, downgrades, fusion, packs
# ---------------------------------------------------------------------------
def _unique(g, tag):
    g.name = f"{g.name}+{tag}"
    return g


def test_precision_and_engine_join_the_cache_key():
    _, x, g, _ = _pipe("pfb_power", 1024)
    g = _unique(g, "cachekey")
    shapes = {"x": x.shape}
    p32 = graph.compile(g, shapes, device="cpu")
    p8 = _quiet_compile(graph, g, shapes, precision="int8", device="cpu")
    pb = graph.compile(g, shapes, precision="bf16", device="cpu")
    assert len({id(p32), id(p8), id(pb)}) == 3
    hits = plan_lib.cache_stats()["hits"]
    assert _quiet_compile(graph, g, shapes, precision="int8",
                          device="cpu") is p8
    assert plan_lib.cache_stats()["hits"] == hits + 1
    with quantize.engine_override("ref"):
        assert quantize.engine() == "ref"
        pref = _quiet_compile(graph, g, shapes, precision="int8",
                              device="cpu")
        assert pref is not p8
        out_ref = pref(_t(x))
    assert quantize.engine() == "int"
    _bitwise(p8(_t(x)), out_ref)
    assert not np.array_equal(p32(_t(x)).numpy(), p8(_t(x)).numpy())


def test_int_and_ref_engines_bit_identical():
    rng = _rng("engines")
    x = rng.standard_normal((3, 16 * 40)).astype(np.float32)
    taps = pfb_window(16, 8).astype(np.float32)
    xq = _t(rng.integers(-127, 128, (33, 70)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (70, 19)).astype(np.int8))
    outs = {}
    for eng in ("int", "ref"):
        with quantize.engine_override(eng):
            outs[eng] = (quantize.int8_dot(xq, wq),
                         quantize.qpfb(_t(x), _t(taps)),
                         quantize.qfir(_t(x), _t(taps[0])),
                         ops.qdft(_t(x[:, :64])))
    assert outs["int"][0].dtype == torch.int32
    _bitwise(outs["int"][0],
             (xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64))
             .astype(np.int32))
    for a, b in zip(outs["int"], outs["ref"]):
        _bitwise(a, b)
    with pytest.raises(ValueError, match="unknown quantize engine"):
        with quantize.engine_override("float"):
            pass
    with quantize.engine_override("ref"), \
            pytest.raises(RuntimeError, match="CPU only"):
        quantize.int8_dot(xq.to("meta"), wq.to("meta"))


def test_unknown_tier_and_auto_raise(tmp_path, monkeypatch):
    """An unknown tier raises; precision="auto" (plan-wide or one node's
    entry) compiles, and under TINA_AUTOTUNE=cached with a cold cache it
    measures nothing and answers f32: the kernel f32 plan, bit for bit."""
    g = graph.build_spectrogram()
    with pytest.raises(ValueError, match="unknown tier"):
        graph.compile(g, {"x": (512,)}, precision="fp4", device="cpu")
    with pytest.raises(ValueError, match="unknown tier"):
        graph.compile(g, {"x": (512,)}, precision={"dft2": "int4"},
                      device="cpu")
    monkeypatch.setenv("TINA_AUTOTUNE", "cached")
    monkeypatch.setenv("TINA_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    x = _rng("auto-tier").standard_normal(512).astype(np.float32)
    want = graph.compile(g, {"x": (512,)}, lowering="kernel",
                         device="cpu")(x)
    for prec in ("auto", {"dft2": "auto"}):
        plan = graph.compile(g, {"x": (512,)}, precision=prec,
                             lowering="kernel", device="cpu")
        assert set(plan.node_precisions.values()) == {"f32"}
        assert torch.equal(plan(x), want)
    assert not (tmp_path / "tune.json").exists()


def test_precision_downgrades_recorded_and_warned_once():
    g = graph.Graph("dft_power+prec_downgrade")
    z = g.apply("dft", g.input("x"))
    a = g.apply("abs2", z)
    g.output(a)
    with pytest.warns(UserWarning, match="fell back to precision='f32'"):
        p = graph.compile(g, {"x": (4, 64)}, precision="int8", device="cpu")
    assert p.downgrades == {a: "precision:int8"}
    assert p.node_precisions == {z: "int8", a: "f32"}
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        graph.compile(g, {"x": (8, 64)}, precision="int8", device="cpu")
    # both dimensions on one node: comma-joined tags, one warning naming
    # each dimension
    opdefs.register(opdefs.OpDef("negate_native_only",
                                 lambda a_, at, lw, b=None: -a_[0]))
    try:
        g2 = graph.Graph("both_dims")
        n = g2.apply("negate_native_only", g2.input("x"))
        g2.output(n)
        with pytest.warns(UserWarning) as rec:
            p2 = graph.compile(g2, {"x": (4,)}, lowering="kernel",
                               precision="int8", device="cpu")
        assert p2.downgrades == {n: "lowering:kernel,precision:int8"}
        msg = str(rec[0].message)
        assert "lowering='native'" in msg and "precision='f32'" in msg
    finally:
        del opdefs.OPDEFS["negate_native_only"]


def test_pfb_power_int8_kernel_plan_downgrades_abs2_only():
    g = graph.build_pfb_power(16, 8)
    p = _quiet_compile(graph, g, {"x": (2, 16 * 40)}, precision="int8",
                       lowering="kernel", device="cpu")
    assert p.node_precisions == {"pfb2": "int8", "abs23": "f32"}
    assert p.node_lowerings == {"pfb2": "kernel", "abs23": "kernel"}
    assert p.downgrades == {"abs23": "precision:int8"}
    # int8 + conv: the qimpl has no conv, so the node quietly runs native
    pc = _quiet_compile(graph, g, {"x": (2, 16 * 40)}, precision="int8",
                        lowering="conv", device="cpu")
    assert pc.node_lowerings["pfb2"] == "native"
    assert "pfb2" not in pc.downgrades


def _window_scale_graph(tag):
    g = graph.Graph(f"winscale+{tag}")
    x = g.input("x")
    w = g.const(np.hanning(64).astype(np.float32), "win")
    a = g.apply("window", x, w)
    b = g.apply("scale", a, factor=0.5)
    g.output(b)
    return g, a, b


def test_precision_dict_is_a_fusion_boundary():
    shapes = {"x": (8, 64)}
    x = _rng("fusion").standard_normal((8, 64)).astype(np.float32)
    g, a, b = _window_scale_graph("fused")
    p_same = graph.compile(g, shapes, precision={a: "bf16", b: "bf16"},
                           device="cpu")
    (fused,) = [n for n in p_same.graph.topo() if n.op == "fused_ew"]
    assert p_same.precisions[fused.name] == "bf16"
    g2, a2, b2 = _window_scale_graph("split")
    p_mixed = graph.compile(g2, shapes, precision={a2: "bf16", b2: "f32"},
                            device="cpu")
    assert not any(n.op == "fused_ew" for n in p_mixed.graph.topo())
    assert (p_mixed.precisions[a2], p_mixed.precisions[b2]) == ("bf16", "f32")
    np.testing.assert_allclose(p_same(_t(x)).numpy(), p_mixed(_t(x)).numpy(),
                               rtol=2e-2, atol=2e-2)
    # the same split in the JAX planner
    jg2 = jgraph.Graph("winscale+split")
    jx = jg2.input("x")
    jw = jg2.const(np.hanning(64).astype(np.float32), "win")
    ja = jg2.apply("window", jx, jw)
    jg2.output(jg2.apply("scale", ja, factor=0.5))
    jp = jgraph.compile(jg2, shapes, precision={ja: "bf16", b2: "f32"})
    assert [n.op for n in jp.graph.topo()] == [n.op for n in
                                               p_mixed.graph.topo()]


@pytest.mark.parametrize("name", PIPES)
def test_qconsts_built_once_at_compile_equal_jax(name):
    _, x, g, jg = _pipe(name, 256)
    p = _quiet_compile(graph, g, {"x": x.shape}, precision="int8",
                       lowering="kernel", device="cpu")
    jp = _quiet_compile(jgraph, jg, {"x": x.shape}, precision="int8",
                        lowering="pallas")
    assert sorted(p.qconsts) == sorted(jp.qconsts)
    for node, pack in p.qconsts.items():
        for got, want in zip(pack, jp.qconsts[node]):
            assert got.device == p.device
            _bitwise(got, want)
    calls = []
    real = quantize.quantize_symmetric
    quantize.quantize_symmetric = lambda *a, **k: (calls.append(k),
                                                   real(*a, **k))[1]
    try:
        p(_t(x))
    finally:
        quantize.quantize_symmetric = real
    # per call only activations quantize (rows or windows): no axis-0
    # weight pack is rebuilt
    assert all(k.get("axis") != 0 for k in calls)


def test_int8_tune_spaces_valid_at_pipeline_shapes():
    """Each int8 space's default is valid at the shapes the pipelines
    give it, both at the test sizes and at the card's full widths, and
    states the CUDA kernel's own limits (compiled tiles, 227 KB)."""
    cases = {
        "matmul_int8": [{"m": 256, "n": 256, "k": 256},
                        {"m": 4096, "n": 4096, "k": 4096},
                        {"m": 8188, "n": 1024, "k": 1024}],
        "dft_int8": [{"m": 523_784, "n": 64, "k": 64},
                     {"m": 8188, "n": 1024, "k": 1024}],
        "fir_int8": [{"k": 31, "n": 2 ** 22, "rows": 16},
                     {"k": 15, "n": 2 ** 21, "rows": 16},
                     {"k": 63, "n": 2 ** 22, "rows": 16},
                     {"k": 4097, "n": 2 ** 16, "rows": 2}],
        "pfb_int8": [{"m": 8, "p": 1024, "t": 4096},
                     {"m": 4, "p": 16, "t": 65536},
                     {"m": 8, "p": 48, "t": 30}],
    }
    for kernel, ctxs in cases.items():
        sp = tune.space(kernel)
        assert sp is not None and sp.params, kernel
        for ctx in ctxs:
            cfg = sp.check({}, ctx)
            assert sp.valid(cfg, ctx), (kernel, ctx, cfg)
            assert sp.configs(ctx)[0] == cfg
    assert tune.space("pfb_int8") is pfbk.TUNE_SPACE_INT8
    assert pfbk.int8_smem_bytes(128, 128, 1024) <= tune.SMEM_BUDGET
    # the frontend keeps one 16-byte y slot per four branches of a frame:
    # P = 4096 (past the SIMT kernel's 2,669) fits, and P = 57,344 is the
    # widest that does; the next P past it is refused, as is a tile the
    # DFT stage does not compile
    assert pfbk.TUNE_SPACE_INT8.valid({"bt": 128, "bn": 128},
                                      {"m": 8, "p": 4096, "t": 64})
    assert pfbk.frontend_smem_bytes(57_344) <= tune.SMEM_BUDGET \
        < pfbk.frontend_smem_bytes(57_345)
    big = {"m": 8, "p": 57_345, "t": 64}
    assert not any(pfbk.TUNE_SPACE_INT8.valid({"bt": bt, "bn": bn}, big)
                   for bt, bn in pfbk.TILES_INT8)
    with pytest.raises(ValueError, match="invalid block config"):
        ops.qpfb(torch.zeros(57_345 * 10),
                 torch.zeros(8, 57_345, dtype=torch.int8),
                 torch.ones(1, 57_345), bt=128)
    with pytest.raises(ValueError, match="invalid block config"):
        ops.qpfb(torch.zeros(1024 * 10), torch.zeros(8, 1024, dtype=torch.int8),
                 torch.ones(1, 1024), bt=16)
    with pytest.raises(ValueError, match="invalid block config"):
        ops.qmatmul(torch.zeros(4, 8), torch.zeros(8, 8, dtype=torch.int8),
                    torch.ones(8), bm=96)
    with pytest.raises(ValueError, match="invalid block config"):
        ops.qfir(torch.zeros(2, 100), torch.zeros(5, 1, dtype=torch.int8),
                 torch.ones(1, 1), bn=1024, threads=100)
    assert dftk.TUNE_SPACE_INT8.params == ("bm", "bn", "bk")
    assert firk.TUNE_SPACE_INT8.check({}, {"k": 31})["threads"] == 128


def test_cpu_int8_plans_launch_no_kernel():
    before = (mmk.INT8_LAUNCHES, dftk.INT8_LAUNCHES, firk.INT8_LAUNCHES,
              pfbk.INT8_LAUNCHES)
    for name in PIPES:
        _, x, g, _ = _pipe(name, 256)
        _quiet_compile(graph, g, {"x": x.shape}, precision="int8",
                       lowering="kernel", device="cpu")(_t(x))
    assert (mmk.INT8_LAUNCHES, dftk.INT8_LAUNCHES, firk.INT8_LAUNCHES,
            pfbk.INT8_LAUNCHES) == before


# -- csrc/int8.cuh:quantize_rcp, emulated exactly on the CPU ---------------
def _rn32(v):
    """The Fraction v rounded to the nearest float32, ties to even,
    subnormals kept (what one IEEE float32 operation returns)."""
    from fractions import Fraction
    if v == 0:
        return np.float32(0.0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    m = a / ulp
    n, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and n % 2):
        n += 1
    return np.float32(float(n * ulp) * (1 if v > 0 else -1))


def _quantize_rcp(x, s, r):
    """csrc/int8.cuh:quantize_rcp step by step in float32: q0 = x r (one
    rounding), the two FMAs with one rounding each (exact rational
    arithmetic, then _rn32) and the magic-number add; no clamp, as the
    kernels take none (the clip never binds on [-amax, amax])."""
    from fractions import Fraction
    q0 = np.float32(x * r)
    e = _rn32(Fraction(float(x)) - Fraction(float(q0)) * Fraction(float(s)))
    q1 = _rn32(Fraction(float(e)) * Fraction(float(r)) + Fraction(float(q0)))
    t = np.float32(q1 + np.float32(12582912.0))
    return int(np.array(t, dtype=np.float32).view(np.int32)) - 0x4B400000


def _quantize_pairs():
    """(x, amax) pairs over the quantizer's domain, x in [-amax, amax]:
    amax log-uniform from 1e-30 to 1e30, powers of two, 127 2^k and one
    ulp either side, under the 1e-12 clamp, and amax = 1.1162109375 2^k,
    whose scale 9/1024 2^k puts x = (k + 1/2) s exactly on half-integer
    quotients; x: +-amax, both zeros, subnormals, uniform draws, the
    half-integers and one ulp either side of each."""
    f32 = np.float32
    rng = _rng("quantize_rcp")
    base = [f32(2.0) ** k for k in range(-40, 41, 8)] \
        + [f32(127) * f32(2.0) ** k for k in range(-40, 41, 8)]
    amaxes = base + [np.nextafter(v, d) for v in base
                     for d in (f32(0), f32(np.inf))]
    amaxes += [f32(0), f32(1e-45), f32(1e-20), f32(5e-13), f32(1e-12)]
    amaxes += list((10.0 ** rng.uniform(-30, 30, 160)).astype(np.float32))
    half = [f32(1.1162109375) * f32(2.0) ** k for k in range(-30, 31, 6)]
    pairs = []
    for j, a in enumerate(amaxes + half):
        s = f32(max(a, f32(1e-12)) * f32(f32(1.0) / f32(127.0)))
        xs = [a, -a, f32(0.0), f32(-0.0), f32(1e-45), f32(-3e-42),
              f32(1e-38)]
        xs += list((rng.uniform(-1, 1, 300) * a).astype(np.float32))
        # x nearest (k + 1/2) s and one ulp either side: quotients within
        # an ulp of a half-integer, where x r alone often rounds wrong
        near = (rng.integers(-127, 127, 40) + 0.5) * np.float64(s)
        xs += [v for h in near.astype(np.float32)
               for v in (h, np.nextafter(h, f32(-1)), np.nextafter(h, f32(1)))]
        if any(a == h for h in half):
            assert s == f32(9 / 1024) * (a / f32(1.1162109375))
            hk = (np.arange(-127, 127) + 0.5).astype(np.float32) * s
            assert np.all(hk / s - np.floor(hk / s) == f32(0.5))
            xs += [v for h in hk for v in (h, np.nextafter(h, f32(-1)),
                                           np.nextafter(h, f32(1)))]
        pairs += [(f32(x), a) for x in xs if abs(x) <= a]
    return pairs


def test_quantize_rcp_sequence_equals_the_division_bit_for_bit():
    """The reciprocal, two FMAs and the magic-number add of
    csrc/int8.cuh:quantize_rcp, emulated exactly in float32, give the
    ints of core/quantize.py (torch.round(x / s), clipped: the clip never
    binds) on every pair:
    half-integer quotients and their one-ulp neighbours, the 1e-12
    clamp, zeros, subnormal x and +-amax among them."""
    from fractions import Fraction
    pairs = _quantize_pairs()
    assert len(pairs) >= 100_000
    xs = np.array([x for x, _ in pairs], dtype=np.float32)
    am = np.array([a for _, a in pairs], dtype=np.float32)
    s = quantize.scale_of(_t(am))
    want = quantize.quantize_with(_t(xs), s).numpy().astype(int)
    recip = {}
    got = []
    for x, sv in zip(xs, s.numpy()):
        if sv not in recip:                          # __frcp_rn, per scale
            recip[sv] = _rn32(1 / Fraction(float(sv)))
        got.append(_quantize_rcp(x, sv, recip[sv]))
    got = np.array(got)
    assert np.array_equal(got, want), np.flatnonzero(got != want)[:8]
    # the cases that matter were there: exact half-integer quotients
    # rounded to even, the clamp, and quotients where the fix-up decides
    # (x times the reciprocal alone rounds to another int)
    sv = s.numpy()
    q = xs / sv
    assert np.sum(q - np.floor(q) == np.float32(0.5)) >= 1000
    assert np.sum(np.abs(got) == 127) >= 100
    r = np.array([recip[v] for v in sv], dtype=np.float32)
    assert np.sum(np.rint(xs * r) != np.rint(q)) >= 1000


def test_quantize_check_counts_and_refuses_the_cpu():
    """The card's exhaustive check (csrc/qcheck.cu) tries every float x in
    [-amax, amax]: 2 (bits(amax) + 1) pairs per scale.  It has no plain
    version (some 2**31 values per scale) and refuses a CPU tensor."""
    a = torch.tensor([0.0, 1e-45, 1.0], dtype=torch.float32)
    assert firk.quantize_check_pairs(a) == 2 + 4 + 2 * (0x3F800000 + 1)
    with pytest.raises(ValueError, match="CUDA"):
        firk.quantize_check(a)


@pytest.mark.parametrize("k,k4", [(1, 4), (4, 4), (15, 16), (31, 32),
                                  (63, 64)])
def test_fir_int8_stages_taps_packed_and_padded(k, k4):
    """csrc/qfir.cu stages bn + K4 samples, its bn outputs and the taps
    packed four to a word, K padded with zero taps to K4; a thread takes
    four neighbouring outputs, so bn is a multiple of 4."""
    assert firk.int8_smem_bytes(1024, k) == 4 * (2 * 1024 + k4) + k4
    sp = firk.TUNE_SPACE_INT8
    assert sp.valid({"bn": 1024, "threads": 256}, {"k": k})
    assert not sp.valid({"bn": 1022, "threads": 256}, {"k": k})
