"""The port's spectral slice against the JAX package, on the CPU: the
unfold, overlap-add, DFT and binary elementwise wrappers, the op
mappings that reach them, and the ``spectrogram`` and
``stft_overlap_add`` pipelines end to end.

Inputs come from numpy with a fixed seed and go to both packages.  The
JAX functions reach their Pallas kernels in interpret mode off-TPU, as
the JAX suite runs them; the port's wrappers run their kernels' plain
torch versions for CPU tensors (the CUDA kernels run only on a card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Tolerances are
the JAX suite's own: unfold and overlap-add exact, the DFT 1e-3 and the
elementwise ops 1e-6 (``tests/test_kernels.py``), pipelines 2e-3 against
the JAX plan and the numpy oracle (``tests/test_graph.py``).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.core import functions as jfunctions
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import graph
from repro_torch.core import functions
from repro_torch.kernels import dft as dftk
from repro_torch.kernels import elementwise as ewk
from repro_torch.kernels import ops, ref, tune
from repro_torch.kernels import pfb as pfbk
from repro_torch.kernels import unfold as unfk

LOWERINGS = [("native", "native"), ("conv", "conv"), ("kernel", "pallas")]
LW_IDS = [lw for lw, _ in LOWERINGS]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _dfm(n, inverse):
    lk = np.outer(np.arange(n), np.arange(n))
    f = np.exp((2j if inverse else -2j) * np.pi * lk / n)
    if inverse:
        f = f / n
    return f.real.astype(np.float32), f.imag.astype(np.float32)


# ---------------------------------------------------------------------------
# kernel wrappers against the JAX Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,n,j", [(2, 512, 16), (1, 100, 3), (4, 2048, 128),
                                   (3, 50, 1), (2, 37, 37)],
                         ids=["16", "3", "128", "J=1", "J=N"])
def test_unfold_exact_vs_jax(b, n, j):
    x = _rng("unfold", b, n, j).standard_normal((b, n)).astype(np.float32)
    want = np.asarray(jops.unfold(jnp.asarray(x), j))
    got = ops.unfold(_t(x), j).numpy()
    assert got.shape == want.shape == (b, n - j + 1, j)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("j,hop", [(64, 32), (16, 4), (8, 8), (30, 6),
                                   (15, 5)])
def test_overlap_add_exact_vs_jax(j, hop):
    frames = _rng("ola", j, hop).standard_normal((3, 29, j)) \
        .astype(np.float32)
    want = np.asarray(jops.overlap_add(jnp.asarray(frames), hop))
    want_native = np.asarray(jfunctions.overlap_add(
        jnp.asarray(frames), hop, lowering="native"))
    got = ops.overlap_add(_t(frames), hop).numpy()
    assert got.shape == want.shape == (3, (29 - j // hop + 1) * hop)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_native)


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
def test_overlap_add_complex_frames(lw, jlw):
    frames = _cplx(_rng("ola_c", lw), (2, 12, 16))
    want = np.asarray(jfunctions.overlap_add(jnp.asarray(frames), 4,
                                             lowering=jlw))
    got = functions.overlap_add(_t(frames), 4, lowering=lw).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    if lw == "conv":       # the identity conv multiplies by 1.0 and sums
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,n", [(4, 64), (1, 7), (3, 200), (1, 128)])
@pytest.mark.parametrize("variant", ["4mult", "3mult"])
def test_dft_vs_jax(rows, n, variant):
    rng = _rng("dft", rows, n, variant)
    for inverse in (False, True):
        fr, fi = _dfm(n, inverse)
        for cplx in (False, True):
            x = (_cplx(rng, (rows, n)) if cplx
                 else rng.standard_normal((rows, n)).astype(np.float32))
            xr = np.ascontiguousarray(x.real).astype(np.float32)
            xi = (np.ascontiguousarray(x.imag).astype(np.float32) if cplx
                  else np.zeros_like(xr))
            wr, wi = jops.dft(jnp.asarray(xr), jnp.asarray(xi),
                              jnp.asarray(fr), jnp.asarray(fi),
                              variant=variant)
            got = ops.dft(_t(x), _t(fr), _t(fi), variant=variant).numpy()
            assert got.shape == (rows, n) and got.dtype == np.complex64
            np.testing.assert_allclose(got.real, np.asarray(wr), rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(got.imag, np.asarray(wi), rtol=1e-3,
                                       atol=1e-3)


@pytest.mark.parametrize("name", ["mult", "add"])
@pytest.mark.parametrize("row", [False, True], ids=["full", "row"])
def test_elementwise_vs_jax(name, row):
    rng = _rng("ew", name, row)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    y = rng.standard_normal((64,) if row else (2, 5, 64)).astype(np.float32)
    want = np.asarray(getattr(jops, f"elementwise_{name}")(jnp.asarray(x),
                                                          jnp.asarray(y)))
    got = getattr(ops, f"elementwise_{name}")(_t(x), _t(y)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["mult", "add"])
@pytest.mark.parametrize("xs,ys", [((33, 33), (33, 1)),
                                   ((2, 16, 16), (16, 1))],
                         ids=["square", "t_equals_j"])
def test_elementwise_column_broadcast(name, xs, ys):
    """A column y with as many entries as x has columns is no row: the
    wrapper broadcasts it down the columns, as JAX does, and the kernel
    wrapper refuses it on either device rather than read it as a row."""
    rng = _rng("ewcol", name, xs)
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float32)
    want = np.asarray(getattr(jops, f"elementwise_{name}")(jnp.asarray(x),
                                                          jnp.asarray(y)))
    got = getattr(ops, f"elementwise_{name}")(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="nor a row"):
        getattr(ewk, f"elementwise_{name}")(_t(x), _t(y))


def test_ref_dft_and_unfold_twins_match_jax():
    rng = _rng("ref")
    xr, xi = (rng.standard_normal((5, 24)).astype(np.float32)
              for _ in range(2))
    fr, fi = _dfm(24, False)
    got = ref.ref_dft(_t(xr), _t(xi), _t(fr), _t(fi))
    want = jref.ref_dft(*(jnp.asarray(a) for a in (xr, xi, fr, fi)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    x = rng.standard_normal((2, 40)).astype(np.float32)
    np.testing.assert_array_equal(ref.ref_unfold(_t(x), 9).numpy(),
                                  np.asarray(jref.ref_unfold(jnp.asarray(x),
                                                             9)))


def test_plain_versions_match_ref():
    """The kernels' plain versions against the torch oracles."""
    rng = _rng("plain")
    x = _t(rng.standard_normal((3, 70)).astype(np.float32))
    torch.testing.assert_close(unfk.unfold_plain(x, 11),
                               ref.ref_unfold(x, 11), rtol=0, atol=0)
    fr, fi = (_t(a) for a in _dfm(16, False))
    z = _t(_cplx(rng, (4, 16)))
    wr, wi = ref.ref_dft(z.real, z.imag, fr, fi)
    for variant in dftk.VARIANTS:
        got = dftk.dft_plain(z, fr, fi, variant)
        torch.testing.assert_close(got.real, wr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got.imag, wi, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the op mappings at every lowering
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
def test_unfold_and_overlap_add_functions_match_jax(lw, jlw):
    rng = _rng("fn_unfold", lw)
    x = rng.standard_normal((2, 90)).astype(np.float32)
    got = functions.unfold(_t(x), 12, lowering=lw).numpy()
    want = np.asarray(jfunctions.unfold(jnp.asarray(x), 12, lowering=jlw))
    np.testing.assert_array_equal(got, want)
    frames = rng.standard_normal((2, 20, 32)).astype(np.float32)
    got = functions.overlap_add(_t(frames), 8, lowering=lw).numpy()
    want = np.asarray(jfunctions.overlap_add(jnp.asarray(frames), 8,
                                             lowering=jlw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
@pytest.mark.parametrize("variant", ["4mult", "3mult"])
def test_dft_idft_functions_match_jax(lw, jlw, variant):
    rng = _rng("fn_dft", lw, variant)
    for x in (rng.standard_normal((3, 2, 24)).astype(np.float32),
              _cplx(rng, (3, 24))):
        for name in ("dft", "idft"):
            got = getattr(functions, name)(_t(x), lowering=lw,
                                           variant=variant).numpy()
            want = np.asarray(getattr(jfunctions, name)(
                jnp.asarray(x), lowering=jlw, variant=variant))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("lw,jlw", LOWERINGS, ids=LW_IDS)
def test_elementwise_functions_match_jax(lw, jlw):
    rng = _rng("fn_ew", lw)
    a = rng.standard_normal((2, 8, 12)).astype(np.float32)
    c = rng.standard_normal((2, 8, 12)).astype(np.float32)
    for name in ("elementwise_mult", "elementwise_add"):
        for y in (c, c[0]):           # batched and shared second operand
            np.testing.assert_allclose(
                getattr(functions, name)(_t(a), _t(y), lowering=lw).numpy(),
                np.asarray(getattr(jfunctions, name)(
                    jnp.asarray(a), jnp.asarray(y), lowering=jlw)),
                rtol=1e-6, atol=1e-6)


def test_dfm_is_cached_per_device():
    a = functions._dfm_tensors(32, False, torch.float32, "cpu")
    b = functions._dfm_tensors(32, False, torch.float32, "cpu")
    assert a[0] is b[0] and a[1] is b[1]
    assert functions._dfm_tensors(32, True, torch.float32, "cpu")[0] \
        is not a[0]


# ---------------------------------------------------------------------------
# the two pipelines end to end
# ---------------------------------------------------------------------------
PIPES = [("spectrogram", (16,)), ("spectrogram", (64,)),
         ("stft_overlap_add", (64, 32)), ("stft_overlap_add", (16, 4))]
PIPE_IDS = [f"{name}{'-'.join(map(str, args))}" for name, args in PIPES]


def _build(gmod, name, args):
    return getattr(gmod, f"build_{name}")(*args)


@pytest.mark.parametrize("name,args", PIPES, ids=PIPE_IDS)
@pytest.mark.parametrize("shape", [(400,), (3, 400)], ids=["1d", "batched"])
def test_kernel_plan_matches_jax_and_oracle(name, args, shape):
    x = _rng("pipe", name, args, shape).standard_normal(shape) \
        .astype(np.float32)
    g = _build(graph, name, args)
    plan = graph.compile(g, {"x": shape}, lowering="kernel", device="cpu")
    jplan = jgraph.compile(_build(jgraph, name, args), {"x": shape},
                           options=jgraph.CompileOptions(lowering="pallas"))
    assert [n.op for n in plan.graph.topo()] == \
        [n.op for n in jplan.graph.topo()]
    assert plan.downgrades == {} == jplan.downgrades
    agnostic = {"real", "frame_decimate"}
    for node, lw in plan.node_lowerings.items():
        op = plan.graph.nodes[node].op
        assert lw == ("native" if op in agnostic else "kernel"), (node, lw)
    if name == "spectrogram":
        assert [n.op for n in plan.graph.topo()][2:] == \
            ["unfold", "window", "dft", "fused_ew"]
    got = plan(_t(x)).numpy()
    want_jax = np.asarray(jplan(jnp.asarray(x)))
    want = getattr(graph, f"{name}_oracle")(*args)(x)
    assert got.shape == want_jax.shape == want.shape
    np.testing.assert_allclose(got, want_jax, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _spec_of(g) -> dict:
    return {"name": g.name,
            "nodes": [(n.name, n.op, n.inputs, n.attrs) for n in g.topo()],
            "inputs": list(g.inputs), "outputs": list(g.outputs),
            "consts": {k: np.asarray(v) for k, v in g.consts.items()}}


@pytest.mark.parametrize("name,args", [PIPES[1], PIPES[2]],
                         ids=[PIPE_IDS[1], PIPE_IDS[2]])
def test_load_graph_of_jax_graphs(name, args):
    jg = _build(jgraph, name, args)
    g = graph.load_graph(_spec_of(jg))
    assert g.signature == jg.signature == _build(graph, name, args).signature
    x = _rng("load", name).standard_normal((2, 300)).astype(np.float32)
    got = graph.compile(g, {"x": x.shape}, lowering="kernel",
                        device="cpu")(x).numpy()
    want = np.asarray(jgraph.compile(
        jg, {"x": x.shape},
        options=jgraph.CompileOptions(lowering="pallas"))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------
def test_invalid_block_configs_raise():
    x = torch.randn(2, 64)
    fr, fi = functions._dfm_tensors(64, False, torch.float32, "cpu")
    cases = [
        lambda: ops.unfold(x, 8, bt=0),
        lambda: ops.unfold(x, 8, bj=0),
        lambda: ops.unfold(x, 8, bt=tune.SMEM_BUDGET),
        lambda: ops.overlap_add(x.reshape(2, 4, 16), 8, threads=100),
        lambda: ops.dft(x, fr, fi, bm=48),
        lambda: ops.dft(x, fr, fi, bm=64, bn=128),
        lambda: ops.elementwise_mult(x, x, threads=100),
        lambda: ops.elementwise_add(x, x, threads=2048),
    ]
    for case in cases:
        with pytest.raises(ValueError, match="invalid block config"):
            case()
    with pytest.raises(ValueError, match="unknown block param"):
        tune.space("unfold").check({"bb": 8}, {"j": 8, "n": 64, "rows": 2})
    g = graph.build_spectrogram(16)
    bad = graph.compile(g, {"x": (200,)}, lowering="kernel", device="cpu",
                        block_configs={"dft4": {"bm": 48}})
    with pytest.raises(ValueError, match="invalid block config"):
        bad(torch.zeros(200))


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="window"):
        ops.unfold(torch.randn(2, 10), 11)
    with pytest.raises(ValueError, match="must divide"):
        functions.overlap_add(torch.randn(6, 16), 5)
    with pytest.raises(ValueError, match="unknown dft variant"):
        functions.dft(torch.randn(2, 8), lowering="kernel", variant="2mult")
    with pytest.raises(ValueError, match="no kernel for device"):
        unfk.unfold(torch.empty(2, 8, device="meta"), 3)
    with pytest.raises(ValueError, match="no kernel for device"):
        dftk.dft(torch.empty(2, 8, device="meta"),
                 torch.empty(8, 8, device="meta"),
                 torch.empty(8, 8, device="meta"))


def _counts():
    return (unfk.LAUNCHES, unfk.OLA_LAUNCHES, dftk.LAUNCHES,
            ewk.BINARY_LAUNCHES, ewk.LAUNCHES, pfbk.LAUNCHES)


def test_cpu_plans_launch_no_kernel():
    before = _counts()
    for name, args in PIPES[1:3]:
        g = _build(graph, name, args)
        graph.compile(g, {"x": (2, 300)}, lowering="kernel",
                      device="cpu")(torch.randn(2, 300))
    x = torch.randn(3, 64)
    ops.elementwise_add(x, x[0])
    ops.overlap_add(x.reshape(3, 4, 16), 16)
    assert _counts() == before


def test_tune_spaces_describe_the_cuda_kernels():
    sp = tune.space("unfold")
    assert sp is unfk.TUNE_SPACE and sp.params == ("bt", "bj")
    # no halo rule: a 4096-sample window fits a one-frame tile
    ctx = {"j": 4096, "n": 2 ** 20, "rows": 4}
    assert sp.valid({"bt": 1, "bj": 4096}, ctx)
    assert sp.check({}, {"j": 1024, "n": 2 ** 20, "rows": 4}) == \
        {"bt": 8, "bj": 1024}
    assert all(sp.valid(c, ctx) for c in sp.configs(ctx))
    dsp = tune.space("dft")
    assert dsp is dftk.TUNE_SPACE
    assert {(c["bm"], c["bn"]) for c in dsp.configs(
        {"m": 8188, "n": 1024, "k": 1024})} == set(dftk.TILES)
    # N <= 16 takes the 16-wide tile, wider N the 64-wide one
    assert dsp.check({}, {"m": 4, "n": 7, "k": 7}) == {"bm": 128, "bn": 16}
    assert dsp.check({}, {"m": 4, "n": 17, "k": 7}) == {"bm": 128, "bn": 64}
    # the largest ring (complex x, three planes) fits
    assert all(dftk.smem_bytes(bm, bn) <= tune.SMEM_BUDGET
               for bm, bn in dftk.TILES)
    assert tune.space("overlap_add") is unfk.OLA_TUNE_SPACE


# ---------------------------------------------------------------------------
# the 3xTF32 DFT kernel's host side: the TF32 planes of the DFM, the split
# they rest on, and its accuracy (emulated in torch: the sandbox's
# measurement; the card's is chip_smoke.py's float64 check)
# ---------------------------------------------------------------------------
DFT_RTOL = 1e-4     # chip_smoke.py: the kernel against its plain version


@pytest.mark.parametrize("n", [7, 64, 100])
@pytest.mark.parametrize("inverse", [False, True], ids=["dft", "idft"])
@pytest.mark.parametrize("variant", dftk.VARIANTS)
def test_dfm_tf32_planes_against_jax_dfm(n, inverse, variant):
    planes = functions._dfm_tf32_tensors(n, inverse, variant, "cpu")
    jr, ji = jfunctions._dfm(n, inverse, "float32")
    want = [jr, ji] if variant == "4mult" else [jr, ji - jr, jr + ji]
    n_pad, l_pad = -(-n // dftk.N_ALIGN) * dftk.N_ALIGN, -(-n // 32) * 32
    assert planes.shape == (2 * len(want), n_pad, l_pad)
    assert planes.dtype == torch.float32 and planes.is_contiguous()
    # hi and lo are exact TF32 values: their low 13 bits are zero
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    for p, f in enumerate(want):
        hi, lo = planes[2 * p].numpy(), planes[2 * p + 1].numpy()
        # K-major: row n of a plane is column n of F
        got = hi[:n, :n].astype(np.float64) + lo[:n, :n]
        assert (np.abs(got - f.T.astype(np.float64)).max()
                <= 2.0 ** -21 * np.abs(f).max())
        pad = np.ones(hi.shape, bool)
        pad[:n, :n] = False
        assert not hi[pad].any() and not lo[pad].any()
    # made once per (n, inverse, variant, device)
    assert functions._dfm_tf32_tensors(n, inverse, variant, "cpu") is planes


def test_tf32_split_rounds_to_nearest_ties_away():
    f = torch.from_numpy(
        _rng("tf32").standard_normal(4096).astype(np.float32) * 1e3)
    hi, lo = dftk.tf32_split(f)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (f.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * f.double().abs()).all())
    # cvt.rna: a tie (bit 12 alone set below the TF32 mantissa) rounds
    # away from zero, either sign
    tie = torch.tensor([0x3F801000, -0x407FF000], dtype=torch.int32)
    up = dftk.tf32_split(tie.view(torch.float32))[0].view(torch.int32)
    assert up.tolist() == [0x3F802000, -0x407FE000]


def _tf32_product(x, hi, lo, n, passes):
    """x (B, L) f32 against one TF32-split plane (K-major (N, L)), with
    f32 sums: passes 3 is the kernel's Xhi Fhi + Xhi Flo + Xlo Fhi (each
    product of two TF32 values exact in f32), 1 a single TF32 pass."""
    l = x.shape[1]
    xh, xl = dftk.tf32_split(x)
    fh, fl = hi[:n, :l].t(), lo[:n, :l].t()
    if passes == 1:
        return xh @ fh
    return xl @ fh + xh @ fl + xh @ fh


@pytest.mark.parametrize("inverse", [False, True], ids=["dft", "idft"])
def test_3xtf32_emulation_within_dft_rtol_at_1024(inverse):
    """At the STFT's width, L = N = 1024, the 3xTF32 split (emulated with
    f32 sums) stays within DFT_RTOL of the fp32 product, 4mult on a real
    forward x and a complex inverse one; a single TF32 pass does not."""
    n = 1024
    rng = _rng("3xtf32", inverse)
    fr, fi = functions._dfm_tensors(n, inverse, torch.float32, "cpu")
    planes = functions._dfm_tf32_tensors(n, inverse, "4mult", "cpu")
    if inverse:
        x = _t(_cplx(rng, (32, n)))
    else:
        x = _t(rng.standard_normal((32, n)).astype(np.float32))
    want = dftk.dft_plain(x, fr, fi, "4mult")
    errs = {}
    for passes in (3, 1):
        def mm(a, p):
            return _tf32_product(a, planes[2 * p], planes[2 * p + 1], n,
                                 passes)
        xr = x.real if x.is_complex() else x
        zr, zi = mm(xr, 0), mm(xr, 1)
        if x.is_complex():
            zr, zi = zr - mm(x.imag, 1), zi + mm(x.imag, 0)
        got = torch.view_as_real(torch.complex(zr, zi))
        ref_ = torch.view_as_real(want)
        errs[passes] = float((got - ref_).abs().max() / ref_.abs().max())
    assert errs[3] <= DFT_RTOL
    assert errs[1] > DFT_RTOL > 10 * errs[3]


def test_dft_staging_is_decided_by_shape():
    """TMA reads rows that are 16-byte multiples from an aligned start;
    anything else goes through the zero-padded copy."""
    real = torch.zeros(4, 64)
    assert dftk.staging(real) == "tma"
    assert dftk.staging(torch.zeros(4, 7)) == "padded_copy"
    assert dftk.staging(torch.zeros(4, 8, dtype=torch.complex64)) == "tma"
    assert dftk.staging(torch.zeros(4, 7, dtype=torch.complex64)) == \
        "padded_copy"
    shifted = torch.zeros(4 * 64 + 1)[1:].view(4, 64)
    assert shifted.is_contiguous() and dftk.staging(shifted) == "padded_copy"
