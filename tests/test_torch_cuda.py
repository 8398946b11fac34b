"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here is marked ``cuda`` and skips without one; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch import graph
from repro_torch.core import functions, quantize
from repro_torch.kernels import dft as dftk
from repro_torch.kernels import elementwise as ewk
from repro_torch.kernels import fir as firk
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops
from repro_torch.kernels import pfb as pfbk
from repro_torch.kernels import unfold as unfk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


# ragged shapes: B Tout not a multiple of the DFT stage's 128 rows, P of
# one K chunk and of many, taps longer than a DFT tile, P = 37 and 1
# (y's row stride padded to 40 and 4, the frontend's scalar loads) and
# P = 20 (a stride of 20, no pad)
PFB_CASES = [(2, 301, 16, 4), (1, 203, 32, 8), (3, 130, 48, 16),
             (1, 300, 16, 100), (1, 700, 16, 600), (2, 150, 37, 5),
             (1, 75, 1024, 8), (2, 60, 1, 3), (3, 50, 20, 3)]


@pytest.mark.parametrize("b,t,p,m", PFB_CASES)
@pytest.mark.parametrize("tile", pfbk.TILES)
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_pfb_fused_matches_plain(dev, b, t, p, m, tile, aligned):
    gen = torch.Generator(device=dev).manual_seed(b * t + p * m)
    buf = torch.randn(b * t * p + 1, device=dev, generator=gen)
    # frames that do not start 16-byte aligned take the scalar loads
    x = (buf[:-1] if aligned else buf[1:]).view(b, t, p)
    taps = torch.randn(m, p, device=dev, generator=gen)
    fr, fi = ops._fourier(p, str(dev))
    bt, bn = tile
    want = pfbk.pfb_fused_plain(x, taps, fr, fi)
    w = torch.view_as_real(want)
    for hermitian in (False, True):   # every column, or half and conjugates
        got = pfbk.pfb_fused(x, taps, fr, fi, hermitian=hermitian, bt=bt,
                             bn=bn)
        torch.cuda.synchronize()
        # fp32 sums of P terms taken in another order
        assert (torch.view_as_real(got) - w).abs().max() \
            <= 1e-4 * w.abs().max()
    # the frontend's y rows as the DFT stage reads them, zero pad columns
    # written over NaN, and the frontend alone, bit for bit as their twins
    y = torch.full((b * (t - m + 1), pfbk.y_stride(p)), float("nan"),
                   device=dev)
    pfbk.pfb_frontend(x, taps, out=y)
    torch.cuda.synchronize()
    assert torch.equal(y, pfbk.pfb_frontend_rows_plain(x, taps))
    assert torch.equal(pfbk.pfb_frontend(x, taps),
                       pfbk.pfb_frontend_plain(x, taps))


@pytest.mark.parametrize("n", [1, 2, 7, 16, 64, 1024])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_dft_hermitian_matches_every_column(dev, n, inverse):
    """A real x at 4mult against a DFM: half the columns computed and the
    rest written as their conjugates, at every tile, within the kernel's
    tolerance of the plain version."""
    x = torch.randn(300, n, device=dev)
    fr, fi = functions._dfm_tensors(n, inverse, torch.float32, str(dev))
    want = torch.view_as_real(dftk.dft_plain(x, fr, fi, "4mult"))
    for bm, bn in dftk.TILES:
        got = dftk.dft(x, fr, fi, variant="4mult", bm=bm, bn=bn,
                       hermitian=True)
        torch.cuda.synchronize()
        assert (torch.view_as_real(got) - want).abs().max() \
            <= 1e-4 * want.abs().max()
    with pytest.raises(ValueError, match="hermitian"):
        dftk.dft(x.to(torch.complex64), fr, fi, variant="4mult",
                 hermitian=True)


def test_pfb_fused_fp64_accuracy_and_planes(dev):
    """At P = 1024 the 3xTF32 DFT stage is within 1e-5 of max of a
    float64 product of the same y (one TF32 pass would be near 1e-3), and
    the planes made once give the numbers of the planes made per call."""
    b, t, p, m = 2, 300, 1024, 8
    x = torch.randn(b, t, p, device=dev)
    taps = torch.randn(m, p, device=dev)
    fr, fi = ops._fourier(p, str(dev))
    y = pfbk.pfb_frontend(x, taps).reshape(-1, p)
    got = pfbk.pfb_fused(x, taps, fr, fi, planes=ops._fourier_planes(
        p, str(dev)), hermitian=True)
    assert torch.equal(got, pfbk.pfb_fused(x, taps, fr, fi, hermitian=True))
    want = torch.complex(y.double() @ fr.double(), y.double() @ fi.double())
    err = (torch.view_as_real(got).reshape(-1, p, 2).double()
           - torch.view_as_real(want)).abs().max()
    assert err <= 1e-5 * torch.view_as_real(want).abs().max()


@pytest.mark.parametrize("steps,abs2_head,n_ops", [
    ((), True, 0), ((("scale", 0.37),), True, 0),
    ((("mul",), ("add",), ("scale", 1.7)), False, 2)])
def test_chain_bit_exact(dev, steps, abs2_head, n_ops):
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (3, 1001, 33)
    head = torch.randn(*shape, device=dev, generator=gen,
                       dtype=torch.complex64 if abs2_head else torch.float32)
    operands = tuple(torch.randn(*shape, device=dev, generator=gen)
                     for _ in range(n_ops))
    got = ewk.elementwise_chain(head, operands, steps, abs2_head=abs2_head)
    torch.cuda.synchronize()
    want = ewk.elementwise_chain_plain(head, operands, steps,
                                       abs2_head=abs2_head)
    assert torch.equal(got, want)


def test_wrappers_reject_bad_cuda_inputs(dev):
    x = torch.randn(1, 40, 16, device=dev)
    taps = torch.randn(4, 16, device=dev)
    fr, fi = ops._fourier(16, str(dev))
    with pytest.raises(ValueError, match="contiguous"):
        pfbk.pfb_fused(torch.randn(1, 40, 32, device=dev)[..., ::2], taps,
                       fr, fi)
    with pytest.raises(TypeError, match="float32"):
        pfbk.pfb_fused(x.double(), taps, fr, fi)
    with pytest.raises(ValueError, match="on cpu"):
        pfbk.pfb_fused(x, taps.cpu(), fr, fi)
    with pytest.raises(ValueError, match="not compiled"):
        pfbk.pfb_fused(x, taps, fr, fi, bt=64, bn=64)
    with pytest.raises(ValueError, match="P-point DFM"):
        pfbk.pfb_fused(x, taps, fr[:, :8].contiguous(),
                       fi[:, :8].contiguous(), hermitian=True)
    with pytest.raises(ValueError, match="planes has shape"):
        pfbk.pfb_fused(x, taps, fr, fi, planes=torch.zeros(
            2, 64, 32, device=dev))
    with pytest.raises(ValueError, match="out has shape"):
        pfbk.pfb_frontend(x, taps, out=torch.empty(37, 20, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        pfbk.pfb_frontend(torch.randn(1, 40, 32, device=dev)[..., ::2], taps)
    with pytest.raises(TypeError, match="complex64"):
        ewk.elementwise_chain(x.double(), (), (), abs2_head=True)
    with pytest.raises(ValueError, match="contiguous"):
        firk.fir_valid(torch.randn(2, 80, device=dev)[:, ::2],
                       torch.randn(5, device=dev))
    with pytest.raises(TypeError, match="float32"):
        mmk.matmul(x[0].double(), x[0].T.double())


def test_pfb_power_plan_launches_each_kernel_once(dev):
    g = graph.build_pfb_power(32, 8)
    x = torch.randn(2, 32 * 300, device=dev)
    plan = graph.compile(g, {"x": tuple(x.shape)}, lowering="kernel")
    pfbk.LAUNCHES = ewk.LAUNCHES = 0
    out = plan(x)
    torch.cuda.synchronize()
    assert (pfbk.LAUNCHES, ewk.LAUNCHES) == (1, 1)
    ref = graph.compile(g, {"x": tuple(x.shape)}, lowering="native")(x)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("rows,n,j", [(3, 1000, 1), (3, 1000, 7),
                                      (3, 1000, 64), (2, 5000, 4096)])
def test_unfold_exact(dev, rows, n, j):
    x = torch.randn(rows, n, device=dev)
    got = ops.unfold(x, j)
    torch.cuda.synchronize()
    assert torch.equal(got, unfk.unfold_plain(x, j))


# hop % 4 == 0 takes float4 lanes, other hops (6, 5, 3) one sample a
# thread; frames that start 4 bytes past a 16-byte boundary take the
# scalar route too
OLA_CASES = [((2, 37, 64), 64), ((2, 37, 64), 32), ((2, 37, 64), 16),
             ((2, 37, 64), 8), ((2, 8, 64), 8),   # T = K exactly
             ((1, 2047, 1024), 512), ((3, 41, 30), 6), ((2, 50, 15), 5),
             ((2, 33, 12), 3)]


@pytest.mark.parametrize("shape,hop", OLA_CASES)
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_overlap_add_exact(dev, shape, hop, aligned):
    n = shape[0] * shape[1] * shape[2]
    buf = torch.randn(n + 1, device=dev)
    frames = (buf[:-1] if aligned else buf[1:]).view(shape)
    want = unfk.overlap_add_plain(frames, hop)
    for cfg in unfk.OLA_TUNE_SPACE.configs({}):
        got = ops.overlap_add(frames, hop, **cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cfg


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("row", [False, True], ids=["full", "row"])
def test_binary_exact(dev, op, row):
    x = torch.randn(3, 1001, 33, device=dev)
    y = torch.randn(33 if row else (3, 1001, 33), device=dev)
    fn = ops.elementwise_mult if op == "mul" else ops.elementwise_add
    got = fn(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, ewk.elementwise_binary_plain(x, y, op))


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("cols", [1, 3, 4, 64, 1024])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                     (1, 2, 0), (0, 0, 1)])
@pytest.mark.parametrize("row", [False, True], ids=["full", "row"])
def test_binary_exact_at_offsets(dev, op, cols, offsets, row):
    """x, y and out as views that start 0-3 floats past a 16-byte
    boundary (the same offset: a scalar head then 16-byte vectors; other
    offsets: the scalar loop), n not a multiple of 4 where cols is odd."""
    rows = 37
    n = rows * cols
    ny = cols if row else n

    def view(k, size):
        return torch.randn(size + 4, device=dev)[k:k + size]

    x = view(offsets[0], n).view(rows, cols)
    y = view(offsets[1], ny).view((cols,) if row else (rows, cols))
    out = view(offsets[2], n).view(rows, cols)
    fn = ewk.elementwise_mult if op == "mul" else ewk.elementwise_add
    got = fn(x, y, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, ewk.elementwise_binary_plain(x, y, op))


@pytest.mark.parametrize("op", ["mul", "add"])
def test_binary_column_is_no_row(dev, op):
    # y (C, 1) against x (C, C): a column, though it has C entries
    x = torch.randn(33, 33, device=dev)
    y = torch.randn(33, 1, device=dev)
    fn = ops.elementwise_mult if op == "mul" else ops.elementwise_add
    got = fn(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, ewk.elementwise_binary_plain(x, y, op))
    kernel = ewk.elementwise_mult if op == "mul" else ewk.elementwise_add
    with pytest.raises(ValueError, match="nor a row"):
        kernel(x, y)


@pytest.mark.parametrize("rows", [1, 37, 8188])
@pytest.mark.parametrize("n", [7, 64, 1024])
@pytest.mark.parametrize("variant", dftk.VARIANTS)
def test_dft_matches_plain(dev, rows, n, variant):
    for cplx in (False, True):
        x = torch.randn(rows, n, device=dev,
                        dtype=torch.complex64 if cplx else torch.float32)
        for inverse in (False, True):
            fr, fi = functions._dfm_tensors(n, inverse, torch.float32,
                                            str(dev))
            got = ops.dft(x, fr, fi, variant=variant)
            torch.cuda.synchronize()
            want = dftk.dft_plain(x, fr, fi, variant)
            g, w = torch.view_as_real(got), torch.view_as_real(want)
            # fp32 sums of n terms taken in another order
            assert (g - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.parametrize("tile", dftk.TILES)
def test_dft_every_tile(dev, tile):
    x = torch.randn(37, 100, device=dev, dtype=torch.complex64)
    fr, fi = functions._dfm_tensors(100, False, torch.float32, str(dev))
    bm, bn = tile
    for variant in dftk.VARIANTS:
        got = dftk.dft(x, fr, fi, variant=variant, bm=bm, bn=bn)
        torch.cuda.synchronize()
        want = dftk.dft_plain(x, fr, fi, variant)
        g, w = torch.view_as_real(got), torch.view_as_real(want)
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_dft_staging_and_fp64_accuracy(dev):
    """Rows that TMA cannot read (an unaligned start) go through the
    padded copy and give the same numbers; at the STFT's width the 3xTF32
    product is within 1e-5 of max against a float64 product (one TF32
    pass would be near 1e-3)."""
    n = 1024
    fr, fi = functions._dfm_tensors(n, False, torch.float32, str(dev))
    planes = functions._dfm_tf32_tensors(n, False, "4mult", str(dev))
    x = torch.randn(300, n, device=dev)
    buf = torch.empty(300 * n + 1, device=dev)
    xs = buf[1:].view(300, n)
    xs.copy_(x)
    assert dftk.staging(x) == "tma" and dftk.staging(xs) == "padded_copy"
    got = dftk.dft(x, fr, fi, variant="4mult", planes=planes)
    assert torch.equal(dftk.dft(xs, fr, fi, variant="4mult", planes=planes),
                       got)
    want = torch.complex(x.double() @ fr.double(), x.double() @ fi.double())
    err = (torch.view_as_real(got).double()
           - torch.view_as_real(want)).abs().max()
    assert err <= 1e-5 * torch.view_as_real(want).abs().max()


def _counts():
    return {"unfold": unfk.LAUNCHES, "overlap_add": unfk.OLA_LAUNCHES,
            "binary": ewk.BINARY_LAUNCHES, "dft": dftk.LAUNCHES,
            "chain": ewk.LAUNCHES, "pfb": pfbk.LAUNCHES}


@pytest.mark.parametrize("name,g,shape,want", [
    ("stft_overlap_add", graph.build_stft_overlap_add(64, 32), (2, 4000),
     {"unfold": 1, "overlap_add": 1, "binary": 2, "dft": 2, "chain": 0,
      "pfb": 0}),
    ("spectrogram", graph.build_spectrogram(64), (2, 4000),
     {"unfold": 1, "overlap_add": 0, "binary": 1, "dft": 1, "chain": 1,
      "pfb": 0})], ids=["stft_overlap_add", "spectrogram"])
def test_spectral_plans_launch_their_kernels(dev, name, g, shape, want):
    x = torch.randn(*shape, device=dev)
    plan = graph.compile(g, {"x": shape}, lowering="kernel")
    for mod in (unfk, ewk, dftk, pfbk):
        mod.LAUNCHES = 0
    unfk.OLA_LAUNCHES = ewk.BINARY_LAUNCHES = 0
    out = plan(x)
    torch.cuda.synchronize()
    assert _counts() == want
    ref = graph.compile(g, {"x": shape}, lowering="native")(x)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_chain_real_abs2_head_bit_exact(dev):
    """abs2 of a real signal: the chain's real head squares it, x·x."""
    x = torch.randn(3, 1001, 33, device=dev)
    for steps in ((), (("scale", 0.37),)):
        got = ewk.elementwise_chain(x, (), steps, abs2_head=True)
        torch.cuda.synchronize()
        assert torch.equal(got, ewk.elementwise_chain_plain(
            x, (), steps, abs2_head=True))
    assert torch.equal(ops.abs2(x), x * x)


# K = 1 to K > TAP_CHUNK (4097), ragged rows and lengths; a grid of more
# tiles than resident blocks (64 rows of 49 tiles at the default 2048
# outputs), nout shorter than one tile
FIR_CASES = [(3, 1000, 1), (2, 999, 8), (5, 4099, 15), (1, 70001, 31),
             (7, 3000, 63), (2, 5003, 129), (2, 9001, 4097),
             (64, 100001, 31), (3, 50, 31)]


@pytest.mark.parametrize("rows,n,k", FIR_CASES)
def test_fir_valid_bit_exact(dev, rows, n, k):
    x = torch.randn(rows, n, device=dev)
    kern = torch.randn(k, device=dev)
    for pads in ((0, 0), (k // 2, (k - 1) // 2), (k - 1, k - 1), (3, 0)):
        for flip in (False, True):
            got = firk.fir_valid(x, kern, pad_left=pads[0],
                                 pad_right=pads[1], flip=flip)
            torch.cuda.synchronize()
            want = firk.fir_valid_plain(x, kern, pad_left=pads[0],
                                        pad_right=pads[1], flip=flip)
            assert torch.equal(got, want), (pads, flip)


FIR_TILES = [(c["bn"], c["threads"])
             for c in firk.TUNE_SPACE.configs({"k": 31})]


@pytest.mark.parametrize("tile", FIR_TILES)
def test_fir_every_tile_and_strided_rows(dev, tile):
    bn, threads = tile
    x = torch.randn(6, 5001, device=dev)[::2]          # strided rows
    kern = torch.randn(31, device=dev)
    got = ops.fir(x, kern, pad_left=15, pad_right=15, flip=True, bn=bn,
                  threads=threads)
    torch.cuda.synchronize()
    want = firk.fir_valid_plain(x.contiguous(), kern, pad_left=15,
                                pad_right=15, flip=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tile", FIR_TILES)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_fir_rows_not_16_byte_aligned(dev, tile, offset):
    # x starts 1-3 floats past a 16-byte boundary (and rows of 3001
    # samples shift it row by row): every lead a = 0-3 of the staged spans
    bn, threads = tile
    buf = torch.randn(5 * 3001 + 4, device=dev)
    x = buf[offset:offset + 5 * 3001].view(5, 3001)
    kern = torch.randn(31, device=dev)
    got = firk.fir_valid(x, kern, pad_left=15, pad_right=15, flip=True,
                         bn=bn, threads=threads)
    torch.cuda.synchronize()
    assert torch.equal(got, firk.fir_valid_plain(x, kern, pad_left=15,
                                                 pad_right=15, flip=True))


@pytest.mark.parametrize("mode", ["valid", "same", "full"])
@pytest.mark.parametrize("k", [8, 9])
@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
def test_fir_function_kernel_matches_native(dev, mode, k, flip):
    x = torch.randn(3, 2001, device=dev)
    taps = torch.randn(k, device=dev)
    firk.LAUNCHES = 0
    got = functions.fir(x, taps, mode=mode, flip=flip, lowering="kernel")
    torch.cuda.synchronize()
    assert firk.LAUNCHES == 1
    want = functions.fir(x, taps, mode=mode, flip=flip, lowering="native")
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


MM_CASES = [((1, 1), (1, 1)), ((257, 255), (255, 129)),
            ((300, 50), (50, 100)), ((3, 5, 40, 24), (24, 17)),
            ((1024, 512), (512, 768))]


@pytest.mark.parametrize("xs,ys", MM_CASES)
@pytest.mark.parametrize("tile", mmk.TILES)
@pytest.mark.parametrize("order", mmk.ORDERS)
def test_matmul_matches_plain(dev, xs, ys, tile, order):
    x = torch.randn(*xs, device=dev)
    y = torch.randn(*ys, device=dev)
    bm, bn, bk = tile
    got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)
    torch.cuda.synchronize()
    want = mmk.matmul_plain(x.reshape(-1, xs[-1]), y).reshape(got.shape)
    # fp32 sums of K terms taken in another order
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    # 3xTF32 with per-chunk promotion: within 1e-5 of a float64 product
    w64 = x.reshape(-1, xs[-1]).double() @ y.double()
    assert ((got.reshape(w64.shape).double() - w64).abs().max()
            <= 1e-5 * w64.abs().max())


# the staging edges of the 3xTF32 GEMM: K not a multiple of 4 (the padded
# copy), an odd N (scalar stores), K a multiple of 4 (TMA)
@pytest.mark.parametrize("m,k,n", [(130, 1027, 193), (70, 3, 33),
                                   (300, 100, 51)])
def test_matmul_staging_edges_and_planes(dev, m, k, n):
    x = torch.randn(m, k, device=dev)
    y = torch.randn(k, n, device=dev)
    planes = mmk.tf32_planes(y)
    torch.cuda.synchronize()
    # the split pass equals its plain twin bit for bit
    assert torch.equal(planes, mmk.tf32_planes_plain(y))
    want = mmk.matmul_plain(x, y)
    for bm, bn, bk in mmk.TILES:
        got = mmk.matmul(x, y, yt_planes=planes, bm=bm, bn=bn, bk=bk)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        # planes made per call give the same bits
        assert torch.equal(mmk.matmul(x, y, bm=bm, bn=bn, bk=bk), got)
    # rows that start unaligned take the padded copy, with the same bits
    buf = torch.empty(m * k + 1, device=dev)
    xs = buf[1:].view(m, k)
    xs.copy_(x)
    assert mmk.staging(xs) == "padded_copy"
    assert torch.equal(mmk.matmul(xs, y, yt_planes=planes),
                       mmk.matmul(x, y, yt_planes=planes))


def test_matmul_plan_makes_the_planes_once(dev):
    w = torch.randn(256, 192).numpy()
    g = graph.Graph("mm")
    node = g.apply("matmul", g.input("x"), g.const(w, "y"))
    g.output(node)
    plan = graph.compile(g, {"x": (64, 256)}, lowering="kernel")
    x = torch.randn(64, 256, device=dev)
    mmk.LAUNCHES = mmk.PLANES_LAUNCHES = 0
    first = plan(x)
    torch.cuda.synchronize()
    assert (mmk.LAUNCHES, mmk.PLANES_LAUNCHES) == (1, 1)
    planes = plan.kconsts[node][0]
    assert torch.equal(planes, mmk.tf32_planes_plain(plan.consts["y"]))
    assert torch.equal(plan(x), first)
    assert (mmk.LAUNCHES, mmk.PLANES_LAUNCHES) == (2, 1)
    assert plan.kconsts[node][0] is planes


@pytest.mark.parametrize("name,g,shape,want", [
    ("fir_decimate", graph.build_fir_decimate(), (2, 5000),
     {"fir": 2, "chain": 0, "pfb": 0}),
    ("correlate", graph.build_correlate(), (2, 5000),
     {"fir": 1, "chain": 1, "pfb": 0}),
    ("cascaded_channelizer", graph.build_cascaded_channelizer(),
     (2, graph.pipelines._chan_len(5000, 31, 16, 4)),
     {"fir": 1, "chain": 1, "pfb": 1})],
    ids=["fir_decimate", "correlate", "cascaded_channelizer"])
def test_fir_plans_launch_their_kernels(dev, name, g, shape, want):
    x = torch.randn(*shape, device=dev)
    plan = graph.compile(g, {"x": shape}, lowering="kernel")
    assert plan.downgrades == {}
    firk.LAUNCHES = ewk.LAUNCHES = pfbk.LAUNCHES = 0
    out = plan(x)
    torch.cuda.synchronize()
    assert {"fir": firk.LAUNCHES, "chain": ewk.LAUNCHES,
            "pfb": pfbk.LAUNCHES} == want
    ref = graph.compile(g, {"x": shape}, lowering="native")(x)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


# ---------------------------------------------------------------------------
# the int8 tier: each int8 kernel bit for bit against its plain version
# ---------------------------------------------------------------------------
def half_integer_signal(shape, period, seed):
    """f32 samples every window of ``period`` along dim -2 (a 2-D row:
    dim -1) of which holds one ±a, so its scale is s = 9/1024, and whose
    other samples are exact half-integer multiples of s: each x / s of
    them is exactly k + 0.5, the case round-half-to-even decides."""
    a, s = np.float32(1.1162109375), np.float32(9 / 1024)
    assert np.float32(a * (np.float32(1) / np.float32(127))) == s
    rng = np.random.default_rng(seed)
    x = ((rng.integers(-100, 100, shape) + 0.5) * s).astype(np.float32)
    signs = np.where(rng.random(shape) < 0.5, -a, a).astype(np.float32)
    idx = [slice(None)] * len(shape)
    idx[-1 if len(shape) == 2 else -2] = slice(None, None, period)
    x[tuple(idx)] = signs[tuple(idx)]
    q = x[np.abs(x) != a] / s
    assert np.all(q - np.floor(q) == np.float32(0.5))
    return x


def _int8_args(dev, m, k, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xq, sx = quantize.quantize_symmetric(
        torch.randn(m, k, device=dev, generator=gen), axis=-1)
    wq, ws = quantize.quantize_weights(
        torch.randn(k, n, device=dev, generator=gen))
    return xq, wq, sx.reshape(-1), ws.reshape(-1)


# M, N, K not tile multiples, K not a multiple of 4, K below 4
MM_INT8_CASES = [(1, 1, 1), (257, 129, 255), (300, 100, 50), (70, 3, 33),
                 (130, 4097, 67)]


@pytest.mark.parametrize("m,k,n", MM_INT8_CASES)
@pytest.mark.parametrize("tile", mmk.TILES_INT8)
def test_matmul_int8_bit_exact(dev, m, k, n, tile):
    xq, wq, sx, ws = _int8_args(dev, m, k, n, m + k + n)
    bm, bn, bk = tile
    got = mmk.matmul_int8(xq, wq, sx, ws, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    want = mmk.matmul_int8_plain(xq, wq, sx, ws)
    assert torch.equal(got, want)
    # the K-major copy made once by the caller gives the same bits
    assert torch.equal(mmk.matmul_int8(xq, wq, sx, ws, yt=wq.t().contiguous(),
                                       bm=bm, bn=bn, bk=bk), want)


def test_matmul_int8_unaligned_rows_and_headroom(dev):
    # a contiguous x whose rows do not start 4-byte aligned: byte loads
    m, k, n = 64, 2048, 96
    xq, wq, sx, ws = _int8_args(dev, m, k, n, 5)
    buf = torch.empty(m * k + 1, dtype=torch.int8, device=dev)
    xs = buf[1:].view(m, k)
    xs.copy_(xq)
    assert xs.is_contiguous() and xs.data_ptr() % 4 == 1
    for bm, bn, bk in mmk.TILES_INT8:
        got = mmk.matmul_int8(xs, wq, sx, ws, bm=bm, bn=bn, bk=bk)
        assert torch.equal(got, mmk.matmul_int8_plain(xq, wq, sx, ws))
    # tests/test_kernels.py:136-160 at K = 2048: every product ±127², the
    # plain version is an int64 sum rescaled in f32
    gen = torch.Generator(device=dev).manual_seed(6)
    sat = torch.where(torch.rand(512, k, device=dev, generator=gen) < 0.5,
                      -127, 127).to(torch.int8)
    wsat = torch.where(torch.rand(k, 512, device=dev, generator=gen) < 0.5,
                       -127, 127).to(torch.int8)
    one = torch.ones(512, device=dev)
    want = (sat.cpu().long() @ wsat.cpu().long()).float()
    for bm, bn, bk in mmk.TILES_INT8:
        got = mmk.matmul_int8(sat, wsat, one, one, bm=bm, bn=bn, bk=bk)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("rows", [1, 37, 8188])
@pytest.mark.parametrize("n", [7, 64, 1024])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("tile", dftk.TILES_INT8)
def test_dft_int8_bit_exact(dev, rows, n, inverse, tile):
    gen = torch.Generator(device=dev).manual_seed(rows * n)
    xq, sx = quantize.quantize_symmetric(
        torch.randn(rows, n, device=dev, generator=gen), axis=-1)
    qr, sr, qi, si = quantize._qdfm_tensors(n, inverse, str(dev))
    qrt, qit = quantize._qdfm_kmajor(n, inverse, str(dev))
    bm, bn, bk = tile
    want = dftk.dft_int8_plain(xq, qr, qi, sx.reshape(-1), sr, si)
    got = dftk.dft_int8(xq, qr, qi, sx.reshape(-1), sr, si, bm=bm, bn=bn,
                        bk=bk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the K-major planes made once (as ops.qdft passes them): same bits
    assert torch.equal(dftk.dft_int8(xq, qr, qi, sx.reshape(-1), sr, si,
                                     frt=qrt, fit=qit, bm=bm, bn=bn, bk=bk),
                       want)


# the staging edges of the s8 DFT off the square DFM: an odd N at L a
# multiple of 16, L not a multiple of 16 (the padded copy), both
@pytest.mark.parametrize("l,n", [(64, 33), (100, 64), (1000, 257)])
@pytest.mark.parametrize("tile", dftk.TILES_INT8)
def test_dft_int8_staging_edges(dev, l, n, tile):
    gen = torch.Generator(device=dev).manual_seed(l * n)
    xq, sx = quantize.quantize_symmetric(
        torch.randn(300, l, device=dev, generator=gen), axis=-1)
    fr, sr = quantize.quantize_weights(torch.randn(l, n, device=dev,
                                                   generator=gen))
    fi, si = quantize.quantize_weights(torch.randn(l, n, device=dev,
                                                   generator=gen))
    args = (xq, fr, fi, sx.reshape(-1), sr.reshape(-1), si.reshape(-1))
    bm, bn, bk = tile
    want = dftk.dft_int8_plain(*args)
    assert torch.equal(dftk.dft_int8(*args, bm=bm, bn=bn, bk=bk), want)
    buf = torch.empty(300 * l + 1, dtype=torch.int8, device=dev)
    xs = buf[1:].view(300, l)
    xs.copy_(xq)
    assert mmk.int8_staging(xs, fr.t()) == "padded_copy"
    assert torch.equal(dftk.dft_int8(xs, *args[1:], bm=bm, bn=bn, bk=bk),
                       want)


FIR_INT8_CASES = [(3, 1000, 1), (2, 999, 8), (5, 4099, 15), (1, 70001, 31),
                  (7, 3000, 63), (2, 5003, 129), (2, 9001, 4097)]


@pytest.mark.parametrize("rows,n,k", FIR_INT8_CASES)
def test_fir_valid_int8_bit_exact(dev, rows, n, k):
    gen = torch.Generator(device=dev).manual_seed(rows * n + k)
    x = torch.randn(rows, n, device=dev, generator=gen)
    for flip in (True, False):
        tq, ts = quantize.quantize_fir_taps(
            torch.randn(k, device=dev, generator=gen), flip=flip)
        tq, ts = tq.reshape(-1), ts.reshape(1)
        got = firk.fir_valid_int8(x, tq, ts)
        torch.cuda.synchronize()
        assert torch.equal(got, firk.fir_valid_int8_plain(x, tq, ts))


def test_fir_valid_int8_every_tile_and_half_integers(dev):
    k = 31
    x = torch.as_tensor(half_integer_signal((3, 5000), k, 9), device=dev)
    tq, ts = quantize.quantize_fir_taps(torch.randn(k, device=dev))
    tq, ts = tq.reshape(-1), ts.reshape(1)
    want = firk.fir_valid_int8_plain(x, tq, ts)
    for cfg in firk.TUNE_SPACE_INT8.configs({"k": k}):
        assert torch.equal(firk.fir_valid_int8(x, tq, ts, **cfg), want), cfg
    # the same numbers as the CPU's plain version
    assert torch.equal(want.cpu(), firk.fir_valid_int8_plain(
        x.cpu(), tq.cpu(), ts.cpu()))


def test_quantize_rcp_equals_the_division_on_every_float(dev):
    """csrc/int8.cuh's quantize against the division it replaces, on
    every float x in [-amax, amax] (csrc/qcheck.cu): amax under the 1e-12
    clamp, 1, 127 2^-20 and one ulp either side (chip_smoke.py runs some
    320 scales)."""
    f32 = np.float32
    amax = [f32(0), f32(5e-13), f32(1), f32(127 * 2.0 ** -20)]
    amax += [np.nextafter(a, d) for a in amax[2:] for d in (f32(0), f32(2))]
    a = torch.as_tensor(np.array(amax, dtype=np.float32), device=dev)
    assert firk.quantize_check(a).tolist() == [0] * len(amax)
    assert firk.quantize_check_pairs(a) > 4 * 2 ** 30


# P not a multiple of 16 (20, 48, 1000: the padded yq stride) and of 4
# (the scalar frontend loads), ragged frame counts, M from 3 to 16
PFB_INT8_CASES = [(2, 301, 16, 4), (1, 203, 48, 8), (3, 130, 16, 16),
                  (1, 75, 1024, 8), (2, 40, 20, 3), (1, 60, 1000, 8),
                  (2, 50, 37, 5)]


@pytest.mark.parametrize("b,t,p,m", PFB_INT8_CASES)
@pytest.mark.parametrize("tile", pfbk.TILES_INT8)
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
def test_pfb_fused_int8_bit_exact(dev, b, t, p, m, tile, aligned):
    gen = torch.Generator(device=dev).manual_seed(b * t + p * m)
    frames = torch.randn(b * t * p + 1, device=dev, generator=gen)
    # rows that do not start 16-byte aligned take the scalar loads
    frames = (frames[:-1] if aligned else frames[1:]).view(b, t, p)
    tq, ts = quantize.quantize_pfb_taps(
        torch.randn(m, p, device=dev, generator=gen))
    qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(dev))
    qrt, qit = quantize._qdfm_kmajor(p, False, str(dev))
    args = (frames, tq, ts.reshape(-1), qr, qi, sr, si)
    bt, bn = tile
    rows = b * (t - m + 1)
    yq = torch.full((rows, pfbk.padded_width(p)), 99, dtype=torch.int8,
                    device=dev)
    ys = torch.empty(rows, device=dev)
    got = pfbk.pfb_fused_int8(*args, frt=qrt, fit=qit, bt=bt, bn=bn,
                              scratch=(yq, ys))
    torch.cuda.synchronize()
    assert torch.equal(got, pfbk.pfb_fused_int8_plain(*args))
    # the frontend's rows and scales, pad bytes included, as its twin's
    wq, ws = pfbk.pfb_frontend_int8_plain(frames, tq, ts.reshape(-1))
    assert torch.equal(yq, wq) and torch.equal(ys, ws)


def test_pfb_fused_int8_half_integers(dev):
    p, m = 48, 8
    frames = torch.as_tensor(half_integer_signal((2, 90, p), m, 10),
                             device=dev)
    tq, ts = quantize.quantize_pfb_taps(
        torch.as_tensor(pfb_window_f32(p, m), device=dev))
    qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(dev))
    args = (frames, tq, ts.reshape(-1), qr, qi, sr, si)
    want = pfbk.pfb_fused_int8_plain(*args)
    for bt, bn in pfbk.TILES_INT8:
        assert torch.equal(pfbk.pfb_fused_int8(*args, bt=bt, bn=bn), want)
    assert torch.equal(want.cpu(), pfbk.pfb_fused_int8_plain(
        *(a.cpu() for a in args)))


def pfb_window_f32(p, m):
    from repro_torch.core.pfb import pfb_window
    return pfb_window(p, m).astype(np.float32)


def test_qprep_packs_on_the_card_equal_the_cpu_packs(dev):
    for name, n in (("pfb_power", 16 * 300), ("fir_decimate", 5000),
                    ("cascaded_channelizer",
                     graph.pipelines._chan_len(5000, 31, 16, 4))):
        g = getattr(graph, f"build_{name}")()
        shape = (2, n)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            on_card = graph.compile(g, {"x": shape}, precision="int8",
                                    lowering="kernel")
            on_cpu = graph.compile(g, {"x": shape}, precision="int8",
                                   lowering="kernel", device="cpu")
        assert sorted(on_card.qconsts) == sorted(on_cpu.qconsts) != []
        for node, pack in on_card.qconsts.items():
            for got, want in zip(pack, on_cpu.qconsts[node]):
                assert got.device.type == "cuda"
                assert torch.equal(got.cpu(), want)


def _int8_counts():
    return {"matmul_int8": mmk.INT8_LAUNCHES, "dft_int8": dftk.INT8_LAUNCHES,
            "fir_valid_int8": firk.INT8_LAUNCHES,
            "pfb_fused_int8": pfbk.INT8_LAUNCHES, "chain": ewk.LAUNCHES,
            "binary": ewk.BINARY_LAUNCHES, "unfold": unfk.LAUNCHES,
            "overlap_add": unfk.OLA_LAUNCHES, "fir_valid": firk.LAUNCHES,
            "pfb_fused": pfbk.LAUNCHES, "dft": dftk.LAUNCHES,
            "matmul": mmk.LAUNCHES, "tf32_planes": mmk.PLANES_LAUNCHES}


@pytest.mark.parametrize("name,g,shape,want", [
    ("pfb_power", graph.build_pfb_power(32, 8), (2, 32 * 300),
     {"pfb_fused_int8": 1, "chain": 1}),
    ("spectrogram", graph.build_spectrogram(), (2, 3000),
     {"unfold": 1, "binary": 1, "dft_int8": 1, "chain": 1}),
    ("stft_overlap_add", graph.build_stft_overlap_add(64, 32), (2, 4000),
     {"unfold": 1, "binary": 2, "dft_int8": 1, "matmul_int8": 4,
      "overlap_add": 1}),
    ("fir_decimate", graph.build_fir_decimate(), (2, 5000),
     {"fir_valid_int8": 2}),
    ("correlate", graph.build_correlate(), (2, 5000),
     {"fir_valid_int8": 1, "chain": 1}),
    ("cascaded_channelizer", graph.build_cascaded_channelizer(),
     (2, graph.pipelines._chan_len(5000, 31, 16, 4)),
     {"fir_valid_int8": 1, "pfb_fused_int8": 1, "chain": 1})],
    ids=["pfb_power", "spectrogram", "stft_overlap_add", "fir_decimate",
         "correlate", "cascaded_channelizer"])
def test_int8_plans_launch_their_kernels(dev, name, g, shape, want):
    x = torch.randn(*shape, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = graph.compile(g, {"x": shape}, precision="int8",
                             lowering="kernel")
        native = graph.compile(g, {"x": shape}, precision="int8")
    before = _int8_counts()
    out = plan(x)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _int8_counts().items()}
    assert grew == {k: want.get(k, 0) for k in grew}
    # the kernel plan equals the torch integer plan bit for bit
    assert torch.equal(out, native(x))


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    p = 57_345          # one past the frontend's widest P
    frames = torch.randn(1, 20, p, device=dev)
    tq = torch.zeros(4, p, dtype=torch.int8, device=dev)
    ts = torch.ones(p, device=dev)
    qr = torch.zeros(p, 8, dtype=torch.int8, device=dev)
    s8 = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="does not fit"):   # P too wide
        pfbk.pfb_fused_int8(frames, tq, ts, qr, qr, s8, s8)
    with pytest.raises(ValueError, match="does not fit"):   # no such tile
        pfbk.pfb_fused_int8(frames[..., :64].contiguous(),
                            tq[:, :64].contiguous(),
                            ts[:64], qr[:64], qr[:64], s8, s8, bt=16)
    with pytest.raises(ValueError, match="contiguous"):
        pfbk.pfb_fused_int8(frames[..., ::2], tq[:, ::2], ts[::2],
                            qr[::2], qr[::2], s8, s8)
    with pytest.raises(ValueError, match="does not fit"):   # K too long
        firk.fir_valid_int8(torch.randn(1, 70000, device=dev),
                            torch.zeros(60000, dtype=torch.int8, device=dev),
                            torch.ones(1, device=dev))
    with pytest.raises(TypeError, match="int8"):
        mmk.matmul_int8(torch.zeros(4, 8, device=dev),
                        torch.zeros(8, 4, dtype=torch.int8, device=dev),
                        torch.ones(4, device=dev), torch.ones(4, device=dev))
    with pytest.raises(ValueError, match="outside"):
        mmk.matmul_int8(torch.zeros(4, 0, dtype=torch.int8, device=dev),
                        torch.zeros(0, 4, dtype=torch.int8, device=dev),
                        torch.ones(4, device=dev), torch.ones(4, device=dev))
    with pytest.raises(ValueError, match="not compiled"):
        dftk.dft_int8(torch.zeros(4, 8, dtype=torch.int8, device=dev),
                      *(torch.zeros(8, 8, dtype=torch.int8, device=dev),) * 2,
                      *(torch.ones(n, device=dev) for n in (4, 8, 8)),
                      bm=128, bn=96)


# ---------------------------------------------------------------------------
# serving on the card: the service's stream, staging buffers and events
# ---------------------------------------------------------------------------
def _serve_counts() -> dict:
    return {"pfb_fused": pfbk.LAUNCHES, "pfb_fused_int8": pfbk.INT8_LAUNCHES,
            "chain": ewk.LAUNCHES, "binary": ewk.BINARY_LAUNCHES,
            "dft": dftk.LAUNCHES, "unfold": unfk.LAUNCHES}


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap",
                                                        "blocking"])
def test_service_kernel_plans_on_the_card(dev, overlap):
    """An overlapped (and a blocking) continuous service at the kernel
    lowering: every future resolves, on the host; replay is bit for bit;
    each batch launches its plan's kernels once; nothing degrades; a
    result taken at delivery is unchanged by every later batch."""
    from repro_torch.graph.service import PipelineService, replay_batches
    g = graph.build_pfb_power(32, 8)
    n = 32 * 300
    svc = PipelineService(g, n, batch_size=4, batching="continuous",
                          lowering="kernel", overlap=overlap,
                          record_batches=True)
    # the bucket plans are the offline plans' cache entries
    assert svc.plan is graph.compile(g, {"x": (4, n)}, lowering="kernel")
    assert svc.plan.device.type == "cuda" and svc.stream() is not None
    assert svc.stream() != torch.cuda.current_stream(dev)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(19)]
    before = _serve_counts()
    with svc:
        first = svc.submit(xs[0]).result(timeout=120)
        kept = first.copy()
        outs = [f.result(timeout=120) for f in
                [svc.submit(x, priority="rt" if i % 2 else "batch")
                 for i, x in enumerate(xs[1:])]]
    grew = {k: v - before[k] for k, v in _serve_counts().items()}
    batches = svc.stats()["batches"]
    assert grew == {"pfb_fused": batches, "pfb_fused_int8": 0,
                    "chain": batches, "binary": 0, "dft": 0, "unfold": 0}
    assert isinstance(first, np.ndarray)
    np.testing.assert_array_equal(first, kept)
    oracle = graph.pfb_power_oracle(32, 8)
    for x, o in zip(xs, [first, *outs]):
        want = oracle(x)
        assert np.abs(o - want).max() <= 2e-3 * np.abs(want).max()
    assert replay_batches(svc) == len(xs)
    s = svc.stats()
    assert s["degraded"] == s["quarantined"] == 0 and svc.downgrades == {}
    assert s["card_ms"]["plan"]["count"] == batches
    # each bucket reuses its page-locked output buffers
    assert all(1 <= len(v) <= 2 for v in svc._default._free_outs.values())


def test_plan_shared_between_streams_gives_equal_bits(dev):
    """One cached plan, at f32 and at int8, called first on the service's
    stream and then on the default stream, and the reverse, gives the
    same bits on both: its consts and packs, the DFM's TF32 planes and
    the int8 K-major DFM are made on whichever stream calls first and
    read from the other."""
    from repro_torch.graph.service import PipelineService
    rng = np.random.default_rng(8)
    n = 4096
    for prec in ("f32", "int8"):
        for service_first in (True, False):
            graph.clear_cache()
            functions._dfm_tf32_tensors.cache_clear()
            quantize._qdfm_kmajor.cache_clear()
            g = graph.build_spectrogram(64)
            x2 = np.stack([rng.standard_normal(n).astype(np.float32)
                           for _ in range(2)])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                if not service_first:     # first call: the default stream
                    plan = graph.compile(g, {"x": (2, n)},
                                         lowering="kernel", precision=prec)
                    offline = plan(torch.from_numpy(x2).to(dev)).cpu()
                svc = PipelineService(g, n, batch_size=2, lowering="kernel",
                                      precision=prec, batching="continuous")
            if not service_first:
                assert svc.plans[2] is plan
            futs = [svc.submit(x) for x in x2]
            svc.flush()
            served = np.stack([f.result(timeout=120) for f in futs])
            if service_first:             # then the default stream
                offline = svc.plans[2](torch.from_numpy(x2).to(dev)).cpu()
            assert np.array_equal(offline.numpy(), served), \
                (prec, service_first)
            svc.close()


def test_service_degrades_on_the_card(dev):
    """On the card a failing f32 kernel bucket never gives way to the
    plain version: the batch's future gets the error and nothing is
    recompiled.  A failing int8 kernel bucket degrades to the f32 kernel
    plan, on the card, and still launches the hand-written kernel."""
    from repro_torch.graph.service import PipelineService, replay_batches
    from repro_torch.obs import faults
    g = graph.build_pfb_power(32, 8)
    n = 32 * 200
    rng = np.random.default_rng(9)
    x = rng.standard_normal(n).astype(np.float32)
    faults.configure("device_run@kernel:always", seed=0)
    try:
        svc = PipelineService(g, n, batch_size=1, lowering="kernel",
                              max_retries=0, degrade_after=1,
                              record_batches=True)
        kernel_plan = svc.plans[1]
        f = svc.submit(x)
        with warnings.catch_warnings():
            warnings.simplefilter("error")    # no degrade warning
            svc.flush()
    finally:
        faults.reset()
    assert isinstance(f.exception(timeout=0), faults.InjectedFault)
    assert svc.downgrades == {} and svc.stats()["degraded"] == 0
    assert svc.plans[1] is kernel_plan
    svc.close()
    # int8: one failure, then the f32 kernel plan serves
    f32_plan = graph.compile(g, {"x": (1, n)}, lowering="kernel")
    want = f32_plan(torch.from_numpy(x[None]).to(dev)).cpu().numpy()[0]
    faults.configure("device_run@kernel:once", seed=0)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            svc = PipelineService(g, n, batch_size=1, lowering="kernel",
                                  precision="int8", max_retries=0,
                                  degrade_after=1, record_batches=True)
        f = svc.submit(x)
        before = pfbk.LAUNCHES
        with pytest.warns(UserWarning, match="f32 at its own lowering"):
            svc.flush()
    finally:
        faults.reset()
    assert svc.downgrades == {1: "precision:int8"}
    assert svc.plans[1] is f32_plan and pfbk.LAUNCHES == before + 1
    np.testing.assert_array_equal(f.result(timeout=60), want)
    assert replay_batches(svc) == 1
    svc.close()


# ---------------------------------------------------------------------------
# the bf16 GEMM (csrc/bf16_gemm.cu) and the model zoo's kernel lowering
# ---------------------------------------------------------------------------
# ragged M, N and K (K not a multiple of the 64-deep chunk; 77 and 3 not
# of 8: the padded copy), the decode and prefill shapes of olmo_1b's
# layers, and leading dims through ops.matmul
BF16_CASES = [((1, 72), (72, 5)), ((33, 200), (200, 300)), ((7, 77), (77, 9)),
              ((130, 3), (3, 257)), ((8, 2048), (2048, 8192)),
              ((512, 8192), (8192, 2048)), ((3, 5, 40, 24), (24, 17))]


@pytest.mark.parametrize("xs,ys", BF16_CASES)
def test_matmul_bf16_matches_plain(dev, xs, ys):
    gen = torch.Generator(device=dev).manual_seed(xs[-1] * ys[-1])
    x = torch.randn(*xs, device=dev, generator=gen).bfloat16()
    y = (torch.randn(*ys, device=dev, generator=gen)
         * ys[0] ** -0.5).bfloat16()
    before = mmk.BF16_LAUNCHES
    got = ops.matmul(x, y)
    torch.cuda.synchronize()
    assert mmk.BF16_LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    x2 = x.reshape(-1, xs[-1])
    want = mmk.matmul_bf16_plain(x2, y).reshape(got.shape)
    # one bf16 ulp: f32 sums of the same exact products in another order
    assert mmk.bf16_ulps(got, want).max().item() <= 1.0
    # y's K-major copy made once gives the same bits
    yt = y.t().contiguous()
    assert torch.equal(mmk.matmul(x2, y, yt=yt).reshape(got.shape), got)


def test_matmul_bf16_unaligned_rows_take_the_padded_copy(dev):
    x = torch.randn(37, 256, device=dev).bfloat16()
    y = torch.randn(256, 96, device=dev).bfloat16()
    buf = torch.empty(37 * 256 + 1, device=dev, dtype=torch.bfloat16)
    xs = buf[1:].view(37, 256)
    xs.copy_(x)
    assert torch.equal(mmk.matmul(xs, y), mmk.matmul(x, y))


def test_matmul_bf16_refuses_misfits(dev):
    x = torch.randn(8, 64, device=dev).bfloat16()
    y = torch.randn(64, 32, device=dev).bfloat16()
    with pytest.raises(TypeError, match="float32"):
        mmk.matmul(x.half(), y.half())
    with pytest.raises(TypeError, match="float32"):
        mmk.matmul(x, y.float())
    with pytest.raises(ValueError, match="has shape"):
        mmk.matmul(x, y, yt=y.contiguous())
    with pytest.raises(TypeError, match="bfloat16"):
        mmk.matmul(x, y, yt=y.t().contiguous().float())
    with pytest.raises(ValueError, match="contiguous"):
        mmk.matmul(torch.randn(8, 128, device=dev).bfloat16()[:, ::2], y)
    with pytest.raises(ValueError, match="invalid block config"):
        mmk.matmul(x, y, bk=32)
    with pytest.raises(ValueError, match="invalid block config"):
        mmk.matmul(x, y, order="nm")


# both routes at their boundary M (the skinny kernel up to 64 rows, the
# tiled one above), N and K off every tile and split multiple: K = 999
# takes the padded copy, N = 77 and 300 the tiled kernel's plain stores,
# N = 520 its TMA stores
BF16_EDGE_M = [1, 8, 63, 64, 65, 129]
BF16_EDGE_KN = [(1000, 300), (4104, 520), (999, 77)]


@pytest.mark.parametrize("k,n", BF16_EDGE_KN)
@pytest.mark.parametrize("m", BF16_EDGE_M)
def test_matmul_bf16_routes_at_their_edges(dev, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m * k + n)
    x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    y = (torch.randn(k, n, device=dev, generator=gen) * k ** -0.5).bfloat16()
    before = mmk.BF16_LAUNCHES
    got = mmk.matmul(x, y)
    torch.cuda.synchronize()
    assert mmk.BF16_LAUNCHES == before + 1
    want = mmk.matmul_bf16_plain(x, y)
    assert mmk.bf16_ulps(got, want).max().item() <= 1.0
    # y's K-major copy made once gives the same bits
    assert torch.equal(mmk.matmul(x, y, yt=y.t().contiguous()), got)


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 8192), (8192, 2048),
                                 (1000, 300)])
def test_matmul_bf16_skinny_is_bitwise_repeatable(dev, k, n):
    """The split-K sums are added in rank order: the same bits on every
    call and on two streams running at once."""
    gen = torch.Generator(device=dev).manual_seed(k + n)
    x = torch.randn(8, k, device=dev, generator=gen).bfloat16()
    yt = (torch.randn(n, k, device=dev, generator=gen) * k ** -0.5).bfloat16()
    kind, route = mmk.bf16_route(8, n, k)
    assert kind == "skinny" and route["splits"] > 1
    first = mmk.matmul(x, yt.t(), yt=yt)
    again = mmk.matmul(x, yt.t(), yt=yt)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(mmk.matmul(x, yt.t(), yt=yt))
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert all(torch.equal(first, o) for o in outs)
    assert mmk.bf16_ulps(first, mmk.matmul_bf16_plain(x, yt.t())).max() \
        .item() <= 1.0


@pytest.mark.parametrize("k,n", [(2048, 2048), (1000, 300)])
def test_matmul_bf16_skinny_sums_its_splits_in_rank_order(dev, k, n):
    """The skinny kernel's result is its splits' f32 partials added in
    rank order and rounded once, bit for bit.  Each split of K holds one
    nonzero product per element (x: +-1 at the split's first column; y:
    +-1, +-3 or +-2^24), so every partial is exact and only the order of
    the adds across splits can round: another order, or a split dropped
    or counted twice, changes some bits."""
    m = 8
    kind, r = mmk.bf16_route(m, n, k)
    assert kind == "skinny" and r["splits"] > 2
    starts = [64 * r["chunks"] * i for i in range(r["splits"])]
    rng = np.random.default_rng(k + n)
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], (r["splits"], m)))
    val = torch.from_numpy(rng.choice([-2.0 ** 24, -3.0, -1.0, 1.0, 3.0,
                                       2.0 ** 24], (r["splits"], n)))
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    yt = torch.zeros(n, k, dtype=torch.bfloat16)
    for i, a in enumerate(starts):
        x[:, a] = sign[i].bfloat16()
        yt[:, a] = val[i].bfloat16()
    parts = [(sign[i][:, None] * val[i][None, :]).float()
             for i in range(r["splits"])]

    def added(order):
        total = parts[order[0]]
        for i in order[1:]:
            total = total + parts[i]
        return total.to(torch.bfloat16)

    ranks = list(range(r["splits"]))
    want = added(ranks)
    # the probe tells the orders apart
    assert not torch.equal(want, added(ranks[::-1]))
    for i in ranks:
        assert not torch.equal(want, added(ranks[:i] + ranks[i + 1:]))
        assert not torch.equal(want, added(ranks + [i]))
    got = mmk.matmul(x.to(dev), yt.t().to(dev), yt=yt.to(dev))
    assert torch.equal(got.cpu(), want)


def test_matmul_bf16_route_is_not_a_knob(dev):
    """The route is the wrapper's choice: a tile the tiled kernel has not
    compiled raises at every M, and the C entry point refuses splits that
    leave one empty or miss part of K."""
    from repro_torch.kernels import _build
    y = torch.randn(256, 64, device=dev).bfloat16()
    for m in (8, 256):
        x = torch.randn(m, 256, device=dev).bfloat16()
        with pytest.raises(ValueError, match="invalid block config"):
            mmk.matmul(x, y, bn=128)
    x = torch.randn(8, 256, device=dev).bfloat16()
    yt = y.t().contiguous()
    out = torch.empty(8, 64, device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for splits, chunks in ((4, 1), (3, 2), (1, 3), (9, 1)):  # K: 4 chunks
        code = _build.lib().tina_matmul_bf16(
            x.data_ptr(), yt.data_ptr(), out.data_ptr(), 8, 64, 256, 0, 8,
            splits, chunks, stream)
        assert (code == 0) == ((splits, chunks) == (4, 1))
    # the tiled kernel is compiled at one tile and promotion interval
    x = torch.randn(256, 256, device=dev).bfloat16()
    out = torch.empty(256, 64, device=dev, dtype=torch.bfloat16)
    for width, interval in ((192, 3), (256, 0), (192, 0), (128, 3)):
        code = _build.lib().tina_matmul_bf16(
            x.data_ptr(), yt.data_ptr(), out.data_ptr(), 256, 64, 256, 1,
            width, interval, 0, stream)
        assert (code == 0) == ((width, interval) == (192, 3))


def test_lm_kernel_lowering_on_the_card(dev):
    """The reduced olmo at bf16 compute: every dense layer launches the
    bf16 GEMM once per call, and the logits agree with the native
    lowering (torch.matmul at bf16) within the JAX suite's decode
    tolerance, 2e-2 of max."""
    from repro_torch.configs import get_reduced
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import model as model_lib
    cfg = get_reduced("olmo_1b").scaled(compute_dtype="bfloat16",
                                        tina_lowering="kernel")
    ncfg = cfg.scaled(tina_lowering="native")
    params = model_lib.prepare(model_lib.init_model(cfg, seed=0, device=dev),
                               cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=dev,
                           dtype=torch.int32)
    out = {}
    for c in (cfg, ncfg):
        pre = step_lib.make_prefill_step(c, batch_size=2, seq_len=12)
        dec = step_lib.make_decode_step(c, batch_size=2, cache_len=16)
        caches = model_lib.init_caches(c, 2, 16, device=dev)
        before = (mmk.BF16_LAUNCHES, mmk.LAUNCHES)
        lg, caches = pre(params, {"tokens": tokens[:, :12]}, caches)
        logits = [lg]
        for i in range(12, 16):
            _, lg, caches = dec(params, tokens[:, i], caches)
            logits.append(lg)
        torch.cuda.synchronize()
        out[c.tina_lowering] = (logits, (mmk.BF16_LAUNCHES - before[0],
                                         mmk.LAUNCHES - before[1]))
    assert out["kernel"][1] == (7 * cfg.n_layers * 5, 0)
    assert out["native"][1] == (0, 0)
    for k, n in zip(out["kernel"][0], out["native"][0]):
        assert (k - n).abs().max() <= 2e-2 * n.abs().max()


ZOO = ["kimi_k2_1t_a32b", "arctic_480b", "recurrentgemma_9b", "rwkv6_3b",
       "internvl2_2b", "hubert_xlarge"]


def _linears(cfg, prefill):
    """``layers.linear`` calls of one call of ``cfg``'s model (its bf16
    GEMM launches): attention 4 + its MLP (or a MoE block's shared and
    dense MLPs, 3 each), RG-LRU 5 + MLP, RWKV 8, the frontend once."""
    mlp = 2 if cfg.mlp_type == "gelu" else 3
    ffn = 3 * (bool(cfg.shared_experts) + bool(cfg.dense_residual_ff)) \
        if cfg.moe else mlp
    per = {"attn": 4 + ffn, "rglru": 5 + mlp, "rwkv": 8}
    return sum(per[k] for k in cfg.layer_kinds) + bool(prefill and
                                                        cfg.frontend)


@pytest.mark.parametrize("arch", ZOO)
def test_lm_zoo_family_on_the_card(dev, arch, monkeypatch):
    """Each family's reduced config at bf16 compute on the card: the bf16
    GEMM once per linear (the experts' and router's products are plain
    torch), the logits against the native lowering (2e-2 of max, or twice
    the native run's distance from the model at f32 compute where that is
    larger; MoE rows where both lowerings routed the token alike in every
    layer), and a MoE forward twice bit for bit (the combine adds in a
    fixed order)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    log, real = [], moe_lib.moe_block

    def recording(p, x, c):
        y, aux = real(p, x, c)
        log.append(torch.cat([aux["moe_experts"], aux["moe_kept"]], -1))
        return y, aux

    monkeypatch.setattr(moe_lib, "moe_block", recording)
    cfg = get_reduced(arch).scaled(compute_dtype="bfloat16",
                                   tina_lowering="kernel")
    params = model_lib.prepare(model_lib.init_model(cfg, seed=0, device=dev),
                               cfg)
    b, s = 2, 24
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in make_batch(cfg, b, s - 4).items()}
    toks = torch.randint(0, cfg.vocab_size, (b, 4), device=dev,
                         dtype=torch.int32)
    out, routes = {}, {}
    for c in (cfg, cfg.scaled(tina_lowering="native"),
              cfg.scaled(tina_lowering="native", compute_dtype="float32")):
        before = mmk.BF16_LAUNCHES
        rts = []
        if cfg.family == "audio":
            logits = [model_lib.forward(params, batch, c)[0]]
            calls = [True]
        else:
            pre = step_lib.make_prefill_step(c, batch_size=b, seq_len=s - 4)
            dec = step_lib.make_decode_step(c, batch_size=b, cache_len=s)
            caches = model_lib.init_caches(c, b, s, device=dev)
            log.clear()
            lg, caches = pre(params, batch, caches)
            logits, rts = [lg], [list(log)]
            for i in range(4):
                log.clear()
                _, lg, caches = dec(params, toks[:, i], caches)
                logits.append(lg)
                rts.append(list(log))
            calls = [True] + [False] * 4
        torch.cuda.synchronize()
        out[(c.tina_lowering, c.compute_dtype)] = logits
        routes[c.tina_lowering, c.compute_dtype] = rts
        want = sum(_linears(cfg, p) for p in calls) \
            if c.tina_lowering == "kernel" else 0
        assert mmk.BF16_LAUNCHES - before == want
    kern, nat, f32 = (out[k] for k in (("kernel", "bfloat16"),
                                       ("native", "bfloat16"),
                                       ("native", "float32")))
    rows = []
    for i, (k, n, r) in enumerate(zip(kern, nat, f32)):
        keep = torch.ones(k.shape[0], dtype=torch.bool, device=dev)
        if cfg.moe:
            alike = torch.stack([(x == y).all(-1) for x, y in zip(
                routes["kernel", "bfloat16"][i],
                routes["native", "bfloat16"][i])]).all(0)
            keep = alike.view(b, -1)[:, -1]
            rows.extend(alike.tolist())
        k, n, r = k[keep], n[keep], r[keep]
        d_ref = ((n - r).abs().max() / r.abs().max()).item()
        bar = max(2e-2, 2 * d_ref)
        assert (k - n).abs().max() <= bar * n.abs().max()
    assert not rows or sum(rows) >= 0.75 * len(rows)
    if cfg.moe:
        a = model_lib.forward(params, batch, cfg)
        assert torch.equal(a[0], model_lib.forward(params, batch, cfg)[0])


# -- the mesh ---------------------------------------------------------------
MESH_PATHS = [
    ("pfb_power", graph.build_pfb_power(32, 8), 32 * 300),
    ("spectrogram", graph.build_spectrogram(), 3000),
    ("stft_overlap_add", graph.build_stft_overlap_add(64, 32), 4000),
    ("fir_decimate", graph.build_fir_decimate(), 5000),
    ("correlate", graph.build_correlate(), 5000),
    ("cascaded_channelizer", graph.build_cascaded_channelizer(),
     graph.pipelines._chan_len(5000, 31, 16, 4))]


def _mesh_of(dev, shards):
    from repro_torch.launch.mesh import BatchMesh, make_batch_mesh
    return make_batch_mesh(1) if shards == 1 else BatchMesh((dev,) * shards)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("prec", ["f32", "int8"])
@pytest.mark.parametrize("name,g,n", MESH_PATHS,
                         ids=[p[0] for p in MESH_PATHS])
def test_mesh_plans_bit_for_bit_on_the_card(dev, name, g, n, prec, shards):
    """A 1-device mesh and 4 logical shards of the card, each shard on a
    stream of its own: bit for bit the per-shard plan run on each slice,
    launching the shard count times its kernels; the output is dense and
    its own."""
    mesh = _mesh_of(dev, shards)
    k = 4 // shards
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = graph.compile(g, {"x": (4, n)}, lowering="kernel",
                             precision=prec, mesh=mesh)
        one = graph.compile(g, {"x": (k, n)}, lowering="kernel",
                            precision=prec)
    assert plan.shard_plans == {mesh.devices[0]: one}
    x = torch.randn(4, n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n))
    want = torch.cat([one(x[i:i + k]) for i in range(0, 4, k)])
    before = _int8_counts()
    one(x[:k])
    per_shard = {key: v - before[key] for key, v in _int8_counts().items()}
    before = _int8_counts()
    got = plan(x)
    torch.cuda.synchronize()
    grew = {key: v - before[key] for key, v in _int8_counts().items()}
    assert grew == {key: shards * v for key, v in per_shard.items()}
    assert sum(grew.values()) > 0
    assert torch.equal(got, want), (name, prec, shards)
    st, xs = got.untyped_storage(), x.untyped_storage()
    assert got.is_contiguous() and (
        st.data_ptr() >= xs.data_ptr() + xs.nbytes()
        or xs.data_ptr() >= st.data_ptr() + st.nbytes())


@pytest.mark.parametrize("prec", ["f32", "int8"])
def test_mesh_service_replays_on_the_card(dev, prec):
    """A continuous service over 4 logical shards of the card: its ladder
    starts at 4, every response replays bit for bit, f32 responses hold
    the oracle."""
    from repro_torch.graph.service import PipelineService, replay_batches
    g = graph.build_pfb_power(32, 8)
    n = 32 * 300
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        svc = PipelineService(g, n, batch_size=8, batching="continuous",
                              lowering="kernel", precision=prec,
                              mesh=_mesh_of(dev, 4), record_batches=True)
    assert svc.buckets == (4, 8) and svc.plan.mesh.size == 4
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(13)]
    with svc:
        outs = [f.result(timeout=120) for f in [svc.submit(x) for x in xs]]
    assert replay_batches(svc) == len(xs)
    s = svc.stats()
    assert s["degraded"] == s["quarantined"] == 0
    assert s["card_ms"]["plan"]["count"] == s["batches"]
    if prec == "f32":
        oracle = graph.pfb_power_oracle(32, 8)
        for x, o in zip(xs, outs):
            want = oracle(x)
            assert np.abs(o - want).max() <= 2e-3 * np.abs(want).max()


def test_mesh_shard_runs_while_another_card_is_current(dev):
    """Two cards: a sharded plan called while the second card is current
    runs each shard on its own card, bit for bit each card's per-shard
    plan; a kernel asked to launch on a card that is not current
    raises."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (torch.cuda.device_count() < 2)")
    from repro_torch.launch.mesh import make_batch_mesh
    g, n = graph.build_pfb_power(32, 8), 32 * 300
    mesh = make_batch_mesh(2)
    plan = graph.compile(g, {"x": (4, n)}, lowering="kernel", mesh=mesh)
    x = torch.randn(4, n, device=mesh.devices[0])
    with torch.cuda.device(mesh.devices[1]):
        got = plan(x)
    torch.cuda.synchronize(mesh.devices[0])
    torch.cuda.synchronize(mesh.devices[1])
    parts = []
    for i, d in enumerate(mesh.devices):
        with torch.cuda.device(d):
            one = graph.compile(g, {"x": (2, n)}, lowering="kernel",
                                device=str(d))
            parts.append(one(x[2 * i:2 * i + 2].to(d)).to(mesh.devices[0]))
    assert got.device == mesh.devices[0]
    assert torch.equal(got, torch.cat(parts))
    with torch.cuda.device(mesh.devices[0]):
        with pytest.raises(RuntimeError, match="current device"):
            firk.fir_valid(torch.randn(2, 64, device=mesh.devices[1]),
                           torch.randn(5, device=mesh.devices[1]))
