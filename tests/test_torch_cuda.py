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


# ragged shapes: Tout not a tile multiple, P below and above the 16-branch
# chunk, taps longer than a tile (no halo rule), and taps long enough to
# need more than 48 KB of shared memory
PFB_CASES = [(2, 301, 16, 4), (1, 203, 32, 8), (3, 130, 48, 16),
             (1, 300, 16, 100), (1, 700, 16, 600)]


@pytest.mark.parametrize("b,t,p,m", PFB_CASES)
@pytest.mark.parametrize("tile", pfbk.TILES)
def test_pfb_fused_matches_plain(dev, b, t, p, m, tile):
    gen = torch.Generator(device=dev).manual_seed(b * t + p * m)
    x = torch.randn(b, t, p, device=dev, generator=gen)
    taps = torch.randn(m, p, device=dev, generator=gen)
    fr, fi = ops._fourier(p, str(dev))
    bt, bn = tile
    for f_im in (fi, None):
        got = pfbk.pfb_fused(x, taps, fr, f_im, bt=bt, bn=bn)
        torch.cuda.synchronize()
        want = pfbk.pfb_fused_plain(x, taps, fr, f_im)
        g, w = ((torch.view_as_real(got), torch.view_as_real(want))
                if got.is_complex() else (got, want))
        # fp32 sums of P*M terms taken in another order
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


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


@pytest.mark.parametrize("shape,hop", [((2, 37, 64), 64), ((2, 37, 64), 32),
                                       ((2, 37, 64), 16), ((2, 37, 64), 8),
                                       ((2, 8, 64), 8),   # T = K exactly
                                       ((1, 2047, 1024), 512)])
def test_overlap_add_exact(dev, shape, hop):
    frames = torch.randn(*shape, device=dev)
    got = ops.overlap_add(frames, hop)
    torch.cuda.synchronize()
    assert torch.equal(got, unfk.overlap_add_plain(frames, hop))


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


# K = 1 to K > TAP_CHUNK (4097), ragged rows and lengths
FIR_CASES = [(3, 1000, 1), (2, 999, 8), (5, 4099, 15), (1, 70001, 31),
             (7, 3000, 63), (2, 5003, 129), (2, 9001, 4097)]


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
    assert torch.equal(got, mmk.matmul_int8_plain(xq, wq, sx, ws))


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
def test_dft_int8_bit_exact(dev, rows, n, inverse):
    gen = torch.Generator(device=dev).manual_seed(rows * n)
    xq, sx = quantize.quantize_symmetric(
        torch.randn(rows, n, device=dev, generator=gen), axis=-1)
    qr, sr, qi, si = quantize._qdfm_tensors(n, inverse, str(dev))
    got = dftk.dft_int8(xq, qr, qi, sx.reshape(-1), sr, si)
    torch.cuda.synchronize()
    assert torch.equal(got, dftk.dft_int8_plain(xq, qr, qi, sx.reshape(-1),
                                                sr, si))


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


PFB_INT8_CASES = [(2, 301, 16, 4), (1, 203, 48, 8), (3, 130, 16, 16),
                  (1, 75, 1024, 8), (2, 40, 20, 3)]


@pytest.mark.parametrize("b,t,p,m", PFB_INT8_CASES)
@pytest.mark.parametrize("tile", pfbk.TILES_INT8)
def test_pfb_fused_int8_bit_exact(dev, b, t, p, m, tile):
    gen = torch.Generator(device=dev).manual_seed(b * t + p * m)
    frames = torch.randn(b, t, p, device=dev, generator=gen)
    tq, ts = quantize.quantize_pfb_taps(
        torch.randn(m, p, device=dev, generator=gen))
    qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(dev))
    args = (frames, tq, ts.reshape(-1), qr, qi, sr, si)
    bt, bn = tile
    got = pfbk.pfb_fused_int8(*args, bt=bt, bn=bn)
    torch.cuda.synchronize()
    assert torch.equal(got, pfbk.pfb_fused_int8_plain(*args))


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
            "matmul": mmk.LAUNCHES}


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
    frames = torch.randn(1, 20, 4096, device=dev)
    tq = torch.zeros(4, 4096, dtype=torch.int8, device=dev)
    ts = torch.ones(4096, device=dev)
    qr = torch.zeros(4096, 8, dtype=torch.int8, device=dev)
    s8 = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="does not fit"):   # P too wide
        pfbk.pfb_fused_int8(frames, tq, ts, qr, qr, s8, s8, bt=16)
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
                      bm=128, bn=128)
