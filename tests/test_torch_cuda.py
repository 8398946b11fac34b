"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here is marked ``cuda`` and skips without one; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import graph
from repro_torch.core import functions
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
