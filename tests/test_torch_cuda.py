"""The port's CUDA kernels against their plain torch versions, on the
card.  Every test here is marked ``cuda`` and skips without one; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import graph
from repro_torch.kernels import elementwise as ewk
from repro_torch.kernels import ops
from repro_torch.kernels import pfb as pfbk

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
        ewk.elementwise_chain(x, (), (), abs2_head=True)


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
