"""rwkv6's WKV recurrence as one op (``repro_torch.kernels.wkv``): on the
CPU the op and its gradient are the plain loop's bit for bit and match
the reference's ``lax.scan`` under ``jax.vjp``; on meta the op dispatches
once, at the plain loop's FLOPs exactly, so rwkv6's dry-run cells count
without a loop over tokens.  The ``cuda`` tests hold the kernels of
``csrc/wkv6.cu`` against the plain loop on the card and skip here:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_wkv.py

JAX is imported inside the one test that runs it, so the card's run of
this file needs none.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch.kernels import wkv
from repro_torch.launch import dryrun, shapes
from repro_torch.models import rwkv6 as trwkv

GRAD_RTOL = 1e-5      # the port's f32 gradients against jax.vjp, of max
CARD_RTOL = 1e-4      # the kernels against the plain loop, of max|plain|:
                      # fp32 sums in another order


def _inputs(seed, b, s, h, hs, state=True):
    """r, k, v, w (w = exp(-exp(x)), as the model makes it), u and the
    initial state (normal, or zero), float32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    w = np.exp(-np.exp(2 * n(b, s, h, hs) - 3)).astype(np.float32)
    s0 = n(b, h, hs, hs) if state else np.zeros((b, h, hs, hs), np.float32)
    return [n(b, s, h, hs), n(b, s, h, hs), n(b, s, h, hs), w,
            0.5 * n(h, hs), s0]


def _upstream(seed, b, s, h, hs):
    rng = np.random.default_rng(seed + 1)
    return (rng.standard_normal((b, s, h, hs)).astype(np.float32),
            rng.standard_normal((b, h, hs, hs)).astype(np.float32))


def _grads(fn, ins, gy, gs, needs=63):
    """fn's (out, final state) and the gradients of the inputs whose bit
    is set in ``needs`` against (gy, gs) (gs None: the final state
    unused; an input that reaches only it, as the last w does, then gets
    zeros)."""
    leaves = [torch.from_numpy(x).requires_grad_(bool(needs >> i & 1))
              for i, x in enumerate(ins)]
    y, s = fn(*leaves)
    outs, ups = ((y,), (torch.from_numpy(gy),)) if gs is None else \
        ((y, s), (torch.from_numpy(gy), torch.from_numpy(gs)))
    want = [t for t in leaves if t.requires_grad]
    return y, s, torch.autograd.grad(outs, want, ups, allow_unused=True,
                                     materialize_grads=True)


@pytest.mark.parametrize("b,s,h,hs,state", [(1, 1, 1, 8, True),
                                            (2, 1, 3, 16, True),
                                            (2, 9, 1, 8, True),
                                            (2, 70, 3, 8, False)])
@pytest.mark.parametrize("needs,final", [(63, True), (31, False),
                                         (0b100011, True)])
def test_op_equals_plain_bit_for_bit(b, s, h, hs, state, needs, final):
    """The op's output, final state and the six (or the needed) gradients
    are torch.equal to the plain loop's under autograd, with upstream
    gradients on the output and, where it is used, the final state."""
    ins = _inputs(0, b, s, h, hs, state)
    gy, gs = _upstream(0, b, s, h, hs)
    gs = gs if final else None
    y1, s1, g1 = _grads(wkv.wkv6, ins, gy, gs, needs)
    y2, s2, g2 = _grads(wkv.plain, ins, gy, gs, needs)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert len(g1) == len(g2) == bin(needs).count("1")
    for a, c in zip(g1, g2):
        assert torch.equal(a, c)


def test_model_scan_is_the_op():
    """rwkv6's ``_wkv_scan`` dispatches the one op, and gives the plain
    loop's output and state bit for bit without autograd."""
    ins = [torch.from_numpy(x) for x in _inputs(1, 2, 5, 2, 8)]
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    with Ops():
        y, s = trwkv._wkv_scan(*ins)
    assert seen == [torch.ops.repro_torch.wkv6.default]
    want = wkv.plain(*ins)
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])


@pytest.mark.parametrize("b,s,h,hs", [(1, 1, 1, 8), (2, 17, 3, 16)])
def test_op_grads_match_jax_vjp(b, s, h, hs):
    """The op's gradients of all six inputs against ``jax.vjp`` of the
    reference's ``_wkv_scan``, upstream gradients on both outputs."""
    import jax
    import jax.numpy as jnp

    from repro.models import rwkv6 as jrwkv

    ins = _inputs(2, b, s, h, hs)
    gy, gs = _upstream(2, b, s, h, hs)
    (jy, js), vjp = jax.vjp(jrwkv._wkv_scan, *(jnp.asarray(x) for x in ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    y, st, got = _grads(wkv.wkv6, ins, gy, gs)
    for g, w_ in zip((y, st, *got), (jy, js, *want)):
        g, w_ = g.detach().numpy(), np.asarray(w_)
        assert g.shape == w_.shape
        assert np.abs(g - w_).max() <= GRAD_RTOL * np.abs(w_).max()


def _meta_flops(fn, b, s, h, hs, needs):
    """``FlopCounterMode``'s forward and backward counts of fn on meta
    tensors whose ``requires_grad`` follows ``needs``."""
    shapes_ = [(b, s, h, hs)] * 4 + [(h, hs), (b, h, hs, hs)]
    ts = [torch.empty(sh, device="meta", requires_grad=bool(needs >> i & 1))
          for i, sh in enumerate(shapes_)]
    with FlopCounterMode(display=False) as fwd:
        y, st = fn(*ts)
    with FlopCounterMode(display=False) as bwd:
        (y.sum() + st.sum()).backward()
    return fwd.get_total_flops(), bwd.get_total_flops()


@pytest.mark.parametrize("b,s,h,hs", [(1, 1, 1, 8), (2, 5, 3, 4),
                                      (3, 64, 2, 16), (2, 130, 40, 64)])
@pytest.mark.parametrize("needs", [63, 31, 1, 2, 4, 16, 32, 33, 0b11110])
def test_meta_flops_equal_plain(b, s, h, hs, needs):
    """On meta the op's registered formulas give exactly what
    ``FlopCounterMode`` counts for the plain loop's einsums, forward and
    forward + backward, whichever inputs need gradients."""
    got = _meta_flops(wkv.wkv6, b, s, h, hs, needs)
    assert got == _meta_flops(wkv.plain, b, s, h, hs, needs)
    assert got == (wkv.fwd_flops(b, s, h, hs),
                   wkv.bwd_flops(b, s, h, hs, needs))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_meta_dispatch_independent_of_length(kind):
    """A reduced rwkv6 step on meta dispatches as many ops at 24 tokens
    as at 48: no loop over the sequence is left outside the op."""
    cfg = tconfigs.get_reduced("rwkv6_3b")
    n = []
    for s in (24, 48):
        fn, operands = dryrun.build_step(cfg, shapes.ShapeCell("c", kind,
                                                               s, 2))
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        with grad, _Count() as c:
            fn(*operands)
        n.append(c.n)
    assert n[0] == n[1] > 0


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k"])
def test_full_rwkv6_long_cells_count(cell):
    """Full rwkv6_3b at the grid's train_4k and prefill_32k counts on one
    card (``h100x1``) in seconds: FLOPs, op bytes and memory."""
    cfg = tconfigs.get("rwkv6_3b")
    m = dryrun.cell_counts(cfg, shapes.SHAPES[cell])
    assert m["flops"] > 0 and m["bytes"] > 0
    assert m["memory"]["argument_size_in_bytes"] > 0


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, what):
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= CARD_RTOL * scale, f"{what}: {err} > {CARD_RTOL} * {scale}"


CARD_CASES = [(1, 1, 1, 64, True), (8, 1, 40, 64, True),
              (2, 130, 3, 64, False), (2, 64, 4, 32, True),
              (3, 200, 2, 16, True), (1, 7, 2, 8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hs,state", CARD_CASES)
def test_wkv_forward_kernel_matches_plain(dev, b, s, h, hs, state):
    """The forward kernel (``tina_wkv6_fwd``) against the plain loop on
    the card: out and final state within 1e-4 of max; with checkpoints
    (the state before every CHUNK-th step) equal to the loop's states;
    one launch a call; a non-contiguous input raises."""
    ins = [torch.from_numpy(x).to(dev) for x in _inputs(3, b, s, h, hs,
                                                        state)]
    before = wkv.FWD_LAUNCHES
    y, st, ck = torch.ops.repro_torch.wkv6(*ins, wkv.CHUNK)
    torch.cuda.synchronize()
    assert wkv.FWD_LAUNCHES == before + 1
    want_y, want_s = wkv.plain(*ins)
    _close(y, want_y, "out")
    _close(st, want_s, "state")
    assert ck.shape == (b, h, -(-s // wkv.CHUNK), hs, hs)
    assert torch.equal(ck[:, :, 0], ins[5])
    for c in range(1, ck.shape[2]):
        pre = [t[:, :c * wkv.CHUNK] for t in ins[:4]]
        _close(ck[:, :, c], wkv.plain(*pre, *ins[4:])[1], f"checkpoint {c}")
    strided = torch.empty(b, s, h, 2 * hs, device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv6(strided.copy_(ins[0]), *ins[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hs,state", CARD_CASES)
def test_wkv_backward_kernels_match_plain(dev, b, s, h, hs, state):
    """The backward kernels (``tina_wkv6_bwd``) under autograd against the
    plain loop's gradients on the card, upstream gradients on the output
    and the final state: all six within 1e-4 of max; the same bits on a
    second run (no atomics)."""
    ins = [torch.from_numpy(x).to(dev) for x in _inputs(4, b, s, h, hs,
                                                        state)]
    gy, gs = (torch.from_numpy(x).to(dev) for x in _upstream(4, b, s, h, hs))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in ins]
        before = wkv.BWD_LAUNCHES
        y, st = wkv.wkv6(*leaves)
        runs.append(torch.autograd.grad((y, st), leaves, (gy, gs)))
        assert wkv.BWD_LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = wkv.plain_grads(*ins, gy, gs)
    for name, g, g2, w_ in zip(("r", "k", "v", "w", "u", "state"), *runs,
                               want):
        _close(g, w_, f"grad {name}")
        assert torch.equal(g, g2), name
