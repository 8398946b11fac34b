"""rwkv6's WKV recurrence as one op (``repro_torch.kernels.wkv``): on the
CPU the op and its gradient are the plain loop's bit for bit and match
the reference's ``lax.scan`` under ``jax.vjp``; on meta the op dispatches
once, at the plain loop's FLOPs exactly, so rwkv6's dry-run cells count
without a loop over tokens.  A plain-torch emulation of the card's
chunked kernels (the same algebra: sub-chunk factoring, the pass over
chunk ends, gw without dividing by w, the same sums in float64) is held
against the plain loop on decays with exact zeros and denormals.  The
``cuda`` tests hold the kernels of ``csrc/wkv6.cu`` against the plain
loop on the card and skip here:

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
EMU_F64_RTOL = 1e-11  # the chunked emulation in float64 against the plain
                      # loop in float64, of max: the same function exactly
EMU_F64_RATIO = 2.0   # in f32, at most this times the plain loop's f32
                      # distance from float64 (chip_smoke WKV_F64_RATIO)


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


def _hard_decays(seed, w):
    """w with a fiftieth of its entries each set to exactly 0, to a
    denormal (1e-40) and to 1e-10: the decays whose logs are -inf or
    underflow, which a log-space chunked form cannot take."""
    rng = np.random.default_rng(seed + 7)
    flat = w.reshape(-1).copy()
    idx = rng.permutation(flat.size)
    m = max(1, flat.size // 50)
    flat[idx[:m]] = 0.
    flat[idx[m:2 * m]] = np.float32(1e-40)
    flat[idx[2 * m:3 * m]] = np.float32(1e-10)
    return flat.reshape(w.shape)


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


@pytest.mark.parametrize("s,hs", [(1, 8), (15, 64), (16, 8), (16, 64),
                                  (512, 64), (10 ** 6, 16), (0, 32)])
def test_route_is_the_length_rule(s, hs):
    """The forward kernel a call runs: the recurrent one below
    CHUNKED_MIN_STEPS steps (a decode step), else the chunked one, at
    every head size; an unknown head size raises."""
    want = "recurrent" if s < wkv.CHUNKED_MIN_STEPS else "chunked"
    assert wkv.route(s, hs) == want
    assert wkv.CHUNK % wkv.SUB == 0 and wkv.SUB % 8 == 0
    with pytest.raises(ValueError, match="head size"):
        wkv.route(s, 12)


# -- an emulation of csrc/wkv6.cu's chunked kernels in plain torch --------
# Each kernel step in the order the kernels take it: f32 FMA chains where
# the kernels run them (an FMA rounds a * b + c once: computed in float64,
# rounded), the float64 tensor-core sums where the kernels take those (a
# product in float64, rounded once).  In float64 every step is float64.

def _emu_ops(dt):
    f64 = dt == torch.float64

    def rnd(x):
        return x.to(dt)

    def fma(a, b, c):
        return a * b + c if f64 else rnd(a.double() * b.double() + c.double())

    def mm64(a, b):
        return rnd(a.double() @ b.double())

    return rnd, fma, mm64


def _emu_chunks(x, nc, fill):
    """(B, S, H, hs) -> (B, H, chunk, sub-chunk, step, hs), the steps past
    the end padded with ``fill`` (w = 1, the rest 0: a step that changes
    nothing)."""
    b, s, h, hs = x.shape
    out = x.new_full((b, nc * wkv.CHUNK, h, hs), fill)
    out[:, :s] = x
    return out.permute(0, 2, 1, 3).reshape(b, h, nc, -1, wkv.SUB, hs)


def _emu_unchunk(x, s):
    b, h, hs = x.shape[0], x.shape[1], x.shape[-1]
    return x.reshape(b, h, -1, hs)[:, :, :s].permute(0, 2, 1, 3)


def _emu_decays(w):
    """A_t (w over the sub-chunk's steps before t), B_t (after t), D (all),
    each a running product in the kernels' order."""
    A, B = torch.ones_like(w), torch.ones_like(w)
    a, b = torch.ones_like(w[..., 0, :]), torch.ones_like(w[..., 0, :])
    for m in range(wkv.SUB):
        A[..., m, :] = a
        a = a * w[..., m, :]
    for m in reversed(range(wkv.SUB)):
        B[..., m, :] = b
        b = b * w[..., m, :]
    return A, B, a


def _emu_pairs(r, k, w, uk, fma):
    """M[t][s] = sum_i r_t k_s prod_{s<m<t} w_m (s < t), M[t][t] the u
    bonus, 0 above: each product of w a running product over the steps
    it spans."""
    n = wkv.SUB
    M = r.new_zeros(*r.shape[:-2], n, n)
    for t in range(n):
        W = torch.ones_like(w[..., 0, :])
        acc = [torch.zeros_like(W) for _ in range(t)]
        for s in reversed(range(t)):
            acc[s] = fma(r[..., t, :] * k[..., s, :], W, acc[s])
            W = W * w[..., s, :]
        for s in range(t):
            M[..., t, s] = acc[s].sum(-1)
        M[..., t, t] = fma(r[..., t, :], uk[..., t, :], 0 * W).sum(-1)
    return M


def _emu_forward(r, k, v, w, u, s0):
    """(out, final state, ckpts) as the chunked forward kernel computes
    them: each chunk from a zero state (st, the state at each sub-chunk's
    start, and each output's share, in float64), the pass over chunk ends
    (S <- D S + st, rounded once a step), then + (r A D_before) S_c,
    rounded once."""
    rnd, fma, _ = _emu_ops(r.dtype)
    b, s, h, hs = r.shape
    nc, nq = -(-s // wkv.CHUNK), wkv.CHUNK // wkv.SUB
    R, K, V = (_emu_chunks(x, nc, 0.) for x in (r, k, v))
    W = _emu_chunks(w, nc, 1.)
    M = _emu_pairs(R, K, W, u[None, :, None, None, None, :] * K, fma)
    A, B, D = _emu_decays(W)
    Rs, Ks = R * A, K * B
    st = r.new_zeros(b, h, nc, hs, hs, dtype=torch.float64)
    y0 = []
    for q in range(nq):
        y0.append(Rs[:, :, :, q].double() @ rnd(st).double()
                  + M[:, :, :, q].double() @ V[:, :, :, q].double())
        st = D[:, :, :, q, :, None].double() * st \
            + Ks[:, :, :, q].mT.double() @ V[:, :, :, q].double()
    before = [torch.ones_like(D[:, :, :, 0])]
    for q in range(nq):
        before.append(before[-1] * D[:, :, :, q])
    states = [s0]
    for c in range(nc):
        states.append(rnd(before[nq][:, :, c, :, None].double()
                          * states[-1].double() + st[:, :, c]))
    S = torch.stack(states[:-1], 2)
    y = torch.stack([rnd(y0[q] + (Rs[:, :, :, q] * before[q][..., None, :])
                         .double() @ S.double()) for q in range(nq)], 3)
    return _emu_unchunk(y, s), states[-1], S


def _emu_backward(r, k, v, w, u, ckpts, gy, gs):
    """The six gradients as the chunked backward kernel computes them:
    the pass over chunk ends (G_start = D G_end + sum (r A) gy^T), the
    sub-chunks' states from the checkpoint, then, last sub-chunk first,
    Z = gy S_q^T, Z2 = v G_q^T, Q = gy v^T and gv in float64, and the
    sums over pairs of steps in f32 by running products: H_s(t) going
    back, alpha_s(t) going on, so gw = <G_t, S_t> takes no quotient."""
    rnd, fma, mm64 = _emu_ops(r.dtype)
    b, s, h, hs = r.shape
    nc, nq, n = -(-s // wkv.CHUNK), wkv.CHUNK // wkv.SUB, wkv.SUB
    R, K, V, GY = (_emu_chunks(x, nc, 0.) for x in (r, k, v, gy))
    W = _emu_chunks(w, nc, 1.)
    uu = u[None, :, None, :]
    M = _emu_pairs(R, K, W, u[None, :, None, None, None, :] * K, fma)
    Q = mm64(GY, V.mT)
    A, B, D = _emu_decays(W)
    Rs, Ks = R * A, K * B
    Sq = [ckpts]
    for q in range(nq - 1):
        Sq.append(rnd(D[:, :, :, q, :, None].double() * Sq[-1].double()
                      + Ks[:, :, :, q].mT.double() @ V[:, :, :, q].double()))
    Vc = torch.zeros_like(ckpts, dtype=torch.float64)
    for q in reversed(range(nq)):
        Vc = D[:, :, :, q, :, None].double() * Vc \
            + Rs[:, :, :, q].mT.double() @ GY[:, :, :, q].double()
    dc = torch.ones_like(D[:, :, :, 0])
    for q in range(nq):
        dc = dc * D[:, :, :, q]
    ends, g = [None] * nc, gs
    for c in reversed(range(nc)):
        ends[c] = g
        g = rnd(dc[:, :, c, :, None].double() * g.double() + Vc[:, :, c])
    G = torch.stack(ends, 2)
    gr, gk, gv, gw = (torch.zeros_like(R) for _ in range(4))
    gu = torch.zeros_like(R[:, :, :, 0, 0], dtype=torch.float64)
    for q in reversed(range(nq)):
        rq, kq, wq, Qq = R[:, :, :, q], K[:, :, :, q], W[:, :, :, q], \
            Q[:, :, :, q]
        Z = mm64(GY[:, :, :, q], Sq[q].mT)
        Z2 = mm64(V[:, :, :, q], G.mT)
        gv[:, :, :, q] = rnd(Ks[:, :, :, q].double() @ G.double()
                             + M[:, :, :, q].mT.double()
                             @ GY[:, :, :, q].double())
        c1 = (Sq[q] * G).sum(-1)
        zero = torch.zeros_like(c1)
        f, sqa, sz2a, sqb = ([zero] * n for _ in range(4))
        for s_ in range(n):
            hs_ = [zero] * n
            for t in range(n - 1, s_, -1):
                hs_[t - 1] = fma(wq[..., t, :], hs_[t],
                                 rq[..., t, :] * Qq[..., t, s_, None])
            sqb[s_] = hs_[s_]
            al = kq[..., s_, :]
            for t in range(s_ + 1, n):
                f[t] = fma(al, hs_[t], f[t])
                sqa[t] = fma(al, Qq[..., t, s_, None], sqa[t])
                sz2a[t] = fma(al, Z2[..., s_, :], sz2a[t])
                al = al * wq[..., t, :]
        szb, zrun = [zero] * n, zero
        for t in range(n - 1, -1, -1):
            szb[t] = zrun
            zrun = fma(wq[..., t, :], zrun, rq[..., t, :] * Z[..., t, :])
        for t in range(n):
            a_t, b_t, qd = A[:, :, :, q, t], B[:, :, :, q, t], \
                Qq[..., t, t, None]
            rt, kt = rq[..., t, :], kq[..., t, :]
            gr[:, :, :, q, t] = fma(uu * kt, qd,
                                    fma(a_t, Z[..., t, :], sqa[t]))
            gk[:, :, :, q, t] = fma(uu * rt, qd,
                                    fma(b_t, Z2[..., t, :], sqb[t]))
            gw[:, :, :, q, t] = fma(a_t * b_t, c1,
                                    fma(a_t, szb[t], fma(b_t, sz2a[t], f[t])))
            gu = gu + rt.double() * kt.double() * qd.double()
        if q:
            G = rnd(D[:, :, :, q, :, None].double() * G.double()
                    + Rs[:, :, :, q].mT.double() @ GY[:, :, :, q].double())
    return [_emu_unchunk(x, s) for x in (gr, gk, gv, gw)] + \
        [rnd(gu.sum((0, 2))), g]


@pytest.mark.parametrize("hs", wkv.HEAD_SIZES)
@pytest.mark.parametrize("s", [1, 7, 64, 130, 200])
@pytest.mark.parametrize("state", [False, True])
def test_chunked_emulation_matches_plain(s, hs, state):
    """The chunked kernels' algebra, emulated, against the plain loop and
    its autograd gradients on decays with exact zeros, denormals and
    values below 1e-9: in float64 the same function (out, final state,
    the checkpoints the backward reads, the six gradients); in f32
    finite, within 1e-4 of max of the f32 plain loop and at most twice
    its distance from float64 (one f32 ulp of max where the plain loop's
    distance is below that)."""
    b, h = 2, 2
    ins = _inputs(5, b, s, h, hs, state)
    ins[3] = _hard_decays(5, ins[3])
    gy, gs = _upstream(5, b, s, h, hs)
    f32 = [torch.from_numpy(x) for x in (*ins, gy, gs)]
    f64 = [x.double() for x in f32]
    for ts in (f64, f32):
        got = _emu_forward(*ts[:6])
        want = wkv.plain(*ts[:6])
        got_g = _emu_backward(*ts[:5], got[2], *ts[6:])
        want_g = wkv.plain_grads(*ts)
        pairs = list(zip(got[:2], want)) + list(zip(got_g, want_g))
        names = ["out", "state", "gr", "gk", "gv", "gw", "gu", "gs0"]
        names += [f"ckpt{c}" for c in range(got[2].shape[2])]
        pairs.append((got[2][:, :, 0], ts[5]))
        for c in range(1, got[2].shape[2]):
            pre = [t[:, :c * wkv.CHUNK] for t in ts[:4]]
            pairs.append((got[2][:, :, c], wkv.plain(*pre, *ts[4:6])[1]))
        if ts is f64:
            for g, w_ in pairs:
                assert (g - w_).abs().max() <= EMU_F64_RTOL * w_.abs().max()
            want64 = [w_ for _, w_ in pairs]
            continue
        for name, (g, w_), w64 in zip(names, pairs, want64):
            assert torch.isfinite(g).all()
            scale = w_.abs().max().item()
            assert (g - w_).abs().max().item() <= CARD_RTOL * scale
            d_k = (g.double() - w64).abs().max().item()
            d_p = (w_.double() - w64).abs().max().item()
            ulp = float(np.spacing(np.float32(scale)))
            assert d_k <= max(EMU_F64_RATIO * d_p, ulp), (name, d_k, d_p)


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
@pytest.mark.parametrize("kind", wkv.ROUTES)
@pytest.mark.parametrize("b,s,h,hs,state", CARD_CASES)
def test_wkv_forward_kernel_matches_plain(dev, b, s, h, hs, state, kind):
    """Each forward kernel (``tina_wkv6_fwd``, recurrent and chunked)
    against the plain loop on the card: out and final state within 1e-4
    of max; with checkpoints (the state before every CHUNK-th step) equal
    to the loop's states, and the same out and state without them; one
    launch a call; the op takes route(S, hs); a non-contiguous input
    raises."""
    ins = [torch.from_numpy(x).to(dev) for x in _inputs(3, b, s, h, hs,
                                                        state)]
    before = wkv.FWD_LAUNCHES
    y, st, ck = wkv.forward_kernel(*ins, wkv.CHUNK, kind)
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
    y0, st0, _ = wkv.forward_kernel(*ins, 0, kind)
    assert torch.equal(y0, y) and torch.equal(st0, st)
    y1, st1, _ = torch.ops.repro_torch.wkv6(*ins, wkv.CHUNK)
    if kind == wkv.route(s, hs):
        assert torch.equal(y1, y) and torch.equal(st1, st)
    strided = torch.empty(b, s, h, 2 * hs, device=dev)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv6(strided.copy_(ins[0]), *ins[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hs,state", CARD_CASES)
def test_wkv_backward_kernels_match_plain(dev, b, s, h, hs, state):
    """The backward kernel (``tina_wkv6_bwd``) under autograd against the
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", wkv.ROUTES)
@pytest.mark.parametrize("b,s,h,hs", [(2, 130, 3, 64), (1, 70, 2, 8),
                                      (2, 100, 2, 32)])
def test_wkv_kernels_take_zero_decays(dev, b, s, h, hs, kind):
    """Decays of exactly 0, denormal and 1e-10: both forward kernels and
    the backward give finite values within 1e-4 of max of the plain
    loop's."""
    ins = _inputs(6, b, s, h, hs)
    ins[3] = _hard_decays(6, ins[3])
    ins = [torch.from_numpy(x).to(dev) for x in ins]
    gy, gs = (torch.from_numpy(x).to(dev) for x in _upstream(6, b, s, h, hs))
    y, st, ck = wkv.forward_kernel(*ins, wkv.CHUNK, kind)
    want_y, want_s = wkv.plain(*ins)
    for name, g, w_ in (("out", y, want_y), ("state", st, want_s)):
        assert torch.isfinite(g).all(), name
        _close(g, w_, name)
    grads = torch.ops.repro_torch.wkv6_bwd(*ins, ck, gy, gs, wkv.CHUNK, 63)
    for name, g, w_ in zip(("r", "k", "v", "w", "u", "state"), grads,
                           wkv.plain_grads(*ins, gy, gs)):
        assert torch.isfinite(g).all(), name
        _close(g, w_, f"grad {name}")
