"""rwkv6's WKV recurrence as one op, ``repro_torch::wkv6``: the port of
the reference's ``jax.lax.scan`` in ``repro.models.rwkv6._wkv_scan``
(one primitive there, not a Pallas kernel), with its gradient
``repro_torch::wkv6_bwd``.

Per (batch, head), with r, k, v, w (B, S, H, hs), u (H, hs) and the
state S (B, H, hs, hs), step t is

    y_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
    S[i, j] <- w_t[i] S[i, j] + k_t[i] v_t[j]

Each op has three implementations:

* CPU: :func:`plain`, the loop in the reference's ``lax.scan`` order, and
  its gradient by autograd through that loop (``torch.func.vjp``), so a
  CPU run gives what the loop gives, bit for bit;
* CUDA: the kernels of ``csrc/wkv6.cu`` (``tina_wkv6_fwd``,
  ``tina_wkv6_bwd``), at any ``tina_lowering``: the reference's scan is
  the same whatever the lowering.  A CUDA tensor launches them or raises;
* meta (and fake tensors): shapes only, so a dry-run dispatches the whole
  recurrence once.  :func:`register_flop_formula` gives each op exactly
  the FLOPs ``FlopCounterMode`` counts for the plain loop's ``einsum``s,
  forward and backward.

On the card the forward runs one of two kernels, picked by
:func:`route` from the length: the recurrent one (a block per (batch,
head) walks the steps: decode and short prompts) or the chunked one
(a block per (batch, head, chunk of :data:`CHUNK` steps), the chunks
joined by a pass over their boundary states).  Under autograd the
forward also writes the state before every :data:`CHUNK`-th step
(``ckpts``); the backward is chunked the same way, each chunk from its
checkpoint and the gradient at its end, with no per-step state in device
memory.  The CPU's backward recomputes the plain loop and keeps no
checkpoints.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

Tensor = torch.Tensor
CHUNK = 64            # steps a chunk: between the state checkpoints
SUB = 16              # steps a sub-chunk of the chunked kernels
HEAD_SIZES = (8, 16, 32, 64)   # hs the kernels are compiled for
CHUNKED_MIN_STEPS = 56  # the shortest sequence the chunked forward takes:
                        # the crossing of the two kernels' times at
                        # rwkv6-3b's widths (tools/wkv_routes.py)
FWD_LAUNCHES = 0      # tina_wkv6_fwd calls since the last reset (one
                      # kernel, after a memset on the chunked route)
BWD_LAUNCHES = 0      # tina_wkv6_bwd calls (one kernel after a memset)
ROUTES = ("recurrent", "chunked")


def route(s: int, hs: int) -> str:
    """The forward kernel a sequence of ``s`` steps at head size ``hs``
    runs on the card: ``"recurrent"`` below :data:`CHUNKED_MIN_STEPS`
    (a decode step, a short prompt: one block per (batch, head) walks
    the steps), else ``"chunked"`` (a block per chunk of :data:`CHUNK`
    steps).  Both take every hs of :data:`HEAD_SIZES` at every length."""
    if hs not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {hs} not one of {HEAD_SIZES}")
    return "recurrent" if s < CHUNKED_MIN_STEPS else "chunked"


def plain(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
          state: Tensor) -> tuple[Tensor, Tensor]:
    """r/k/v/w: (B, S, H, hs) f32; u: (H, hs); state: (B, H, hs, hs).
    Returns out (B, S, H, hs) and the final state (a new tensor)."""
    s = state
    uk = u[None] * k                                        # (B, S, H, hs)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        out = torch.einsum("bhi,bhij->bhj", rt, s)
        bonus = torch.einsum("bhi,bhi->bh", rt, uk[:, t])
        outs.append(out + bonus[..., None] * vt)
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, 1), s


def plain_grads(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                state: Tensor, gy: Tensor, gs: Tensor, needs: int = 63
                ) -> list[Tensor]:
    """The gradients of :func:`plain`'s (out, final state) against
    (gy, gs), by autograd through the loop: of r, k, v, w, u and state,
    those whose bit (1 << index) is set in ``needs`` (zeros for the
    others, whose graph is not built, as autograd builds none for an
    input that needs no gradient)."""
    ins = [r, k, v, w, u, state]
    idx = [i for i in range(6) if needs >> i & 1]

    def f(*xs):
        args = list(ins)
        for i, x in zip(idx, xs):
            args[i] = x
        return plain(*args)

    out = [torch.zeros_like(t) for t in ins]
    if idx:
        _, vjp = torch.func.vjp(f, *(ins[i] for i in idx))
        for i, g in zip(idx, vjp((gy, gs))):
            out[i] = g
    return out


def _check(what: str, dims: tuple, **ts: Tensor) -> None:
    """Contiguous float32 tensors on one card, of the shapes the op
    takes: no copy is made for any other."""
    b, s, h, hs = dims
    want = {"u": (h, hs), "state": (b, h, hs, hs), "gs": (b, h, hs, hs),
            "ckpts": None}
    dev = ts["r"].device
    for name, t in ts.items():
        shape = want.get(name, (b, s, h, hs))
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous() or \
                (shape is not None and tuple(t.shape) != shape):
            raise ValueError(
                f"{what}: {name} must be a contiguous float32 tensor on "
                f"{dev} of shape {shape}; got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}, strides {t.stride()}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"{what}: head size {hs} not one of {HEAD_SIZES}")


def _chunks(s: int, chunk: int) -> int:
    return -(-s // chunk) if chunk else 0


def _flags(r: Tensor, b: int, h: int, s: int) -> Tensor:
    """The chunked kernels' counter and per-chunk flags (zeroed by the C
    entry before its launch)."""
    return torch.empty(1 + b * h * _chunks(s, CHUNK), dtype=torch.int32,
                       device=r.device)


def forward_kernel(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                   state: Tensor, chunk: int, kind: str
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """One ``tina_wkv6_fwd`` call on the card through the forward kernel
    ``kind`` (one of :data:`ROUTES`): (out, final state, ckpts), as the
    op returns them.  The op passes ``route(S, hs)``; a test may pass
    either."""
    b, s, h, hs = r.shape
    _check("wkv6", (b, s, h, hs), r=r, k=k, v=v, w=w, u=u, state=state)
    if chunk not in (0, CHUNK):
        raise ValueError(f"wkv6: chunk {chunk}: the card's kernels keep a "
                         f"checkpoint every {CHUNK} steps or none (0)")
    if kind not in ROUTES:
        raise ValueError(f"wkv6: route {kind!r} not one of {ROUTES}")
    y = torch.empty_like(r)
    s_new = torch.empty_like(state)
    ckpts = r.new_empty((b, h, _chunks(s, chunk), hs, hs))
    if b * h == 0:
        return y, s_new, ckpts
    chunked = kind == "chunked" and s > 0
    # the chunked kernel passes the chunk-start states through ckpts, or
    # through scratch of the same shape when none are kept
    link = r.new_empty((b, h, _chunks(s, CHUNK), hs, hs)) \
        if chunked and not chunk else ckpts
    flags = _flags(r, b, h, s) if chunked else link
    code = _build.lib().tina_wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), state.data_ptr(), y.data_ptr(), s_new.data_ptr(),
        ckpts.data_ptr(), link.data_ptr(), flags.data_ptr(), b, s, h, hs,
        chunk, int(chunked), _build.stream(r.device))
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    _build.check(code, "wkv6")
    return y, s_new, ckpts


@torch.library.custom_op("repro_torch::wkv6", mutates_args=())
def wkv6_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
            state: Tensor, chunk: int) -> tuple[Tensor, Tensor, Tensor]:
    """(out, final state, ckpts): ckpts (B, H, ceil(S / chunk), hs, hs)
    the state before every ``chunk``-th step (chunk 0: none)."""
    b, s, h, hs = r.shape
    dev = r.device
    if dev.type == "cpu":
        if chunk:
            raise ValueError("wkv6: the CPU keeps no checkpoints (chunk 0)")
        y, s_new = plain(r, k, v, w, u, state)
        return y, s_new, r.new_empty((b, h, 0, hs, hs))
    if dev.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {dev}")
    return forward_kernel(r, k, v, w, u, state, chunk, route(s, hs))


@wkv6_op.register_fake
def _(r, k, v, w, u, state, chunk):
    b, s, h, hs = r.shape
    return (torch.empty_like(r), torch.empty_like(state),
            r.new_empty((b, h, _chunks(s, chunk), hs, hs)))


@torch.library.custom_op("repro_torch::wkv6_bwd", mutates_args=())
def wkv6_bwd_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                state: Tensor, ckpts: Tensor, gy: Tensor, gs: Tensor,
                chunk: int, needs: int) -> tuple[Tensor, Tensor, Tensor,
                                                 Tensor, Tensor, Tensor]:
    """The gradients of r, k, v, w, u and state against (gy, gs), the
    upstream gradients of the output and the final state; ``needs`` has
    bit i set where input i needs one.  The card's chunked kernel reads
    the forward's ``ckpts`` (``chunk`` = :data:`CHUNK` steps apart) and
    computes all six; the CPU recomputes the plain loop."""
    b, s, h, hs = r.shape
    dev = r.device
    if dev.type == "cpu":
        return tuple(plain_grads(r, k, v, w, u, state, gy, gs, needs))
    if dev.type != "cuda":
        raise ValueError(f"wkv6_bwd: no kernel for device {dev}")
    _check("wkv6_bwd", (b, s, h, hs), r=r, k=k, v=v, w=w, u=u, ckpts=ckpts,
           gy=gy, gs=gs)
    if chunk != CHUNK or \
            tuple(ckpts.shape) != (b, h, _chunks(s, chunk), hs, hs):
        raise ValueError(f"wkv6_bwd: checkpoints {tuple(ckpts.shape)} are "
                         f"not every {CHUNK} steps of {s} (chunk {chunk}): "
                         f"the forward ran without them")
    gr, gk, gv, gw = (torch.empty_like(r) for _ in range(4))
    gs0 = torch.empty_like(gs)
    nc = _chunks(s, CHUNK)
    # u's gradient leaves as float64 partials, one per (b, h, chunk)
    gu_part = r.new_empty((b, h, nc, hs), dtype=torch.float64)
    if b * h == 0:
        return gr, gk, gv, gw, gu_part.sum((0, 2)).float(), gs0
    # the gradients at the chunk starts, passed from block to block
    links = r.new_empty((b, h, nc, hs, hs))
    code = _build.lib().tina_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), ckpts.data_ptr(), gy.data_ptr(), gs.data_ptr(),
        gr.data_ptr(), gk.data_ptr(), gv.data_ptr(), gw.data_ptr(),
        gu_part.data_ptr(), gs0.data_ptr(), links.data_ptr(),
        _flags(r, b, h, s).data_ptr(), b, s, h, hs, chunk,
        _build.stream(dev))
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    _build.check(code, "wkv6_bwd")
    # u's gradient: the partials summed in one fixed order (no float
    # atomics: a step is deterministic), rounded once
    return gr, gk, gv, gw, gu_part.sum((0, 2)).float(), gs0


@wkv6_bwd_op.register_fake
def _(r, k, v, w, u, state, ckpts, gy, gs, chunk, needs):
    return (*(torch.empty_like(r) for _ in range(4)), torch.empty_like(u),
            torch.empty_like(state))


def _setup(ctx, inputs, output):
    r, k, v, w, u, state, chunk = inputs
    ctx.chunk = chunk
    ctx.save_for_backward(r, k, v, w, u, state, output[2])


def _backward(ctx, gy, gs, _):
    r, k, v, w, u, state, ckpts = ctx.saved_tensors
    gy = torch.zeros_like(r) if gy is None else gy.contiguous()
    gs = torch.zeros_like(state) if gs is None else gs.contiguous()
    needs = sum(1 << i for i in range(6) if ctx.needs_input_grad[i])
    grads = torch.ops.repro_torch.wkv6_bwd(r, k, v, w, u, state, ckpts, gy,
                                           gs, ctx.chunk, needs)
    return (*(g if ctx.needs_input_grad[i] else None
              for i, g in enumerate(grads)), None)


wkv6_op.register_autograd(_backward, setup_context=_setup)


def fwd_flops(b: int, s: int, h: int, hs: int) -> int:
    """The plain loop's forward as ``FlopCounterMode`` counts it: per step
    the (B·H) batched products r·S (2·hs² each) and r·(u k) (2·hs)."""
    return s * 2 * b * h * (hs * hs + hs)


def bwd_flops(b: int, s: int, h: int, hs: int, needs: int) -> int:
    """The plain loop's backward as ``FlopCounterMode`` counts it, for the
    inputs whose bit is set in ``needs``: each batched product's gradient
    for each operand that needs one.  r·S gives r's (every step) and the
    state's (every step whose incoming state needs one: all if the
    initial state does, else all but the first if k, v or w does);
    r·(u k) gives r's and (u k)'s (if u or k needs one)."""
    need = [bool(needs >> i & 1) for i in range(6)]
    steps_s = s if need[5] else max(s - 1, 0) if any(need[1:4]) else 0
    prod_s, prod_u = 2 * b * h * hs * hs, 2 * b * h * hs
    return (need[0] * s * (prod_s + prod_u) + steps_s * prod_s
            + (need[1] or need[4]) * s * prod_u)


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _fwd_flop_formula(r_shape, *args, out_shape=None, **kwargs) -> int:
    return fwd_flops(*r_shape)


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def _bwd_flop_formula(r_shape, *args, out_shape=None, **kwargs) -> int:
    return bwd_flops(*r_shape, args[-1])


def wkv6(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
         state: Tensor) -> tuple[Tensor, Tensor]:
    """The WKV scan as one op: (out (B, S, H, hs), final state (a new
    tensor)), as :func:`plain` gives them.  Checkpoints are written only
    where a gradient is needed and the backward reads them (the card, and
    meta tensors standing for it)."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, state))
    chunk = CHUNK if grad and r.device.type != "cpu" else 0
    y, s_new, _ = torch.ops.repro_torch.wkv6(r, k, v, w, u, state, chunk)
    return y, s_new


__all__ = ["wkv6", "plain", "plain_grads", "fwd_flops", "bwd_flops",
           "route", "forward_kernel", "CHUNK", "SUB", "HEAD_SIZES",
           "CHUNKED_MIN_STEPS", "ROUTES", "FWD_LAUNCHES", "BWD_LAUNCHES"]
