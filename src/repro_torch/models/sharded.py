"""The model over a mesh's shards: the forward, the training loss and the
serving steps of :mod:`repro_torch.models.model` for the dense decoders
and the MoE family, one process driving every position of a
:class:`repro_torch.launch.mesh.Mesh` (the reference's single
controller, ``jax.jit`` over a mesh).

A sharded value is a list with one tensor a mesh position.  Every
position runs the single-device layers (:mod:`repro_torch.models.layers`)
on its own block of the parameters with a per-shard config
(:class:`Layout`: ``n_heads / tp``, the KV heads it holds), and the
collectives of :mod:`repro_torch.distributed.collectives` stand where
the reference's GSPMD puts them:

* column-parallel ``wq``/``wk``/``wv`` (and biases), ``up``/``gate``;
  row-parallel ``wo``/``down``, then an all-reduce over the
  tensor-parallel axis.  Heads split whole: the reference splits the flat
  ``h * hd`` axis, which for a head count the axis divides is the same
  blocks; KV heads the axis does not divide but whose count divides it
  are replicated, each shard reading the one its query heads use;
* the embedding vocab-parallel: a masked lookup, then an all-reduce;
* the head and cross-entropy vocab-parallel: the max and the sum of
  exponentials all-reduced, so the whole vocabulary's logits are never
  gathered in training;
* the MoE block on the reference's ``shard_map`` path
  (``cfg.moe_dispatch == "shard_map"``): each shard routes and sorts its
  data shard's tokens over its own expert group and the partial outputs
  meet in one bf16 sum (:func:`repro_torch.models.moe.routed`); on the
  GSPMD path the tokens are gathered over the data axes, every shard
  routes all of them and runs its expert group, and the outputs are
  summed over the expert axis: the unsharded block's result.

Parameters arrive per position in the layout a step keeps them in
(:func:`repro_torch.distributed.sharding.step_param_specs`); a training
step's ZeRO-3 blocks are gathered to the compute layout where a layer
uses them (inside the superblock's recomputed region, so the backward
gathers again).  Serving steps keep their weights in the compute layout
(prepared or not) and gather nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import kv_replicated
from repro_torch.launch.mesh import _names
from repro_torch.models import convert, layers, moe
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.partitioning import PartitionSpec
from repro_torch.tree import flatten_with_path, leaves, map_tree, unflatten

Tensor = torch.Tensor
NEXT = "ROADMAP.md item 20's remainder"


def device_ctx(dev: torch.device):
    """The context a position's work runs in: its card current."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def check_family(cfg: ModelConfig) -> None:
    """The families this slice shards: the dense decoders and MoE."""
    if cfg.family not in ("dense", "moe") or cfg.frontend \
            or tuple(cfg.block_pattern) != ("attn",) or not cfg.causal:
        raise NotImplementedError(
            f"sharded steps: {cfg.name} ({cfg.family}) is not in this "
            f"slice (the dense decoders and MoE); see {NEXT}")


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _axes_of(spec, dim: int):
    entries = tuple(spec)
    return entries[dim] if -len(entries) <= dim < len(entries) else None


@dataclasses.dataclass
class Layout:
    """How a sharded step splits ``cfg`` over ``mesh`` under ``rules``."""

    cfg: ModelConfig
    mesh: object
    rules: dict
    dp: tuple               # the batch's mesh axes (none: replicated)
    tp: tuple               # the tensor-parallel axes (none: no TP)
    local: ModelConfig      # one shard's attention config
    kv_group: int           # > 0: KV heads replicated, this many shards
                            # read each
    vocab: tuple            # the embedding table's vocab axes
    head_vocab: tuple       # the head's (== vocab for a tied head)
    expert: tuple           # the experts' axes
    ep: bool                # the reference's shard_map dispatch
    canon: list             # one position a data shard, in rank order

    @property
    def tp_size(self) -> int:
        return self.mesh.count(self.tp)

    def rank(self, i: int, axes) -> int:
        return self.mesh.rank(i, axes)


def make_layout(cfg: ModelConfig, mesh, rules: dict, compute_specs
                ) -> Layout:
    """The :class:`Layout` of ``cfg`` on ``mesh``; ``compute_specs`` are
    the parameters' compute-layout specs (their vocab and expert axes).
    Raises ValueError for head counts the tensor-parallel axis cannot
    split."""
    check_family(cfg)
    shape = mesh.shape
    dp = tuple(a for a in _names(rules.get("batch")) if a in shape)
    tp = tuple(a for a in _names(rules.get("tp")) if a in shape)
    n = mesh.count(tp)
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    group = 0
    if n > 1:
        widths = {"n_heads": h, "d_ff": cfg.d_ff,
                  "shared expert d_ff": cfg.d_ff * cfg.shared_experts,
                  "dense_residual_ff": cfg.dense_residual_ff}
        bad = {k: v for k, v in widths.items() if v % n}
        if bad or (hkv % n and n % hkv):
            raise ValueError(
                f"sharded steps: {cfg.name} on {n}-way tensor parallelism: "
                f"{bad or {'n_kv_heads': hkv}} do not split into whole "
                f"heads or columns (the reference splits the flat axis; "
                f"see {NEXT})")
        if kv_replicated(cfg, mesh, rules):
            group = n // hkv
    local = cfg.scaled(n_heads=h // n,
                       n_kv_heads=1 if group else hkv // n,
                       d_ff=cfg.d_ff // n)
    flat = dict(flatten_with_path(compute_specs, is_leaf=_is_spec))
    vocab = _names(_axes_of(flat["embed/table"], 0))
    head_vocab = vocab if cfg.tie_embeddings \
        else _names(_axes_of(flat["head/w"], -1))
    expert = ()
    if cfg.moe:
        key = next(k for k in flat if k.endswith("ffn/w_up"))
        expert = _names(_axes_of(flat[key], -3))
    ep = bool(cfg.moe and cfg.moe_dispatch == "shard_map"
              and "model" in shape
              and cfg.n_experts % shape["model"] == 0)
    if ep and expert != ("model",):
        raise ValueError(f"sharded steps: the shard_map dispatch needs the "
                         f"experts over 'model', the specs put them over "
                         f"{expert}")
    others = [a for a in mesh.axes if a not in dp]
    canon = sorted((i for i in range(mesh.size)
                    if all(mesh.coords(i)[a] == 0 for a in others)),
                   key=lambda i: mesh.rank(i, dp))
    return Layout(cfg, mesh, rules, dp, tp, local, group, vocab,
                  head_vocab, expert, ep, canon)


# ---------------------------------------------------------------------------
# parameters: per position, brought to the compute layout at their use
# ---------------------------------------------------------------------------
def reshard(xs: list, mesh, src, dst, *, grad_dtype=None) -> list:
    """One leaf's per-position blocks from spec ``src`` to spec ``dst``:
    each dim split differently is gathered over ``src``'s axes (the
    backward reduce-scatters, in ``grad_dtype`` where given), then cut to
    the position's block over ``dst``'s."""
    nd = xs[0].ndim
    src = tuple(src) + (None,) * (nd - len(src))
    dst = tuple(dst) + (None,) * (nd - len(dst))
    for dim, (s, c) in enumerate(zip(src, dst)):
        if s == c:
            continue
        if s is not None:
            xs = coll.all_gather(xs, mesh, s, dim, grad_dtype=grad_dtype)
        if c is not None:
            n = mesh.count(c)
            xs = [x.narrow(dim, mesh.rank(i, c) * (x.shape[dim] // n),
                           x.shape[dim] // n) for i, x in enumerate(xs)]
    return xs


class Weights:
    """Per-position parameter trees, and their parts in the compute
    layout.  ``store``/``compute``: spec trees of the trees' layout and
    of the compute layout (a training step: the training layout, stack
    leaves with their repeat axis); None when the trees are in the
    compute layout already (serving: the per-repeat layout of
    ``models.model.init_model``, prepared or not)."""

    def __init__(self, trees: list, mesh, store=None, compute=None, *,
                 grad_dtype=None):
        self.mesh = mesh
        self.store, self.compute = store, compute
        self.grad_dtype = grad_dtype
        self.views = [convert.unstack_views(t) for t in trees] \
            if store is not None else trees

    def _to_compute(self, subs: list, store, compute) -> list:
        flats = [flatten_with_path(s) for s in subs]
        sflat = flatten_with_path(store, is_leaf=_is_spec)
        cflat = flatten_with_path(compute, is_leaf=_is_spec)
        cols = []
        for j in range(len(flats[0])):
            cols.append(reshard([f[j][1] for f in flats], self.mesh,
                                sflat[j][1], cflat[j][1],
                                grad_dtype=self.grad_dtype))
        return [unflatten(subs[i], [c[i] for c in cols])
                for i in range(len(subs))]

    def part(self, key: str) -> list:
        """``params[key]`` (embed, head, final_norm), per position."""
        subs = [v[key] for v in self.views]
        if self.store is None:
            return subs
        return self._to_compute(subs, self.store[key], self.compute[key])

    def stored(self, r: int) -> list:
        """Repeat ``r`` of the stack as each position keeps it."""
        return [v["stack"][r] for v in self.views]

    def block(self, r: int, sub: str, stored: Optional[list] = None
              ) -> list:
        """Repeat ``r``'s block ``sub`` of the stack, per position (from
        ``stored``, :meth:`stored`'s lists, where given)."""
        subs = [v[sub] for v in (stored or self.stored(r))]
        if self.store is None:
            return subs
        strip = lambda t: map_tree(lambda sp: PartitionSpec(*sp[1:]), t,
                                   is_leaf=_is_spec)
        return self._to_compute(subs, strip(self.store["stack"][sub]),
                                strip(self.compute["stack"][sub]))


def pmap(L: Layout, fn, *lists) -> list:
    """``fn(i, *items)`` at every position, each under its device."""
    out = []
    for i, dev in enumerate(L.mesh.devices):
        with device_ctx(dev):
            out.append(fn(i, *(lst[i] for lst in lists)))
    return out


# ---------------------------------------------------------------------------
# layers over shards
# ---------------------------------------------------------------------------
def _kv_block(p: dict, g: int, hd: int) -> dict:
    """A replicated ``wk``/``wv``'s columns (its K-major copy's rows) of KV
    head ``g``."""
    out = {"w": p["w"].narrow(1, g * hd, hd)}
    if "b" in p:
        out["b"] = p["b"].narrow(0, g * hd, hd)
    if "wt" in p:
        out["wt"] = p["wt"].narrow(0, g * hd, hd)
    return out


def _tp_sum(L: Layout, xs: list) -> list:
    return coll.all_reduce(xs, L.mesh, L.tp) if L.tp_size > 1 else xs


def embed(L: Layout, tables: list, tokens: list) -> list:
    """The vocab-parallel lookup: each shard's rows of its block of the
    table (zeros for tokens outside it), summed over the vocab axes, in
    the table's dtype, then cast (the reference's ``table[tokens]``)."""
    cd = layers.cdtype(L.cfg)
    if not L.vocab:
        return pmap(L, lambda i, t, tok: t[tok].to(cd), tables, tokens)

    def local(i, t, tok):
        v = t.shape[0]
        ids = tok - L.rank(i, L.vocab) * v
        inside = (ids >= 0) & (ids < v)
        return t[ids.clamp(0, v - 1)] * inside[..., None].to(t.dtype)

    rows = coll.all_reduce(pmap(L, local, tables, tokens), L.mesh, L.vocab)
    return [x.to(cd) for x in rows]


def moe_block(L: Layout, ps: list, zs: list) -> tuple[list, dict]:
    """The MoE block over shards: (outputs, aux on the first position)."""
    cfg, mesh = L.cfg, L.mesh
    e, k = cfg.n_experts, cfg.n_experts_per_token
    ne = mesh.count(L.expert)
    e_per = e // ne
    b, s, d = zs[0].shape
    if L.ep:
        def body(i, p, z):
            return moe.routed(p, z.reshape(b * s, d), cfg,
                              lo=L.rank(i, L.expert) * e_per, n_local=e_per,
                              router_in_x_dtype=True)
        out = pmap(L, body, ps, zs)
        ys = coll.expert_combine([y for y, _ in out], mesh, L.expert)
        ys = [y.reshape(b, s, d) for y in ys]
        every = L.dp + L.expert
        kept = coll.all_reduce([st["kept"] for _, st in out], mesh, every)
        made = coll.all_reduce([st["assigned"] for _, st in out], mesh,
                               every)
        aux = coll.all_reduce([st["aux_loss"] for _, st in out], mesh, every)
        n = mesh.count(L.dp) * mesh.count(L.expert)
        stats = {"moe_aux_loss": aux[0] / n,
                 "moe_drop_frac": 1.0 - kept[0] / made[0].clamp_min(1.0),
                 "moe_experts": [st["experts"] for _, st in out],
                 "moe_kept": [st["kept_mask"] for _, st in out]}
    else:
        z_all = coll.all_gather(zs, mesh, L.dp, 0) if L.dp else zs
        n_all = z_all[0].shape[0] * s

        def body(i, p, z):
            return moe.routed(p, z.reshape(n_all, d), cfg,
                              lo=L.rank(i, L.expert) * e_per, n_local=e_per)
        out = pmap(L, body, ps, z_all)
        ys = [y for y, _ in out]
        kept = [st["kept"] for _, st in out]
        if ne > 1:
            ys = coll.all_reduce(ys, mesh, L.expert)
            kept = coll.all_reduce(kept, mesh, L.expert)
        nd = mesh.count(L.dp)
        ys = [y.reshape(-1, s, d).narrow(0, L.rank(i, L.dp) * b, b)
              if nd > 1 else y.reshape(b, s, d) for i, y in enumerate(ys)]
        stats = {"moe_aux_loss": out[0][1]["aux_loss"],
                 "moe_drop_frac": 1.0 - kept[0] * (1.0 / (n_all * k)),
                 "moe_experts": [st["experts"] for _, st in out],
                 "moe_kept": [st["kept_mask"] for _, st in out]}
    for key in ("shared", "dense"):
        if key in ps[0]:
            extra = _tp_sum(L, pmap(L, lambda i, p, z: layers.mlp(
                p[key], z, L.local), ps, zs))
            ys = [y + h for y, h in zip(ys, extra)]
    return ys, stats


def block(L: Layout, ps: list, xs: list, ctx: dict, caches: Optional[list]
          ) -> tuple[list, dict]:
    """One attention block (attention, then the MLP or MoE block) over
    shards; ``ctx`` maps a device to its (positions, pos0, rope angles).
    Caches are written in place."""
    cfg, hd = L.cfg, L.cfg.head_dim
    caches = caches or [None] * len(xs)

    def attn(i, p, x, c):
        pa = p["attn"]
        if L.kv_group:
            g = L.rank(i, L.tp) // L.kv_group
            pa = {**pa, "wk": _kv_block(pa["wk"], g, hd),
                  "wv": _kv_block(pa["wv"], g, hd)}
        positions, pos0, angles = ctx[x.device]
        h, _ = layers.attention(pa, layers.norm(p["ln1"], x, cfg), L.local,
                                positions=positions, pos0=pos0, cache=c,
                                window=cfg.local_window, angles=angles)
        return h

    hs = _tp_sum(L, pmap(L, attn, ps, xs, caches))
    xs = [x + h for x, h in zip(xs, hs)]
    zs = pmap(L, lambda i, p, x: layers.norm(p["ln2"], x, cfg), ps, xs)
    aux: dict = {}
    if cfg.moe:
        hs, aux = moe_block(L, [p["ffn"] for p in ps], zs)
    else:
        hs = _tp_sum(L, pmap(L, lambda i, p, z: layers.mlp(p["ffn"], z,
                                                           L.local), ps, zs))
    return [x + h for x, h in zip(xs, hs)], aux


def _rope_ctx(L: Layout, b: int, s: int, pos0: int) -> dict:
    out = {}
    for dev in L.mesh.distinct:
        with device_ctx(dev):
            positions = (pos0 + torch.arange(s, dtype=torch.int32,
                                             device=dev)).expand(b, s)
            out[dev] = (positions, pos0, layers.rope_angles(positions,
                                                            L.cfg))
    return out


def run_blocks(L: Layout, W: Weights, xs: list, *, pos0: int = 0,
               caches: Optional[list] = None, remat: bool = False
               ) -> tuple[list, dict]:
    """The stack (and tail) over shards; the MoE statistics summed in
    layer order on the first position's device.  Without caches and with
    autograd on, each superblock is recomputed in the backward
    (:class:`_Remat`) where ``remat``, as the single-device stack's
    ``torch.utils.checkpoint`` does."""
    cfg = L.cfg
    pat, reps, tail = model_lib._pattern_layout(cfg)
    b, s = xs[0].shape[:2]
    ctx = _rope_ctx(L, b, s, pos0)
    dev0 = L.mesh.devices[0]
    zero = lambda: torch.zeros((), dtype=torch.float32, device=dev0)

    def run(rs, parts, *xs):
        """Repeats ``rs`` of the stack; ``parts[j]``: repeat rs[j] as each
        position keeps it."""
        xs = list(xs)
        aux = {k: zero() for k in model_lib.AUX_KEYS}
        for r, part in zip(rs, parts):
            for i_sub, _ in enumerate(pat):
                name = f"sub{i_sub}"
                cs = None if caches is None else \
                    [c["stack"][r][name] for c in caches]
                xs, a = block(L, W.block(r, name, part), xs, ctx, cs)
                for key in model_lib.AUX_KEYS:
                    if key in a:
                        aux[key] = aux[key] + a[key].to(dev0)
        return (*xs, *[aux[k] for k in model_lib.AUX_KEYS])

    if tail:
        raise NotImplementedError(f"sharded steps: {cfg.n_layers} layers "
                                  f"leave a tail; see {NEXT}")
    if caches is None and torch.is_grad_enabled():
        segments = model_lib._remat_segments(cfg, reps, remat)
    else:
        segments = [(range(reps), False)]
    aux = {k: zero() for k in model_lib.AUX_KEYS}
    for rs, ckpt in segments:
        parts = [W.stored(r) for r in rs]
        if ckpt:
            flat = leaves(parts)
            out = _Remat.apply(
                lambda *ts: run(rs, unflatten(parts, ts[:len(flat)]),
                                *ts[len(flat):]), len(flat), *flat, *xs)
        else:
            out = run(rs, parts, *xs)
        xs = list(out[:len(xs)])
        for key, v in zip(model_lib.AUX_KEYS, out[len(xs):]):
            aux[key] = aux[key] + v
    return xs, aux


class _Remat(torch.autograd.Function):
    """Activation checkpointing of a region that spans the mesh's
    devices: the forward runs ``fn`` without a graph and keeps its
    inputs; the backward runs it again with one and takes the gradients
    of its inputs (a nested ``torch.autograd.grad``).  The parameters the
    region reads are inputs (``n_params`` of them, first), so their
    gradients leave through this node.  (``torch.utils.checkpoint``'s
    non-reentrant recompute is started by whichever device's autograd
    thread first unpacks a saved tensor, and two cards' threads can
    start it at once.)"""

    @staticmethod
    def forward(ctx, fn, n_params, *ts):
        ctx.fn = fn
        ctx.save_for_backward(*ts)
        with torch.no_grad():
            out = fn(*ts)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gouts):
        ts = [t.detach().requires_grad_(t.is_floating_point())
              for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.fn(*ts)
        pairs = [(o, g) for o, g in zip(out, gouts)
                 if g is not None and o.requires_grad]
        want = [t for t in ts if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       want, [g for _, g in pairs],
                                       allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in ts]
        return (None, None, *grads)


def logits(L: Layout, W: Weights, hs: list) -> list:
    """Each position's logits over its block of the vocabulary (f32)."""
    cfg = L.cfg
    norms = W.part("final_norm")
    head = W.part("embed") if cfg.tie_embeddings else W.part("head")

    def local(i, pn, ph, h):
        return model_lib._logits({"final_norm": pn, "embed": ph,
                                  "head": ph}, h, cfg)
    return pmap(L, local, norms, head, hs)


def cross_entropy(L: Layout, lg: list, targets: list, masks: list) -> list:
    """Per position, each token's masked NLL under the vocab-parallel
    logits ``lg``: the global max (no gradient) and the sums of
    exponentials and of the gold logit all-reduced over the vocab axes;
    the reference's ``_ce`` before its mean."""
    mesh, ax = L.mesh, L.head_vocab
    if not ax:
        def whole(i, x, t, m):
            x = x.float()
            ids = torch.arange(x.shape[-1], dtype=torch.int32,
                               device=x.device)
            gold = torch.where(ids == t[..., None].to(torch.int32), x,
                               0.0).sum(-1)
            return (torch.logsumexp(x, -1) - gold) * m
        return pmap(L, whole, lg, targets, masks)
    lg = [x.float() for x in lg]
    mx = coll.all_reduce_max([x.amax(-1) for x in lg], mesh, ax)
    se = coll.all_reduce(pmap(L, lambda i, x, m: torch.exp(
        x - m[..., None]).sum(-1), lg, mx), mesh, ax)

    def gold(i, x, t):
        v = x.shape[-1]
        ids = torch.arange(v, dtype=torch.int32, device=x.device) \
            + L.rank(i, ax) * v
        return torch.where(ids == t[..., None].to(torch.int32), x,
                           0.0).sum(-1)
    gs = coll.all_reduce(pmap(L, gold, lg, targets), mesh, ax)
    return [(m + torch.log(e) - g) * k
            for m, e, g, k in zip(mx, se, gs, masks)]


def loss_fn(L: Layout, W: Weights, tokens: list) -> tuple[Tensor, dict]:
    """``models.model.loss_fn`` over shards, for token models: the total
    (loss + 0.01 * moe_aux_loss) on the first position's device, from one
    copy of each data shard's NLL (:attr:`Layout.canon`), and the
    metrics."""
    cd = layers.cdtype(L.cfg)
    hs = embed(L, [e["table"] for e in W.part("embed")], tokens)
    hs, aux = run_blocks(L, W, [h.to(cd) for h in hs], remat=L.cfg.remat)
    lg = logits(L, W, hs)
    targets = [t[:, 1:] for t in tokens]
    masks = [torch.ones(t.shape, dtype=torch.float32, device=t.device)
             for t in targets]
    nll = cross_entropy(L, [x[:, :-1] for x in lg], targets, masks)
    dev0 = L.mesh.devices[0]
    nll_sum = sum(nll[i].sum().to(dev0) for i in L.canon)
    denom = torch.clamp(sum(masks[i].sum().to(dev0) for i in L.canon),
                        min=1.0)
    loss = nll_sum / denom
    total = loss + 0.01 * aux["moe_aux_loss"]
    return total, {"loss": loss, "tokens": denom, **aux}


def gather_rows(L: Layout, lg: list) -> Tensor:
    """Global (B, V) logits on the first position's device from
    per-position (b, V / vocab shards) blocks."""
    dev0 = L.mesh.devices[0]
    if L.head_vocab:
        lg = coll.all_gather(lg, L.mesh, L.head_vocab, lg[0].ndim - 1)
    return torch.cat([lg[i].to(dev0) for i in L.canon], 0)


def forward_cached(L: Layout, W: Weights, tokens: list, caches: list
                   ) -> Tensor:
    """Prefill (tokens (b, S) a position) or decode (b, 1) against
    per-position caches, written in place: the last position's global
    logits (B, V) on the first device."""
    pos0 = model_lib._cache_pos(caches[0]) if tokens[0].shape[1] == 1 \
        else 0
    hs = embed(L, [e["table"] for e in W.part("embed")], tokens)
    hs, _ = run_blocks(L, W, hs, pos0=pos0, caches=caches)
    lg = logits(L, W, [h[:, -1:] for h in hs])
    return gather_rows(L, [x[:, 0] for x in lg])


def init_caches(L: Layout, batch: int, max_len: int) -> list:
    """Per-position caches: the position's rows of the batch and its KV
    heads."""
    b = batch // L.mesh.count(L.dp) if L.dp else batch
    return pmap(L, lambda i: model_lib.init_caches(
        L.local, b, max_len, device=L.mesh.devices[i]))


__all__ = ["Layout", "Weights", "make_layout", "check_family", "reshard",
           "pmap", "embed", "moe_block", "block", "run_blocks", "logits",
           "cross_entropy", "loss_fn", "gather_rows", "forward_cached",
           "init_caches", "device_ctx"]
