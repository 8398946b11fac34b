"""The model over a mesh's shards: the forward, the training loss and the
serving steps of :mod:`repro_torch.models.model` for every family (the
dense decoders, MoE, recurrentgemma's RG-LRU and local attention, rwkv6,
the vision and audio frontends), one process driving every position of
a :class:`repro_torch.launch.mesh.Mesh` (the reference's single
controller, ``jax.jit`` over a mesh).

A sharded value is a list with one tensor a mesh position.  Every
position runs the single-device layers (:mod:`repro_torch.models.layers`)
on its own block of the parameters with a per-shard config
(:class:`Layout`: its heads, the KV heads they read, ``d_ff / tp``,
``lru_width / tp``), and the collectives of
:mod:`repro_torch.distributed.collectives` stand where the reference's
GSPMD puts them.  Under tensor parallelism (``layout="tp"``):

* column-parallel ``wq``/``wk``/``wv`` (and biases), ``up``/``gate``;
  row-parallel ``wo``/``down``, then an all-reduce over the
  tensor-parallel axis.  The parameters keep the reference's flat blocks
  of the ``h * hd`` axis; each rank attends on whole heads, ceil(h / tp)
  of them (:func:`head_ranges`): where the degree divides the heads these
  are its flat blocks, else (qwen2's 28 heads on 16 ranks) q is
  all-gathered and cut to the rank's heads and their output all-gathered
  and cut back to ``wo``'s row block.  KV heads the degree does not
  divide are replicated (``wk``/``wv`` whole), each rank cutting the KV
  heads its query heads read; its query heads attend in runs, one a KV
  head, or in one GQA call where they read its KV heads evenly;
* the RG-LRU: ``in_x``/``in_gate`` column-parallel, the conv, ``lambda``,
  the scan and ``h * gate`` on the shard's channels; ``w_r``/``w_i`` are
  dense maps of the whole conv output ``u``, so ``u`` is all-gathered
  over the axis before the gates (its backward a reduce-scatter);
  ``out`` row-parallel, then one all-reduce.  A decode state holds the
  shard's channels of ``h`` and of the conv's last inputs;
* rwkv6: heads split whole.  The time mix's ``wr``/``wk``/``wv``/``wg``
  column-parallel, ``w0``/``td_w2``/``u``/``ln_x`` cut to the shard's
  heads (the reference replicates them; the group norm is per head),
  ``wo`` row-parallel then an all-reduce; the WKV state ``S`` is kept
  per head (the reference keeps it whole over the axis, split by batch
  only).  Where the degree does not divide the heads (40 on 16 ranks)
  r, k, v and g are moved onto the rank's heads as q is, the per-head
  leaves stay whole and each rank reads its heads' part.  The channel mix: ``wk`` column-parallel, ``wv`` row-parallel
  on its ``d_ff`` rows (the compute layout of
  :func:`repro_torch.distributed.sharding.step_param_specs`; the
  reference stores it split on its output columns), its partial sums
  reduce-scattered over ``d``, multiplied by the shard's columns of the
  column-parallel receptance ``wr``, then all-gathered.  The token shift
  reads the replicated input and needs no communication;
* the embedding vocab-parallel: a masked lookup, then an all-reduce;
  a vocabulary the axis does not divide (internvl2's 92,553) stays whole;
* the head and cross-entropy vocab-parallel: the max and the sum of
  exponentials all-reduced, so the whole vocabulary's logits are never
  gathered in training;
* the frontends replicated (``frontend/proj``, ``conv_pos``); a vlm's
  patches and an audio batch's frames, targets and mask split over the
  data axes with the batch;
* the MoE block on the reference's ``shard_map`` path
  (``cfg.moe_dispatch == "shard_map"``): each shard routes and sorts its
  data shard's tokens over its own expert group and the partial outputs
  meet in one bf16 sum (:func:`repro_torch.models.moe.routed`); on the
  GSPMD path the tokens are gathered over the data axes, every shard
  routes all of them and runs its expert group, and the outputs are
  summed over the expert axis: the unsharded block's result.

Sequence parallelism, in the reference's two forms
(``repro_torch.partitioning.default_rules``):

* ``layout="sp"``: no tensor parallelism; each position holds its block
  of the sequence from the embedding to the head.  Attention all-gathers
  K and V over the sequence axis, its queries' causal mask, RoPE
  positions and local window offset by the block's start; norms and MLPs
  are local; the MoE block gathers its input's sequence and keeps its
  block of the output.  The recurrent blocks pass their carry across the
  sequence blocks in rank order: the RG-LRU's ``h`` and the conv's last
  ``w - 1`` inputs, rwkv6's shifted token and WKV state ``S``.  The audio
  frontend's ``conv_pos`` halo (the 127 frames before a block) is
  projected again from the frames every position holds.  The embedding
  and the head stay vocab-parallel: the lookup runs on the whole
  sequence and each position keeps its block; the last hidden states are
  all-gathered before the head.  A decode step's one token does not
  split: prefill leaves every position's caches the whole sequence's K/V
  and the final recurrent state (the reference puts nothing of the
  caches on the sequence axis), and decode runs replicated over it;
* ``sequence_parallel=True`` at ``layout="tp"`` (the train step only,
  as in the reference): Megatron-SP.  The residual stream stays split
  over the sequence between blocks; each block all-gathers its normed
  input's sequence before its column-parallel maps and reduce-scatters
  after its row-parallel ones, in place of the all-reduce.

Parameters arrive per position in the layout a step keeps them in
(:func:`repro_torch.distributed.sharding.step_param_specs`); a training
step's ZeRO-3 blocks (and rwkv6's compute cuts) are brought to the
compute layout where a layer uses them (inside the superblock's
recomputed region, so the backward gathers again).  Serving steps keep
their weights in the compute layout (prepared or not) and gather
nothing.  The unrolled tail (``n_layers`` not a multiple of the pattern:
recurrentgemma's 38 layers end in two RG-LRU blocks) runs after the
stack, as on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import functions as tina
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import kv_replicated
from repro_torch.launch.mesh import _names
from repro_torch.models import convert, layers, moe, rglru, rwkv6
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.partitioning import PartitionSpec
from repro_torch.tree import flatten_with_path, leaves, map_tree, unflatten

Tensor = torch.Tensor


def device_ctx(dev: torch.device):
    """The context a position's work runs in: its card current."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


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
    local: ModelConfig      # one shard's MLP / RG-LRU config
    heads: tuple            # per tensor-parallel rank: its (first, end)
                            # heads (attention's query heads, rwkv6's)
    kv: tuple               # per rank: the KV heads its query heads read
    kv_whole: bool          # wk/wv whole on every position (KV heads
                            # replicated): a position cuts its KV heads
    flat: bool              # the heads' ranges are not the flat column
                            # blocks the parameters are split in
    vocab: tuple            # the embedding table's vocab axes
    head_vocab: tuple       # the head's (== vocab for a tied head)
    expert: tuple           # the experts' axes
    ep: bool                # the reference's shard_map dispatch
    canon: list             # one position a data shard, in rank order
    seq: tuple = ()         # the sequence's axes (sequence parallelism)

    @property
    def tp_size(self) -> int:
        return self.mesh.count(self.tp)

    @property
    def sp(self) -> bool:
        """``layout="sp"``: the blocks run on sequence blocks."""
        return bool(self.seq) and not self.tp

    @property
    def megatron(self) -> bool:
        """Megatron-SP: the sequence split between blocks only."""
        return bool(self.seq) and bool(self.tp)

    def rank(self, i: int, axes) -> int:
        return self.mesh.rank(i, axes)

    def head_range(self, i: int) -> tuple[int, int]:
        """Position ``i``'s heads, (first, end)."""
        return self.heads[self.rank(i, self.tp)]

    def kv_range(self, i: int) -> tuple[int, int]:
        """The KV heads position ``i``'s query heads read, (first, end)."""
        return self.kv[self.rank(i, self.tp)]

    def attn_cfg(self, i: int) -> ModelConfig:
        """Position ``i``'s attention config: its query and KV heads."""
        return self._attn_cfgs[self.rank(i, self.tp)]

    @functools.cached_property
    def _attn_cfgs(self) -> list:
        return [self.cfg.scaled(n_heads=hi - lo, n_kv_heads=khi - klo)
                for (lo, hi), (klo, khi) in zip(self.heads, self.kv)]

    def runs(self, i: int) -> list:
        """Position ``i``'s query heads by the KV head they read: (first,
        end, KV head), each local to the position; one run of all its
        heads where they read its KV heads evenly, in order (one GQA
        attention call serves them)."""
        return self._runs[self.rank(i, self.tp)]

    @functools.cached_property
    def _runs(self) -> list:
        g = self.cfg.n_heads // max(self.cfg.n_kv_heads, 1)
        out = []
        for (lo, hi), (klo, khi) in zip(self.heads, self.kv):
            rs = []
            for j in range(lo, hi):
                if rs and rs[-1][2] == j // g - klo:
                    rs[-1][1] += 1
                else:
                    rs.append([j - lo, j - lo + 1, j // g - klo])
            if rs and all(b - a == rs[0][1] - rs[0][0] for a, b, _ in rs):
                rs = [[0, hi - lo, None]]
            out.append([tuple(r) for r in rs])
        return out

    def splits(self, s: int) -> bool:
        """Whether a sequence of ``s`` positions splits over the sequence
        axes (a decode step's one token does not); ValueError where they
        do not divide it."""
        n = self.mesh.count(self.seq)
        if n == 1 or s == 1:
            return False
        if s % n:
            raise ValueError(f"sharded steps: a sequence of {s} positions "
                             f"over {n} sequence shards")
        return True


def head_ranges(h: int, n: int) -> tuple:
    """The heads of each of ``n`` tensor-parallel ranks: ceil(h / n) a
    rank in order, the last ranks holding fewer or none (GSPMD's padded
    split of a head axis)."""
    c = -(-h // n)
    return tuple((min(r * c, h), min((r + 1) * c, h)) for r in range(n))


def make_layout(cfg: ModelConfig, mesh, rules: dict, compute_specs
                ) -> Layout:
    """The :class:`Layout` of ``cfg`` on ``mesh``; ``compute_specs`` are
    the parameters' compute-layout specs (their vocab and expert axes).

    Tensor parallelism splits every column- and row-parallel width into
    equal flat blocks, as the reference does; each rank's heads are
    :func:`head_ranges`' (the flat blocks themselves when the degree
    divides the head count).  Raises ValueError naming the width where
    the degree does not divide one (the reference's ``legalize``
    replicates such a leaf; no step here runs a column- or row-parallel
    map on a replicated leaf)."""
    shape = mesh.shape
    dp = tuple(a for a in _names(rules.get("batch")) if a in shape)
    tp = tuple(a for a in _names(rules.get("tp")) if a in shape)
    seq = tuple(a for a in _names(rules.get("seq")) if a in shape)
    n = mesh.count(tp)
    rwkv = "rwkv" in cfg.block_pattern
    h = cfg.d_model // cfg.rwkv_head_size if rwkv else cfg.n_heads
    hs = cfg.rwkv_head_size if rwkv else cfg.head_dim
    lru = cfg.lru_width or cfg.d_model
    if n > 1:
        widths = {"d_ff": cfg.d_ff, "heads' flat columns (h * head_dim)":
                  h * hs}
        if cfg.moe:
            widths.update({"shared expert d_ff":
                           cfg.d_ff * cfg.shared_experts,
                           "dense_residual_ff": cfg.dense_residual_ff})
        if "rglru" in cfg.block_pattern:
            widths["lru_width"] = lru
        bad = {k: v for k, v in widths.items() if v % n}
        if bad:
            raise ValueError(
                f"sharded steps: {cfg.name} on {n}-way tensor parallelism: "
                f"{bad} do not split {n} ways (the reference's legalize "
                "replicates such a leaf; a column- or row-parallel map "
                "here needs its block)")
    heads = head_ranges(h, n)
    g = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    kv = heads if rwkv else tuple(
        (lo // g, (hi - 1) // g + 1) if hi > lo else (lo // g, lo // g)
        for lo, hi in heads)
    local = cfg.scaled(d_ff=cfg.d_ff // n,
                       lru_width=lru // n if cfg.lru_width else None)
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
    if seq and tp and seq != tp:
        raise ValueError(f"sharded steps: Megatron-SP splits the sequence "
                         f"over the tensor-parallel axes {tp}, not {seq}")
    others = [a for a in mesh.axes if a not in dp]
    canon = sorted((i for i in range(mesh.size)
                    if all(mesh.coords(i)[a] == 0 for a in others)),
                   key=lambda i: mesh.rank(i, dp))
    return Layout(cfg, mesh, rules, dp, tp, local, heads, kv,
                  not rwkv and kv_replicated(cfg, mesh, rules),
                  h % n != 0, vocab, head_vocab, expert, ep, canon,
                  seq if mesh.count(seq) > 1 else ())


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
    moved = [(dim, s, c) for dim, (s, c) in enumerate(zip(src, dst))
             if s != c]
    for dim, s, _ in moved:       # every gather before any cut: a block
        if s is not None:         # cut first would gather others' rows
            xs = coll.all_gather(xs, mesh, s, dim, grad_dtype=grad_dtype)
    for dim, _, c in moved:
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

    def tail(self, j: int) -> list:
        """Block ``j`` of the unrolled tail, per position."""
        subs = [v["tail"][j] for v in self.views]
        if self.store is None:
            return subs
        return self._to_compute(subs, self.store["tail"][j],
                                self.compute["tail"][j])


_AT = threading.local()     # the position pmap runs: its work's card


def position() -> Optional[int]:
    """The mesh position whose work runs now (inside :func:`pmap` or a
    rank-order pass), else None; the dry-run charges that work to it."""
    return getattr(_AT, "i", None)


@contextlib.contextmanager
def at(i: int, dev: torch.device):
    """Position ``i``'s work: its device current, :func:`position` i."""
    _AT.i = i
    try:
        with device_ctx(dev):
            yield
    finally:
        _AT.i = None


def pmap(L: Layout, fn, *lists) -> list:
    """``fn(i, *items)`` at every position, each under its device."""
    out = []
    for i, dev in enumerate(L.mesh.devices):
        with at(i, dev):
            out.append(fn(i, *(lst[i] for lst in lists)))
    return out


# ---------------------------------------------------------------------------
# layers over shards
# ---------------------------------------------------------------------------
def _kv_block(p: dict, lo: int, hi: int, hd: int) -> dict:
    """A whole ``wk``/``wv``'s columns (its K-major copy's rows) of KV
    heads ``lo`` to ``hi``."""
    out = {"w": p["w"].narrow(1, lo * hd, (hi - lo) * hd)}
    if "b" in p:
        out["b"] = p["b"].narrow(0, lo * hd, (hi - lo) * hd)
    if "wt" in p:
        out["wt"] = p["wt"].narrow(0, lo * hd, (hi - lo) * hd)
    return out


def _to_heads(L: Layout, xs: list, hs: int) -> list:
    """Flat column blocks (last dim) into each position's head range of
    ``hs``-wide heads: gathered over the tensor-parallel axes, then cut
    (the backward reduce-scatters)."""
    whole = coll.all_gather(xs, L.mesh, L.tp, -1)
    out = []
    for i, x in enumerate(whole):
        lo, hi = L.head_range(i)
        out.append(x.narrow(-1, lo * hs, (hi - lo) * hs))
    return out


def _to_flat(L: Layout, xs: list, hs: int) -> list:
    """Each position's heads (last dim) into its flat column block, the
    rows of its row-parallel block: zero-padded to the ranks' common
    head count, gathered, cut; contiguous, as the GEMM kernels read."""
    c = L.heads[0][1] - L.heads[0][0]
    pad = [F.pad(x, (0, c * hs - x.shape[-1])) for x in xs]
    whole = coll.all_gather(pad, L.mesh, L.tp, -1)
    w = L.heads[-1][1] * hs // L.tp_size
    return [x.narrow(-1, L.rank(i, L.tp) * w, w).contiguous()
            for i, x in enumerate(whole)]


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


def _gather_seq(L: Layout, xs: list) -> list:
    """The whole sequence (dim 1) on every position of a sequence group."""
    return coll.all_gather(xs, L.mesh, L.seq, 1)


def _seq_block(L: Layout, xs: list) -> list:
    """Each position's block of a sequence (dim 1) it holds whole."""
    n = L.mesh.count(L.seq)
    return [x.narrow(1, L.rank(i, L.seq) * (x.shape[1] // n),
                     x.shape[1] // n) for i, x in enumerate(xs)]


def _enter(L: Layout, zs: list, split: bool) -> list:
    """A block's normed input in the layout its maps read: Megatron-SP
    all-gathers the sequence."""
    return _gather_seq(L, zs) if L.megatron and split else zs


def _leave(L: Layout, hs: list, split: bool) -> list:
    """Row-parallel partial sums into the residual stream's layout: the
    all-reduce over the tensor-parallel axis, or under Megatron-SP the
    reduce-scatter over the sequence."""
    if L.megatron and split:
        return coll.reduce_scatter(hs, L.mesh, L.tp, 1)
    return _tp_sum(L, hs)


def _in_rank_order(L: Layout, fn, first, *lists) -> tuple[list, list]:
    """``fn(i, carry, *items) -> (out, carry)`` along each sequence group
    in rank order, the carry (a tuple of tensors) passed from block to
    block; ``first(i)`` is the first block's.  Returns the outputs and,
    at every position, its group's last carry."""
    mesh = L.mesh
    out, last = [None] * mesh.size, [None] * mesh.size
    for g in mesh.groups(L.seq):
        carry = None
        for i in g:
            dev = mesh.devices[i]
            with at(i, dev):
                c = first(i) if carry is None else \
                    tuple(t.to(dev) for t in carry)
                out[i], carry = fn(i, c, *(lst[i] for lst in lists))
        for i in g:
            last[i] = tuple(t.to(mesh.devices[i]) for t in carry)
    return out, last


def _norm(L: Layout, ps: list, key: str, xs: list) -> list:
    return pmap(L, lambda i, p, x: layers.norm(p[key], x, L.cfg), ps, xs)


def _kv_weights(L: Layout, i: int, pa: dict) -> dict:
    """Position ``i``'s attention parameters, ``wk``/``wv`` cut to its KV
    heads where they are whole (:attr:`Layout.kv_whole`)."""
    if not L.kv_whole:
        return pa
    klo, khi = L.kv_range(i)
    hd = L.cfg.head_dim
    return {**pa, "wk": _kv_block(pa["wk"], klo, khi, hd),
            "wv": _kv_block(pa["wv"], klo, khi, hd)}


def _attend(L: Layout, i: int, q: Tensor, k: Tensor, v: Tensor,
            c: Optional[dict], pos0: int) -> Tensor:
    """Position ``i``'s attention of rope'd ``q`` (B, S, its heads, hd)
    over ``k``/``v`` (its KV heads), a cache written in place
    (``layers.write_cache``); each run of query heads against the KV head
    it reads (:meth:`Layout.runs`)."""
    decode_pos = None
    if c is not None:
        k, v, decode_pos = layers.write_cache(c, k, v)

    def core(qj, kj, vj):
        return layers.attend(qj, kj, vj, L.cfg, window=L.cfg.local_window,
                             q_offset=pos0 if c is not None else 0,
                             decode_pos=decode_pos)
    runs = L.runs(i)
    if runs[0][2] is None:
        return core(q, k, v)
    return torch.cat([core(q[:, :, a:b], k[:, :, j:j + 1], v[:, :, j:j + 1])
                      for a, b, j in runs], 2)


def _attention(L: Layout, ps: list, zs: list, ctx: list,
               caches: Optional[list], sp: bool) -> list:
    """The attention sublayer's output (partial sums under TP).  ``sp``:
    each position's queries are its sequence block, K and V are
    all-gathered over the sequence axes, and a cache takes the whole
    sequence's.  Where a position's heads are not its flat column
    blocks (:attr:`Layout.flat`), q is gathered and cut to them, and the
    heads' output gathered and cut back to the row block of ``wo``; where
    its query heads read its KV heads unevenly, each run attends apart
    (:meth:`Layout.runs`)."""
    cfg, hd = L.cfg, L.cfg.head_dim
    caches = caches or [None] * len(zs)

    if not sp:
        def proj(i, p, z):
            pa = _kv_weights(L, i, p["attn"])
            lo, hi = L.head_range(i)
            q = layers.linear(pa["wq"], z, cfg)
            if hi == lo:
                return q, None, None
            return (q, layers.linear(pa["wk"], z, cfg),
                    layers.linear(pa["wv"], z, cfg))
        out = pmap(L, proj, ps, zs)
        qs = [o[0] for o in out]
        if L.flat:
            qs = _to_heads(L, qs, hd)

        def attend(i, q, o, c):
            (lo, hi), (klo, khi) = L.head_range(i), L.kv_range(i)
            b, s = q.shape[:2]
            if hi == lo:
                if c is not None:
                    c["pos"] = c["pos"] + s
                return q
            positions, pos0, angles = ctx[i]
            q = layers.rope(q.reshape(b, s, hi - lo, hd), positions, cfg,
                            angles=angles)
            k = layers.rope(o[1].reshape(b, s, khi - klo, hd), positions,
                            cfg, angles=angles)
            a = _attend(L, i, q, k, o[2].reshape(b, s, khi - klo, hd), c,
                        pos0)
            return a.reshape(b, s, (hi - lo) * hd)
        hs = pmap(L, attend, qs, out, caches)
        if L.flat:
            hs = _to_flat(L, hs, hd)
        return pmap(L, lambda i, p, h: layers.linear(p["attn"]["wo"], h,
                                                     cfg), ps, hs)

    lc = L.attn_cfg(0)
    out = pmap(L, lambda i, p, z: layers.qkv(
        p["attn"], z, lc, positions=ctx[i][0], angles=ctx[i][2]), ps, zs)
    ks = _gather_seq(L, [o[1] for o in out])
    vs = _gather_seq(L, [o[2] for o in out])

    def attend(i, p, o, k, v, c):
        q = o[0]
        b, s = q.shape[:2]
        if c is not None:
            layers.write_cache(c, k, v)
        a = layers.attend(q, k, v, cfg, window=cfg.local_window,
                          q_offset=ctx[i][1])
        return layers.linear(p["attn"]["wo"],
                             a.reshape(b, s, lc.n_heads * hd), lc)
    return pmap(L, attend, ps, out, ks, vs, caches)


def _ffn(L: Layout, ps: list, xs: list, split: bool) -> tuple[list, dict]:
    """The second sublayer of an attention or RG-LRU block: the MLP, or
    the MoE block on the whole sequence of each data shard."""
    zs = _norm(L, ps, "ln2", xs)
    aux: dict = {}
    if L.cfg.moe:
        whole = _gather_seq(L, zs) if split else zs
        hs, aux = moe_block(L, [p["ffn"] for p in ps], whole)
        if split:
            hs = _seq_block(L, hs)
    else:
        hs = _leave(L, pmap(L, lambda i, p, z: layers.mlp(
            p["ffn"], z, L.local), ps, _enter(L, zs, split)), split)
    return [x + h for x, h in zip(xs, hs)], aux


def _conv_taps(p: dict, xb: Tensor) -> Tensor:
    return p["conv_taps"].to(xb.dtype)


def _rglru(L: Layout, ps: list, zs: list, states: Optional[list],
           sp: bool) -> list:
    """The RG-LRU sublayer's output (partial sums under TP): ``ps`` the
    blocks' ``rec`` parameters, ``states`` written in place (prefill
    leaves the last h and conv inputs of the whole sequence, decode
    advances them)."""
    cfg = L.cfg
    decode = states is not None and zs[0].shape[1] == 1
    low = rglru.fir_lowering(cfg)

    def front(i, p, z):
        gate = F.gelu(layers.linear(p["in_gate"], z, cfg),
                      approximate="tanh")
        return gate, layers.linear(p["in_x"], z, cfg)
    fr = pmap(L, front, ps, zs)
    xbs = [f[1] for f in fr]
    w = cfg.conv_width
    if decode:
        wins = pmap(L, lambda i, st, xb: torch.cat([st["conv"], xb], 1),
                    states, xbs)
        us = pmap(L, lambda i, p, win: torch.einsum(
            "bwl,wl->bl", win, _conv_taps(p, win))[:, None], ps, wins)
    elif sp:
        def conv(i, carry, p, xb):
            ext = torch.cat([carry[0], xb], 1)
            u = tina.depthwise_fir(ext, _conv_taps(p, xb), causal=True,
                                   lowering=low)[:, w - 1:]
            return u, (ext[:, -(w - 1):],)
        us, halos = _in_rank_order(
            L, conv, lambda i: (xbs[i].new_zeros(
                (xbs[i].shape[0], w - 1, xbs[i].shape[2])),), ps, xbs)
    else:
        us = pmap(L, lambda i, p, xb: tina.depthwise_fir(
            xb, _conv_taps(p, xb), causal=True, lowering=low), ps, xbs)
    u_all = coll.all_gather(us, L.mesh, L.tp, -1) if L.tp_size > 1 else us
    ab = pmap(L, lambda i, p, u, ua: rglru._gates(p, u, cfg, ua), ps, us,
              u_all)
    if decode:
        def step(i, st, g, win):
            a, b = g
            h = a[:, 0] * st["h"] + b[:, 0]
            st["h"].copy_(h)
            st["conv"].copy_(win[:, 1:])
            return h[:, None]
        hs = pmap(L, step, states, ab, wins)
    elif sp:
        def scan(i, carry, g):
            h = rglru.linear_scan(*g, carry[0])
            return h, (h[:, -1],)
        hs, lasts = _in_rank_order(
            L, scan, lambda i: (ab[i][0].new_zeros(ab[i][0].shape[::2]),),
            ab)
        if states is not None:
            for st, h, c in zip(states, lasts, halos):
                st["h"].copy_(h[0])
                st["conv"].copy_(c[0])
    else:
        hs = pmap(L, lambda i, g: rglru.linear_scan(*g), ab)
        if states is not None:
            for st, h, xb in zip(states, hs, xbs):
                st["h"].copy_(h[:, -1])
                st["conv"].copy_(xb[:, -(w - 1):])
    return pmap(L, lambda i, p, h, f, z: layers.linear(
        p["out"], h.to(z.dtype) * f[0], cfg), ps, hs, fr, zs)


def _prevs(L: Layout, zs: list, states: Optional[list], key: str,
           sp: bool) -> tuple[list, list]:
    """Each position's token before its block (None: zero) for the
    token shift, and, under ``sp``, its group's last token."""
    if not sp:
        prevs = [None] * len(zs) if states is None else \
            [st[key] for st in states]
        return prevs, [z[:, -1] for z in zs]
    first = (lambda i: (states[i][key],)) if states is not None else \
        (lambda i: (zs[i].new_zeros(zs[i][:, 0].shape),))
    prevs, lasts = _in_rank_order(
        L, lambda i, c, z: (c[0], (z[:, -1],)), first, zs)
    return prevs, [t[0] for t in lasts]


def _time_mix(L: Layout, ps: list, zs: list, states: Optional[list],
              sp: bool) -> list:
    """rwkv6's time mix (partial sums under TP) from the blocks' ``tm``
    parameters (cut to the shard's heads); ``sp``: the shifted token and
    the WKV state passed along the sequence blocks in rank order."""
    cfg = L.cfg
    if L.flat:
        return _time_mix_flat(L, ps, zs, states)
    prevs, lasts = _prevs(L, zs, states, "x_tm", sp)
    if sp:
        first = (lambda i: (states[i]["S"],)) if states is not None \
            else (lambda i: (None,))

        def mix(i, carry, p, z, prev):
            out, s_new = rwkv6.mix_core(p, z, cfg, prev, carry[0])
            return out, (s_new,)
        outs, finals = _in_rank_order(L, mix, first, ps, zs, prevs)
        finals = [f[0] for f in finals]
    else:
        res = pmap(L, lambda i, p, z, prev, st: rwkv6.mix_core(
            p, z, cfg, prev, None if st is None else st["S"]), ps, zs,
            prevs, states or [None] * len(zs))
        outs, finals = [r[0] for r in res], [r[1] for r in res]
    if states is not None:
        for st, s_new, last in zip(states, finals, lasts):
            st["S"].copy_(s_new)
            st["x_tm"].copy_(last)
    return outs


def _time_mix_flat(L: Layout, ps: list, zs: list, states: Optional[list]
                   ) -> list:
    """The time mix where the tensor-parallel degree does not divide the
    heads: ``wr``/``wk``/``wv``/``wg`` column-parallel on flat blocks,
    their outputs gathered and cut to the position's heads
    (:func:`_to_heads`); the decay from ``td_w2``'s and ``w0``'s columns
    of those heads, the scan, group norm (``u``, ``ln_x`` cut to them)
    and gate on them; the gated output cut back to ``wo``'s row block
    (:func:`_to_flat`).  A position without heads runs the linears only.
    The per-head leaves arrive whole (the reference replicates them)."""
    cfg, hs = L.cfg, L.cfg.rwkv_head_size
    prevs, lasts = _prevs(L, zs, states, "x_tm", False)

    def inputs(i, p, z, prev):
        lo, hi = L.head_range(i)
        return rwkv6.mix_inputs(p, z, cfg, prev, cols=(lo * hs, hi * hs))
    ins = pmap(L, inputs, ps, zs, prevs)
    r, k, v, g = (_to_heads(L, [t[j] for t in ins], hs) for j in range(4))

    def heads(i, p, z, r, k, v, g, t, st):
        lo, hi = L.head_range(i)
        if hi == lo:
            return g, None
        return rwkv6.mix_heads(p, r, k, v, t[4], g, cfg,
                               None if st is None else st["S"], z.dtype,
                               heads=(lo, hi))
    res = pmap(L, heads, ps, zs, r, k, v, g, ins,
               states or [None] * len(zs))
    outs = _to_flat(L, [o for o, _ in res], hs)
    if states is not None:
        for st, (_, s_new), last in zip(states, res, lasts):
            if s_new is not None:
                st["S"].copy_(s_new)
            st["x_tm"].copy_(last)
    return pmap(L, lambda i, p, o: layers.linear(p["wo"], o, cfg), ps, outs)


def _channel_mix(L: Layout, ps: list, zs: list, states: Optional[list],
                 sp: bool) -> list:
    """rwkv6's channel mix, whole (replicated over the tensor-parallel
    axis): under TP the value map's partial sums reduce-scattered over
    ``d``, gated by the shard's receptance columns, then all-gathered."""
    cfg = L.cfg
    prevs, lasts = _prevs(L, zs, states, "x_cm", sp)

    def mix(i, p, x, prev):
        xx = rwkv6._shift(x, cfg, prev) - x
        xk = x + xx * p["mu_k"].to(x.dtype)
        xr = x + xx * p["mu_r"].to(x.dtype)
        kk = torch.square(F.relu(layers.linear(p["wk"], xk, cfg)))
        return (torch.sigmoid(layers.linear(p["wr"], xr, cfg)),
                layers.linear(p["wv"], kk, cfg))
    out = pmap(L, mix, ps, zs, prevs)
    if L.tp_size > 1:
        kv = coll.reduce_scatter([o[1] for o in out], L.mesh, L.tp, -1)
        ys = coll.all_gather([o[0] * v for o, v in zip(out, kv)], L.mesh,
                             L.tp, -1)
    else:
        ys = [r * v for r, v in out]
    if states is not None:
        for st, last in zip(states, lasts):
            st["x_cm"].copy_(last)
    return ys


def block(L: Layout, kind: str, ps: list, xs: list, ctx: list,
          caches: Optional[list], split: bool = False) -> tuple[list, dict]:
    """One block of ``kind`` (``attn``: attention, then the MLP or MoE
    block; ``rglru``: the RG-LRU, then the MLP; ``rwkv``: the time and
    channel mix) over shards.  ``ctx``: each position's (positions,
    first position, rope angles); ``split``: the residual stream holds
    sequence blocks (sequence parallelism).  Caches are written in
    place."""
    sp = L.sp and split
    zs = _enter(L, _norm(L, ps, "ln1", xs), split)
    if kind == "rwkv":
        tm = [p["tm"] for p in ps]
        cm = [p["cm"] for p in ps]
        hs = _leave(L, _time_mix(L, tm, zs, caches, sp), split)
        xs = [x + h for x, h in zip(xs, hs)]
        zs = _enter(L, _norm(L, ps, "ln2", xs), split)
        hs = _channel_mix(L, cm, zs, caches, sp)
        if L.megatron and split:
            hs = _seq_block(L, hs)
        return [x + h for x, h in zip(xs, hs)], {}
    if kind == "rglru":
        hs = _rglru(L, [p["rec"] for p in ps], zs, caches, sp)
    else:
        hs = _attention(L, ps, zs, ctx, caches, sp)
    hs = _leave(L, hs, split)
    return _ffn(L, ps, [x + h for x, h in zip(xs, hs)], split)


def _rope_ctx(L: Layout, b: int, s: int, pos0: int, sp: bool) -> list:
    """Each position's (positions (b, s), first position, rope angles):
    from ``pos0``, offset by the position's sequence block under ``sp``."""
    made: dict = {}
    out = []
    for i, dev in enumerate(L.mesh.devices):
        start = pos0 + (L.rank(i, L.seq) * s if sp else 0)
        if (dev, start) not in made:
            with device_ctx(dev):
                positions = (start + torch.arange(
                    s, dtype=torch.int32, device=dev)).expand(b, s)
                made[dev, start] = (positions, start,
                                    layers.rope_angles(positions, L.cfg))
        out.append(made[dev, start])
    return out


def run_blocks(L: Layout, W: Weights, xs: list, *, pos0: int = 0,
               caches: Optional[list] = None, remat: bool = False,
               split: bool = False) -> tuple[list, dict]:
    """The stack, then the tail, over shards; the MoE statistics summed
    in layer order on the first position's device.  Without caches and
    with autograd on, each superblock is recomputed in the backward
    (:class:`_Remat`) where ``remat``, as the single-device stack's
    ``torch.utils.checkpoint`` does.  ``split``: ``xs`` are sequence
    blocks (:meth:`Layout.splits`)."""
    cfg = L.cfg
    pat, reps, tail = model_lib._pattern_layout(cfg)
    b, s = xs[0].shape[:2]
    sp = L.sp and split
    ctx = _rope_ctx(L, b, s * (L.mesh.count(L.seq) if L.megatron and split
                               else 1), pos0, sp)
    dev0 = L.mesh.devices[0]
    zero = lambda: torch.zeros((), dtype=torch.float32, device=dev0)

    def add(aux, a):
        for key in model_lib.AUX_KEYS:
            if key in a:
                aux[key] = aux[key] + a[key].to(dev0)

    def run(rs, parts, *xs):
        """Repeats ``rs`` of the stack; ``parts[j]``: repeat rs[j] as each
        position keeps it."""
        xs = list(xs)
        aux = {k: zero() for k in model_lib.AUX_KEYS}
        for r, part in zip(rs, parts):
            for i_sub, kind in enumerate(pat):
                name = f"sub{i_sub}"
                cs = None if caches is None else \
                    [c["stack"][r][name] for c in caches]
                xs, a = block(L, kind, W.block(r, name, part), xs, ctx, cs,
                              split)
                add(aux, a)
        return (*xs, *[aux[k] for k in model_lib.AUX_KEYS])

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
    for j, kind in enumerate(tail):
        cs = None if caches is None else [c["tail"][j] for c in caches]
        xs, a = block(L, kind, W.tail(j), xs, ctx, cs, split)
        add(aux, a)
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


def _audio_frontend(L: Layout, ps: list, frames: list, split: bool
                    ) -> list:
    """``models.model.apply_frontend`` of an audio batch; ``split``: each
    position's block of the sequence, its ``conv_pos`` halo (the
    ``AUDIO_CONV_POS_WIDTH - 1`` frames before the block) projected
    again from the frames it holds."""
    cfg = L.cfg
    if not split:
        return pmap(L, lambda i, p, f: model_lib.apply_frontend(p, f, cfg),
                    ps, frames)
    n = L.mesh.count(L.seq)
    w = model_lib.AUDIO_CONV_POS_WIDTH

    def local(i, p, f):
        blk = f.shape[1] // n
        start = L.rank(i, L.seq) * blk
        lo = max(0, start - (w - 1))
        h = layers.linear(p["proj"], f[:, lo:start + blk].to(
            layers.cdtype(cfg)), cfg)
        pos = tina.depthwise_fir(h, p["conv_pos"].to(h.dtype), causal=True,
                                 lowering=rglru.fir_lowering(cfg))
        return (h + F.gelu(pos, approximate="tanh"))[:, start - lo:]
    return pmap(L, local, ps, frames)


def embed_inputs(L: Layout, W: Weights, batch: dict) -> tuple[list, bool]:
    """Each position's hidden states of its data shard's ``batch`` (a
    dict of per-position lists): the patches' projections before the
    tokens' embeddings (vision), the frames' (audio) or the tokens'.
    Returns them and whether they are sequence blocks
    (:meth:`Layout.splits`)."""
    cfg = L.cfg
    if cfg.frontend == "audio_stub":
        split = L.splits(batch["frames"][0].shape[1])
        return _audio_frontend(L, W.part("frontend"), batch["frames"],
                               split), split
    hs = embed(L, [e["table"] for e in W.part("embed")], batch["tokens"])
    if "patch_embeds" in batch:
        patches = pmap(L, lambda i, p, f: model_lib.apply_frontend(p, f, cfg),
                       W.part("frontend"), batch["patch_embeds"])
        hs = [torch.cat([a, h], 1) for a, h in zip(patches, hs)]
    split = L.splits(hs[0].shape[1])
    return (_seq_block(L, hs) if split else hs), split


def _targets(cfg: ModelConfig, batch: dict, i: int):
    """Position ``i``'s (first, last) logits the loss reads, its targets
    and mask: ``models.model.loss_fn``'s slices."""
    if cfg.frontend == "audio_stub":
        return 0, None, batch["targets"][i], batch["mask"][i].float()
    tokens = batch["tokens"][i]
    first = batch["patch_embeds"][i].shape[1] \
        if cfg.frontend == "vision_stub" else 0
    targets = tokens[:, 1:]
    return first, -1, targets, torch.ones(targets.shape, dtype=torch.float32,
                                          device=targets.device)


def loss_fn(L: Layout, W: Weights, batch: dict) -> tuple[Tensor, dict]:
    """``models.model.loss_fn`` over shards: ``batch`` a dict of
    per-position lists (each its data shard's rows, the whole sequence).
    The total (loss + 0.01 * moe_aux_loss) on the first position's
    device, from one copy of each data shard's NLL
    (:attr:`Layout.canon`), and the metrics."""
    cd = layers.cdtype(L.cfg)
    hs, split = embed_inputs(L, W, batch)
    hs, aux = run_blocks(L, W, [h.to(cd) for h in hs], remat=L.cfg.remat,
                         split=split)
    if split:
        hs = _gather_seq(L, hs)
    lg = logits(L, W, hs)
    parts = [_targets(L.cfg, batch, i) for i in range(L.mesh.size)]
    nll = cross_entropy(L, [x[:, a:b] for x, (a, b, _, _) in zip(lg, parts)],
                        [t for _, _, t, _ in parts],
                        [m for _, _, _, m in parts])
    dev0 = L.mesh.devices[0]
    sums = [(nll[i].sum(), parts[i][3].sum()) for i in L.canon]
    with coll.glue():
        nll_sum = sum(a.to(dev0) for a, _ in sums)
        denom = torch.clamp(sum(b.to(dev0) for _, b in sums), min=1.0)
        loss = nll_sum / denom
        total = loss + 0.01 * aux["moe_aux_loss"]
    return total, {"loss": loss, "tokens": denom, **aux}


def gather_rows(L: Layout, lg: list) -> Tensor:
    """Global (B, V) logits on the first position's device from
    per-position (b, V / vocab shards) blocks."""
    dev0 = L.mesh.devices[0]
    if L.head_vocab:
        lg = coll.all_gather(lg, L.mesh, L.head_vocab, lg[0].ndim - 1)
    with coll.glue():
        return torch.cat([lg[i].to(dev0) for i in L.canon], 0)


def forward_cached(L: Layout, W: Weights, batch: dict, caches: list
                   ) -> Tensor:
    """Prefill (``batch`` a dict of per-position lists: a position's data
    shard's prompt) or decode (``{"tokens": (b, 1) a position}``) against
    per-position caches, written in place: the last position's global
    logits (B, V) on the first device."""
    decode = set(batch) == {"tokens"} and batch["tokens"][0].shape[1] == 1
    pos0 = model_lib._cache_pos(caches[0]) if decode else 0
    hs, split = embed_inputs(L, W, batch)
    hs, _ = run_blocks(L, W, hs, pos0=pos0, caches=caches, split=split)
    last = [h[:, -1:] for h in hs]
    if split:
        last = [x[:, -1:] for x in _gather_seq(L, last)]
    lg = logits(L, W, last)
    return gather_rows(L, [x[:, 0] for x in lg])


def _block_cache(L: Layout, i: int, kind: str, b: int, max_len: int
                 ) -> dict:
    """A block's cache on position ``i``: its KV heads, its RG-LRU
    channels, its rwkv6 heads (the WKV state per head; the shifted
    tokens whole)."""
    dev = L.mesh.devices[i]
    if kind == "attn":
        return model_lib.init_block_cache(L.attn_cfg(i), kind, b, max_len,
                                          dev)
    if kind != "rwkv":
        return model_lib.init_block_cache(L.local, kind, b, max_len, dev)
    st = rwkv6.init_rwkv_state(L.cfg, b, device=dev)
    lo, hi = L.head_range(i)
    st["S"] = st["S"][:, lo:hi].contiguous()
    return st


def init_caches(L: Layout, batch: int, max_len: int) -> list:
    """Per-position caches: the position's rows of the batch, and its
    heads or channels under tensor parallelism; whole over the sequence
    axes (sequence parallelism)."""
    b = batch // L.mesh.count(L.dp) if L.dp else batch
    pat, reps, tail = model_lib._pattern_layout(L.cfg)

    def make(i):
        return {"stack": [{f"sub{j}": _block_cache(L, i, kind, b, max_len)
                           for j, kind in enumerate(pat)}
                          for _ in range(reps)],
                "tail": [_block_cache(L, i, kind, b, max_len)
                         for kind in tail]}
    return pmap(L, lambda i: make(i))


__all__ = ["Layout", "Weights", "make_layout", "head_ranges", "reshard", "pmap", "embed",
           "moe_block", "block", "run_blocks", "logits", "cross_entropy",
           "embed_inputs", "loss_fn", "gather_rows", "forward_cached",
           "init_caches", "device_ctx", "position", "at"]
