"""Carry the reference's weights across: the tree that
``repro.models.model.init_model`` returns, as numpy arrays, into the
port's parameters (:func:`repro_torch.models.model.init_model`'s layout).

The reference stacks its superblocks over the repeats with ``jax.vmap``
(every leaf of ``params["stack"]`` has a leading axis of length
``n_layers // len(block_pattern)``); the port keeps one dict per repeat.
Every other leaf maps across as it is: the tied ``embed.table``, the
untied ``head.w``, the norms, the tail, the ``frontend`` subtree, the
experts' (E, d, f) stacks and router, rglru's ``lambda`` and
``conv_taps``, rwkv's ``mu_*``, ``mix_w*``, ``td_w*``, ``u`` and
``ln_x``.  bfloat16 leaves (numpy's ml_dtypes) keep their bits.

The **training layout** is the reference's own: each leaf of
``params["stack"]`` one tensor with the repeat axis first (no ``stack``
key when there are no repeats).  The train step holds parameters,
gradients and optimizer state in it, so that every optimizer rule that
reads a leaf's shape (AdamW's decay of leaves of 2 or more axes,
Adafactor's factoring and per-leaf RMS), the clip norm and the
checkpoint keys see the reference's leaves; the forward reads it through
:func:`unstack_views`, views of each repeat (no copy), and autograd
gathers every repeat's gradient into the stacked leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.tree import flatten_with_path, map_tree, unflatten


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(t, device: torch.device):
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree(v, device) for v in t]
    return _tensor(t, device)


def _index(t, i: int):
    """Repeat ``i`` of a stacked tree: every leaf's row i."""
    if isinstance(t, dict):
        return {k: _index(v, i) for k, v in t.items()}
    return np.asarray(t)[i]


def from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's parameters on ``device`` (CUDA unless the caller asks
    for the CPU) from the reference's ``init_model`` tree (numpy
    leaves)."""
    dev = resolve_device(device)
    reps = cfg.n_layers // len(cfg.block_pattern)
    out = {k: _tree(v, dev) for k, v in tree.items()
           if k not in ("stack", "tail")}
    out["stack"] = [_tree(_index(tree["stack"], i), dev)
                    for i in range(reps)] if reps else []
    out["tail"] = _tree(list(tree.get("tail", [])), dev)
    return out


def stack_params(params: dict) -> dict:
    """The training layout of the port's parameters: the per-repeat dicts
    of ``params["stack"]`` stacked leaf by leaf (a copy); every other
    leaf is shared."""
    out = {k: v for k, v in params.items() if k != "stack"}
    reps = params.get("stack") or []
    if reps:
        out["stack"] = map_tree(lambda *ts: torch.stack(ts), *reps)
    return out


def unstack_views(params: dict) -> dict:
    """The port's layout of training-layout parameters, no copy: repeat r
    of the stack is a dict of views ``leaf[r]`` (``unbind``: autograd
    takes every repeat's gradient back as one stacked tensor)."""
    out = {k: v for k, v in params.items() if k != "stack"}
    stack = params.get("stack")
    if stack is None:
        out["stack"] = []
        return out
    flat = flatten_with_path(stack)
    reps = flat[0][1].shape[0]
    views = {key: t.unbind(0) for key, t in flat}
    out["stack"] = [_per_repeat(stack, r, views) for r in range(reps)]
    return out


def _per_repeat(t, r: int, views: dict, path: tuple = ()):
    if isinstance(t, dict):
        return {k: _per_repeat(v, r, views, path + (str(k),))
                for k, v in t.items()}
    return views["/".join(path)][r]


def train_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """Training-layout parameters on ``device`` (CUDA unless the caller
    asks for the CPU) straight from the reference's ``init_model`` tree
    (numpy leaves): its layout already, leaf for leaf."""
    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items() if k != "tail"}
    out["tail"] = _tree(list(tree.get("tail", [])), dev)
    return out


# ---------------------------------------------------------------------------
# over a mesh: a tree in per-position shards, and back
# ---------------------------------------------------------------------------
def _entries(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _is_spec(x) -> bool:
    from repro_torch.partitioning import PartitionSpec
    return isinstance(x, PartitionSpec)


def _shard_leaf(t, mesh, spec, i: int, *, copy: bool = True):
    """Position ``i``'s block of a global leaf under ``spec`` (a
    ``PartitionSpec``), on position i's device: each split dim narrowed
    to the position's rank over its entry's axes.  A host number (a
    cache's counter) is returned as it is.  ``copy=False`` leaves a block
    already on its device a view of ``t``."""
    if not isinstance(t, torch.Tensor):
        return t
    dev = mesh.devices[i]
    out = t
    for dim, entry in enumerate(_entries(spec, t.ndim)):
        if entry is None:
            continue
        n = mesh.count(entry)
        if t.shape[dim] % n:
            raise ValueError(f"shard: dim {dim} of {tuple(t.shape)} does "
                             f"not split over {entry} ({n})")
        size = t.shape[dim] // n
        out = out.narrow(dim, mesh.rank(i, entry) * size, size)
    moved = out.to(dev)
    if copy and moved is out:
        moved = out.clone()
    return moved.contiguous() if copy else moved


def shard_params(params, mesh, specs, *, copy: bool = True) -> list:
    """``params`` (a global tree: the training layout, an optimizer
    state, caches) as one tree a mesh position, each leaf its block under
    its spec in ``specs`` (a tree of ``PartitionSpec`` aligned with
    ``params``) on the position's device.  ``copy`` (the default) gives
    every position memory of its own, as an in-place update of each
    position's tree needs; ``copy=False`` lets a block that is already
    on its device be a view of the global leaf (serving weights)."""
    flat = flatten_with_path(params)
    sflat = dict(flatten_with_path(specs, is_leaf=_is_spec))
    out = []
    for i in range(mesh.size):
        vals = [_shard_leaf(t, mesh, sflat[k], i, copy=copy)
                for k, t in flat]
        out.append(unflatten(params, vals))
    return out


def unshard(trees: list, mesh, specs, *, device=None):
    """The global tree of per-position ``trees`` (as
    :func:`shard_params` makes them) under ``specs``: each leaf's blocks
    put back at their offsets, on ``device`` (default the first
    position's).  A host number is taken from the first position."""
    flats = [flatten_with_path(t) for t in trees]
    sflat = dict(flatten_with_path(specs, is_leaf=_is_spec))
    dev = mesh.devices[0] if device is None else torch.device(device)
    vals = []
    for j, (key, first) in enumerate(flats[0]):
        if not isinstance(first, torch.Tensor):
            vals.append(first)
            continue
        entries = _entries(sflat[key], first.ndim)
        shape = [n * (mesh.count(e) if e is not None else 1)
                 for n, e in zip(first.shape, entries)]
        g = torch.empty(shape, dtype=first.dtype, device=dev)
        for i, flat in enumerate(flats):
            block = g
            for dim, e in enumerate(entries):
                if e is not None:
                    size = first.shape[dim]
                    block = block.narrow(dim, mesh.rank(i, e) * size, size)
            block.copy_(flat[j][1].detach())
        vals.append(g)
    return unflatten(trees[0], vals)


__all__ = ["from_jax", "stack_params", "unstack_views", "train_from_jax",
           "shard_params", "unshard"]
