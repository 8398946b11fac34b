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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig


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


__all__ = ["from_jax"]
