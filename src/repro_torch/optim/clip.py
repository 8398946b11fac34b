"""Global-norm gradient clipping, the port of ``repro.optim.clip``."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, map_tree


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sums of squares of every leaf, added in the
    reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, *, inplace: bool = False):
    """Returns (clipped tree, pre-clip norm): every leaf times
    ``min(1, max_norm / max(norm, 1e-12))``, in f32, cast back.
    ``inplace`` scales the leaves themselves (f32 leaves; the train step's
    own gradients) instead of new tensors."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    if inplace:
        for x in leaves(tree):
            x.mul_(scale)
        return tree, norm
    return map_tree(lambda x: (x.float() * scale).to(x.dtype), tree), norm


__all__ = ["global_norm", "clip_by_global_norm"]
