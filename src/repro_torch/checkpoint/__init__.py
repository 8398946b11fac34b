"""Checkpoints in the reference's on-disk format (one ``.npy`` per leaf
and a ``manifest.json``): the port of ``repro.checkpoint``."""
from repro_torch.checkpoint.manager import (CheckpointManager, load_manifest,
                                            load_pytree, save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "load_manifest"]
