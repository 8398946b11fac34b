"""Elastic re-meshing: restore a checkpoint onto a different mesh, the
port of the reference's ``repro.runtime.elastic``.

Checkpoints hold global arrays (``checkpoint/manager``), so restoring is:
build the train step's specs for the *new* mesh and cut each leaf into
its blocks there.  The batch per data shard changes with the mesh; the
sharded step splits the global batch itself, and the optimizer state
follows its parameters because its specs derive from theirs.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import step as step_lib
from repro_torch.models.config import ModelConfig


def elastic_restore(ckpt: CheckpointManager, cfg: ModelConfig, new_mesh, *,
                    batch_size: int, seq_len: int,
                    step: Optional[int] = None, layout: str = "tp"):
    """Returns (params, opt_state, metadata, specs) on ``new_mesh``: one
    tree a position each, in the layout of
    ``make_train_step(cfg, mesh=new_mesh, layout=layout)``'s specs; None
    params when no checkpoint exists."""
    _, specs = step_lib.make_train_step(cfg, mesh=new_mesh,
                                        batch_size=batch_size,
                                        seq_len=seq_len, layout=layout)
    target = {"params": specs.params, "opt_state": specs.opt_state}
    shard = {"params": specs.params_sh, "opt_state": specs.opt_state_sh}
    trees, meta = ckpt.restore(target, step=step, mesh=new_mesh,
                               specs=shard)
    if trees is None:
        return None, None, None, specs
    return ([t["params"] for t in trees], [t["opt_state"] for t in trees],
            meta, specs)


__all__ = ["elastic_restore"]
