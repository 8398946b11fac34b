"""Pipeline registry: whole multi-op graphs with their numpy oracles.

The graph subsystem (:mod:`repro_torch.graph`) registers its built-ins
here at import time; this module stays import-light (no graph
dependency) so core can be used without the planner.  The reference's
Table-1 single-op view comes with the slice that ports the remaining
ops.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class TinaPipeline:
    name: str
    section: str                 # paper section the use case comes from
    build: Callable              # () -> repro_torch.graph.Graph
    oracle: Callable             # pure-numpy whole-pipeline reference
    lowerings: tuple[str, ...]   # lowerings the sweep should cover
    make_args: Callable          # rng, size -> (x,) stream-input tuple
    round_len: Callable = None   # n -> nearest valid signal length; None = any

    def valid_len(self, n: int) -> int:
        return n if self.round_len is None else self.round_len(n)


PIPELINES: dict[str, TinaPipeline] = {}


def register_pipeline(p: TinaPipeline) -> TinaPipeline:
    PIPELINES[p.name] = p
    return p


def pipelines(names: Sequence[str] | None = None) -> list[TinaPipeline]:
    """Built-in pipelines; imports repro_torch.graph so they are
    registered."""
    import repro_torch.graph  # noqa: F401  (registration side effect)
    if names is None:
        return list(PIPELINES.values())
    return [PIPELINES[n] for n in names]


__all__ = ["TinaPipeline", "PIPELINES", "register_pipeline", "pipelines"]
