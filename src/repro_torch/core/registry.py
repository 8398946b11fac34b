"""TINA op registry: the Table-1 view over :mod:`repro_torch.core.opdefs`
-- one row per paper mapping with its eager function, lowerings, numpy
oracle and sweep inputs -- and the pipeline registry.

``REGISTRY`` is generated: every op is declared once in
``core/opdefs.py``, and the OpDefs carrying ``table_name`` + ``eager`` +
``oracle`` + ``make_args`` are its rows, in the reference's order.  Do
not add entries here; declare an OpDef instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core import opdefs


@dataclasses.dataclass(frozen=True)
class TinaOp:
    name: str
    section: str                 # paper section
    building_block: str          # paper Table 1 column
    fn: Callable                 # fn(*args, lowering=...)
    oracle: Callable             # pure-numpy reference
    lowerings: tuple[str, ...]   # supported lowerings
    make_args: Callable          # rng, size -> args tuple (for sweeps)


def _generate() -> dict[str, TinaOp]:
    out: dict[str, TinaOp] = {}
    for d in opdefs.table_ops():
        if d.eager is None or d.oracle is None or d.make_args is None:
            raise ValueError(
                f"OpDef {d.name!r} declares table_name={d.table_name!r} "
                "but is missing eager/oracle/make_args")
        out[d.table_name] = TinaOp(
            d.table_name, d.section, d.building_block, d.eager, d.oracle,
            d.lowerings, d.make_args)
    return out


REGISTRY: dict[str, TinaOp] = _generate()


def ops(names: Sequence[str] | None = None) -> list[TinaOp]:
    if names is None:
        return list(REGISTRY.values())
    return [REGISTRY[n] for n in names]


# ---------------------------------------------------------------------------
# Pipelines: whole multi-op graphs registered alongside the single ops.  The
# graph subsystem (repro_torch.graph) registers its built-ins here at import
# time; this module stays import-light (no graph dependency) so core can be
# used without the planner.
# ---------------------------------------------------------------------------


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


__all__ = ["TinaOp", "REGISTRY", "ops",
           "TinaPipeline", "PIPELINES", "register_pipeline", "pipelines"]
