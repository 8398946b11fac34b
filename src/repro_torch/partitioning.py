"""Logical-axis sharding context (MaxText-style logical axis rules), the
port of the reference's ``repro.partitioning``.

Model code annotates activations with *logical* axis names
(``constrain(x, ("batch", "seq", "tp"))``); a sharded step activates a
rule set mapping logical names to mesh axes.  Rule values may be
``None`` (unsharded), a mesh axis name, or a tuple of mesh axis names
(e.g. batch over ``("pod", "data")``).

A spec is a :class:`PartitionSpec`, a tuple of per-dimension entries
that compares equal to ``tuple(jax.sharding.PartitionSpec(...))`` of the
same entries.  On one card there is nothing to place: ``constrain``
returns its input, after checking the annotation's rank inside a rule
context, as the reference does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

_STATE = threading.local()


class PartitionSpec(tuple):
    """Per-dimension mesh-axis entries: ``None``, an axis name, or a
    tuple of axis names (a tuple of one name is that name, as in JAX's
    spec)."""

    __slots__ = ()

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def current_rules() -> Optional[dict]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: dict):
    """Activate logical->mesh axis rules for this thread."""
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def logical_to_spec(logical: tuple, rules: dict) -> PartitionSpec:
    return P(*[rules.get(name) if name is not None else None
               for name in logical])


def constrain(x, logical: tuple):
    """The sharding constraint by logical axis names: ``x`` itself.
    Inside a rule context the annotation must name every axis of ``x``
    (ValueError otherwise); one card has nothing to place."""
    rules = current_rules()
    if rules is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"constrain: {logical} names {len(logical)} axes, "
                         f"x has shape {tuple(x.shape)}")
    return x


def default_rules(*, multi_pod: bool = False, fsdp: bool = False,
                  sequence_parallel: bool = False,
                  layout: str = "tp") -> dict:
    """Production rule sets.

    layout="tp"   — Megatron: DP over (pod, data), TP/EP over model,
                    optional ZeRO-3 over data (cfg.fsdp), optional SP.
    layout="fsdp" — no tensor parallelism: DP over (pod, data); params +
                    optimizer state ZeRO-3-sharded over the model axis;
                    the model axis also carries vocab-parallel
                    embedding/CE.
    layout="sp"   — sequence/context parallelism: batch over data,
                    SEQUENCE over model; no tensor parallelism.
    """
    batch = ("pod", "data") if multi_pod else ("data",)
    if layout == "tp":
        return {
            "batch": batch,
            "seq": "model" if sequence_parallel else None,
            "tp": "model",
            "vocab": "model",
            "expert": "model",
            "fsdp": "data" if fsdp else None,
            "embed": None,
        }
    if layout == "fsdp":
        return {
            "batch": batch,
            "seq": None,
            "tp": None,
            "vocab": "model",          # vocab-parallel embed/CE
            "expert": "model",         # EP unchanged
            "fsdp": "model",           # ZeRO-3 over the model axis
            "embed": None,
        }
    if layout == "sp":
        return {
            "batch": batch,
            "seq": "model",
            "tp": None,
            "vocab": "model",
            "expert": "model",
            "fsdp": None,
            "embed": None,
        }
    raise ValueError(f"unknown layout {layout!r}")


__all__ = ["PartitionSpec", "P", "axis_rules", "constrain", "current_rules",
           "default_rules", "logical_to_spec"]
