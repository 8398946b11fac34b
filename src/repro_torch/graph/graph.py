"""Declarative pipeline-graph IR (the TINA "series of layers" made a
first-class object).

A :class:`Graph` is a tiny DAG whose nodes are TINA op invocations —
the paper's point is that non-NN algorithms become *sequences* of
conv/FC layers, and this IR is the object the planner (plan.py)
shape-specializes, fuses, autotunes, and compiles into one jitted
callable.

Nodes reference producers by name; insertion order is topological by
construction (you can only reference nodes that already exist).  Ops
are names from the op catalog in :mod:`repro_torch.graph.plan` — mostly the
the op catalog ops plus a few glue primitives (``window``,
``abs2``, ``scale``, ``downsample``).

Constant arrays (FIR taps, window vectors, DFT sizes are attrs) live in
``graph.consts`` and are content-hashed into the graph signature, so
two structurally identical graphs with different taps get different
compiled plans.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Node:
    name: str
    op: str                           # op-catalog name, "input", or "const"
    inputs: tuple[str, ...] = ()
    attrs: tuple[tuple[str, Any], ...] = ()

    @property
    def attr(self) -> dict:
        return dict(self.attrs)


def _hashable(v):
    if isinstance(v, (bool, int, float, str, type(None))):
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_hashable(x) for x in v)
    raise TypeError(f"node attr {v!r} is not hashable/static")


class Graph:
    """Builder + container for a pipeline DAG."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: dict[str, Node] = {}
        self.order: list[str] = []
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self.consts: dict[str, np.ndarray] = {}

    # -- construction -------------------------------------------------------
    def _add(self, node: Node) -> str:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node name {node.name!r}")
        for i in node.inputs:
            if i not in self.nodes:
                raise ValueError(f"{node.name}: unknown input {i!r}")
        self.nodes[node.name] = node
        self.order.append(node.name)
        return node.name

    def input(self, name: str = "x") -> str:
        self.inputs.append(name)
        return self._add(Node(name, "input"))

    def const(self, value, name: str | None = None) -> str:
        name = name or f"c{len(self.consts)}"
        self.consts[name] = np.asarray(value)
        return self._add(Node(name, "const"))

    def apply(self, op: str, *inputs: str, name: str | None = None,
              **attrs) -> str:
        name = name or f"{op}{len(self.order)}"
        at = tuple(sorted((k, _hashable(v)) for k, v in attrs.items()))
        return self._add(Node(name, op, tuple(inputs), at))

    def output(self, *refs: str) -> None:
        for r in refs:
            if r not in self.nodes:
                raise ValueError(f"unknown output {r!r}")
            self.outputs.append(r)

    # -- views --------------------------------------------------------------
    def topo(self) -> list[Node]:
        return [self.nodes[n] for n in self.order]

    def consumers(self) -> dict[str, list[str]]:
        out: dict[str, list[str]] = {n: [] for n in self.nodes}
        for node in self.topo():
            for i in node.inputs:
                out[i].append(node.name)
        return out

    @property
    def signature(self) -> tuple:
        """Hashable structural identity: nodes + wiring + const digests.
        This is the graph component of the plan-cache key."""
        consts = tuple(
            (k, v.shape, str(v.dtype),
             hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()[:16])
            for k, v in sorted(self.consts.items()))
        nodes = tuple((n.name, n.op, n.inputs, n.attrs) for n in self.topo())
        return (nodes, tuple(self.inputs), tuple(self.outputs), consts)

    def __repr__(self):
        ops = " -> ".join(n.op for n in self.topo() if n.op
                          not in ("input", "const"))
        return f"Graph({self.name!r}: {ops})"


def load_graph(spec: dict) -> Graph:
    """Build a :class:`Graph` from a plain dict -- how a graph built
    elsewhere (the JAX package, a file) is carried across.

    ``spec``: ``{"name": str, "nodes": [(name, op, inputs, attrs), ...]
    in topological order, "inputs": [names], "outputs": [names],
    "consts": {name: ndarray}}``.  ``attrs`` is a dict or a tuple of
    (key, value) pairs.  Nodes with op ``"input"`` / ``"const"`` take
    their place in ``inputs`` / ``consts``; the result hashes to the
    same :attr:`Graph.signature` as the graph the dict describes."""
    g = Graph(spec["name"])
    consts = spec.get("consts", {})
    for name, op, inputs, attrs in spec["nodes"]:
        if op == "input":
            g.input(name)
        elif op == "const":
            g.const(consts[name], name)
        else:
            at = tuple(sorted((k, _hashable(v))
                              for k, v in dict(attrs).items()))
            g._add(Node(name, op, tuple(inputs), at))
    if list(spec.get("inputs", g.inputs)) != g.inputs:
        raise ValueError(f"load_graph: inputs {spec['inputs']} do not match "
                         f"the input nodes {g.inputs}")
    g.output(*spec["outputs"])
    return g


__all__ = ["Graph", "Node", "load_graph"]
