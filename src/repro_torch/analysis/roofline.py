"""Roofline terms of a dry-run cell on the NVIDIA H100, the port of the
reference's ``repro.analysis.roofline``.

    compute    = FLOPs_per_card / 989e12            (bf16 dense peak)
    memory     = bytes_per_card / 3.35e12           (HBM3)
    collective = collective_wire_bytes_per_card / link_bw

The card is an NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's data
sheet, dense rates): 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB of HBM.
Cards within a node talk over NVLink at 450 GB/s a direction; a node
holds 8, and traffic between nodes crosses one 400 Gb/s NIC a card
(50 GB/s).  A card set below 700 W runs slower than these terms say.

The port's dry-run (:mod:`repro_torch.launch.dryrun`) counts FLOPs and
bytes per card on fake tensors, and a collective's bytes from what the
sharded steps' collectives record as they run
(:mod:`repro_torch.distributed.collectives`, :func:`add_collective`),
with the ring-traffic factors the reference applies to XLA's optimized
HLO (``parse_collectives``, kept as its twin; :func:`wire_bytes`):

    all-reduce      2 (n-1)/n x bytes     (ring reduce-scatter+all-gather)
    all-gather      (n-1)/n x out_bytes
    reduce-scatter  (n-1)   x out_bytes   (out is the 1/n shard)
    all-to-all      (n-1)/n x bytes
    collective-permute  1 x bytes

A mesh position is a card, numbered in row-major order over the mesh; a
group whose cards span a node boundary (indices on both sides of a
multiple of ``chips_per_pod``, 8 cards a node) is costed at the NIC's
bandwidth instead of NVLink's.  So a 16-wide ``model`` axis spans two
nodes and its layer collectives cross the NIC (``--dp 32 --tp 8`` keeps
tensor parallelism inside a node).  One card runs no collective: its
rows carry 0.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str = "h100-sxm5-80gb-700w"
    peak_flops_bf16: float = 989e12     # per card, dense
    hbm_bw: float = 3.35e12             # bytes/s per card (HBM3)
    ici_bw: float = 450e9               # bytes/s a direction (NVLink 4)
    dcn_bw: float = 50e9                # bytes/s per card across nodes
    hbm_bytes: float = 80e9             # HBM capacity per card
    chips_per_pod: int = 8              # cards a node (one NVLink domain)


HW = HWSpec()

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"(\w[\w.-]*)\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(", re.I)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_EXPL_RE = re.compile(r"replica_groups=\{(\{[^}]*\}(?:,\{[^}]*\})*)\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _parse_groups(line: str) -> Optional[list[list[int]]]:
    m = _GROUPS_EXPL_RE.search(line)
    if m:
        return [[int(x) for x in g.split(",") if x.strip()]
                for g in re.findall(r"\{([^}]*)\}", m.group(1))]
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        ng, gs = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims)))
        if m.group(4):                      # iota with transpose
            perm = [int(x) for x in m.group(4).split(",")]
            ids = ids.reshape(dims).transpose(perm).reshape(-1)
        return ids.reshape(ng, gs).tolist()
    return None


@dataclasses.dataclass
class CollectiveStats:
    op_bytes: dict = dataclasses.field(default_factory=dict)   # simple sums
    wire_ici: float = 0.0       # ring-model wire bytes/device, ICI ops
    wire_dcn: float = 0.0       # ring-model wire bytes/device, DCN-crossing
    count: int = 0

    @property
    def total_op_bytes(self) -> float:
        return sum(self.op_bytes.values())


def wire_bytes(op: str, n: int, out_bytes: float) -> float:
    """A collective's ring-model wire bytes per member (the module's
    table): ``op`` the HLO name, ``n`` the group size, ``out_bytes`` a
    member's result."""
    if op == "collective-permute":
        return out_bytes          # n comes from source_target_pairs
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * out_bytes
    if op == "all-gather":
        return (n - 1) / n * out_bytes
    if op == "reduce-scatter":
        return (n - 1) * out_bytes
    if op == "all-to-all":
        return (n - 1) / n * out_bytes
    return out_bytes


def crosses_node(cards, chips_per_pod: int = HW.chips_per_pod) -> bool:
    """Whether a group's cards (row-major indices) span two nodes."""
    return len({d // chips_per_pod for d in cards}) > 1


def add_collective(stats: CollectiveStats, op: str, n: int,
                   operand_bytes: float, out_bytes: float,
                   crosses: bool) -> None:
    """One member's part of a collective into ``stats``: its operand
    bytes under ``op``, its wire bytes on the NIC where the group
    ``crosses`` a node boundary, else on NVLink."""
    wire = wire_bytes(op, n, out_bytes)
    stats.op_bytes[op] = stats.op_bytes.get(op, 0.0) + operand_bytes
    stats.count += 1
    if crosses:
        stats.wire_dcn += wire
    else:
        stats.wire_ici += wire


def parse_collectives(hlo_text: str, *, chips_per_pod: int = HW.chips_per_pod
                      ) -> CollectiveStats:
    """The reference's count of an XLA HLO text's collectives, kept as
    its twin (the port makes no HLO; its dry-run fills
    :class:`CollectiveStats` from the collectives its steps record,
    :func:`add_collective`)."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if m is None:
            continue
        result_type, op = m.group(2), m.group(3).lower()
        out_bytes = _shape_bytes(result_type)
        # operand types appear inline inside the parens
        inside = line[m.end():]
        depth, j = 1, 0
        for j, ch in enumerate(inside):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                break
        operand_bytes = _shape_bytes(inside[:j]) or out_bytes
        groups = _parse_groups(line)
        n = len(groups[0]) if groups else 1
        crosses = any(crosses_node(g, chips_per_pod) for g in groups or ())
        add_collective(stats, op, n, operand_bytes, out_bytes, crosses)
    return stats


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per card
    hlo_bytes: float            # per card (the dry-run's op byte count)
    collectives: CollectiveStats = None
    model_flops: float = 0.0    # 6·N·D or 2·N per token (global)
    bytes_per_device: dict = None
    hw: HWSpec = HW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.hw.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        """The op byte count / HBM bw: every operand and result of every
        op, unfused, as the reference's CPU-backend 'bytes accessed'
        counts them; ``t_memory_refined`` is the live-buffer estimate and
        drives ``bottleneck``."""
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def hbm_bytes_refined(self) -> float:
        """Live-buffer traffic estimate: arguments + outputs read/written
        once, every temp written + read once."""
        m = self.bytes_per_device or {}
        args = m.get("argument_size_in_bytes", 0)
        outs = m.get("output_size_in_bytes", 0)
        temps = m.get("temp_size_in_bytes", 0)
        if not (args or temps):
            return self.hlo_bytes
        return float(args + outs + 2 * temps)

    @property
    def t_memory_refined(self) -> float:
        return self.hbm_bytes_refined / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        c = self.collectives
        return c.wire_ici / self.hw.ici_bw + c.wire_dcn / self.hw.dcn_bw if c else 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory_refined,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory_refined, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs — catches remat/dispatch waste."""
        g = self.hlo_flops * self.chips
        return self.model_flops / g if g else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's peak the step would achieve if it runs
        at the roofline bound: useful model FLOPs / (bound-time x peak)."""
        t = self.t_bound
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * self.hw.peak_flops_bf16)

    def row(self) -> dict:
        c = self.collectives or CollectiveStats()
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_gflops_per_chip": self.hlo_flops / 1e9,
            "hlo_gbytes_per_chip": self.hlo_bytes / 1e9,
            "coll_gbytes_ici": c.wire_ici / 1e9,
            "coll_gbytes_dcn": c.wire_dcn / 1e9,
            "coll_op_gbytes": c.total_op_bytes / 1e9,
            "n_collectives": c.count,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_memory_refined_ms": self.t_memory_refined * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "bottleneck": self.bottleneck,
            "model_gflops": self.model_flops / 1e9,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(n_params: float, n_active: float, tokens: float,
                kind: str) -> float:
    """6·N·D for a train step over D tokens; 2·N per decoded/prefilled
    token (forward only)."""
    n = n_active or n_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            cost: dict, hlo_text: str, n_params: float, n_active: float,
            tokens: float, kind: str, memory: dict = None,
            hw: HWSpec = HW) -> RooflineReport:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    stats = parse_collectives(hlo_text, chips_per_pod=hw.chips_per_pod)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, collectives=stats,
        model_flops=model_flops(n_params, n_active, tokens, kind),
        bytes_per_device=memory, hw=hw)


__all__ = ["HWSpec", "HW", "CollectiveStats", "parse_collectives",
           "wire_bytes", "crosses_node", "add_collective",
           "RooflineReport", "model_flops", "analyze"]
