"""Device meshes for batch-sharded plans, streams and services (the
counterpart of ``repro.launch.mesh.make_batch_mesh``).

A :class:`BatchMesh` is a 1-D mesh: a tuple of indexed devices on one
axis, ``"batch"``.  A sharded plan splits the leading (batch) axis of
every input into ``mesh.size`` equal slices, slice i on ``devices[i]``,
and runs the per-shard plan on each (:mod:`repro_torch.graph.plan`).

* On the card, :func:`make_batch_mesh` takes the first ``n`` visible
  cards, each once.
* On the CPU it gives ``n`` logical shards of the one CPU device: what
  ``--xla_force_host_platform_device_count`` gives the reference, so the
  CPU tests hold the port to the reference's multi-device numerics.
* A mesh built from an explicit device list may repeat a device: several
  logical shards of one card, each run on a CUDA stream of its own.

A mesh that mixes device types, or cards of different names, raises: the
autotuner keys its winners on the card's name, and every shard must run
the same per-shard plan.

The reference's ``make_production_mesh``, ``make_mesh`` and
``make_local_mesh`` build the LM's training meshes; they belong to its
distributed stack and are not ported here.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh: ``devices`` (indexed; a device may repeat) on ``axis``."""

    devices: tuple
    axis: str = "batch"

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("BatchMesh: no devices")
        kinds = {d.type for d in devs}
        if len(kinds) > 1:
            raise ValueError(f"BatchMesh: the devices mix types "
                             f"{sorted(kinds)}; a mesh runs on one kind")
        kind = kinds.pop()
        if kind == "cpu":
            devs = tuple(torch.device("cpu") for _ in devs)
        elif kind == "cuda":
            count = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 0)
            if any(d.index is None for d in devs):
                if not count:
                    raise ValueError("BatchMesh: 'cuda' requested, 0 cards "
                                     "visible")
                cur = torch.cuda.current_device()
                devs = tuple(torch.device("cuda", cur if d.index is None
                                          else d.index) for d in devs)
            bad = [str(d) for d in devs if d.index >= count]
            if bad:
                raise ValueError(f"BatchMesh: {bad} requested, {count} "
                                 "card(s) visible")
            names = {torch.cuda.get_device_name(d) for d in set(devs)}
            if len(names) > 1:
                raise ValueError(f"BatchMesh: the cards differ "
                                 f"({sorted(names)}); tuned winners are "
                                 "keyed on the card's name")
        else:
            raise ValueError(f"BatchMesh: no mesh of {kind!r} devices")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        """The shard count."""
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def distinct(self) -> tuple:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def key(self) -> tuple:
        """What a plan cache keys on: the axis, the shard count and the
        devices."""
        return (self.axis, self.size, tuple(str(d) for d in self.devices))


class Shards(tuple):
    """One input split along its batch axis: slice i on the mesh's device
    i (what ``Plan.shard_inputs`` returns and ``Plan.run_shards``
    takes)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """An input's placement on a mesh: its leading axis split evenly."""

    mesh: BatchMesh

    def place(self, a) -> Shards:
        """Split ``a`` (a tensor or an array) along its leading axis and
        put slice i on device i; a slice already there is a view, not a
        copy."""
        t = torch.as_tensor(a)
        n = self.mesh.size
        if t.ndim < 2:
            raise ValueError(f"sharded inputs need a batch axis: got shape "
                             f"{tuple(t.shape)}; provide (batch, ...) "
                             "inputs")
        if t.shape[0] % n:
            raise ValueError(f"batch divisibility: batch dim {t.shape[0]} "
                             f"is not divisible by the mesh's "
                             f"{self.mesh.axis!r} axis ({n} shards)")
        k = t.shape[0] // n
        return Shards(t[i * k:(i + 1) * k].to(d)
                      for i, d in enumerate(self.mesh.devices))


def make_batch_mesh(n_devices: int | None = None, *, axis: str = "batch",
                    device=None) -> BatchMesh:
    """A 1-D mesh for batch-axis data parallelism.  On ``"cuda"`` (the
    default) the first ``n_devices`` visible cards (None: every one);
    ``n_devices`` out of range raises ValueError.  On ``"cpu"``
    ``n_devices`` logical shards of the one CPU device (None: one)."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"make_batch_mesh: {n} devices requested; a "
                             "CPU mesh holds at least one logical shard")
        return BatchMesh((torch.device("cpu"),) * n, axis)
    if kind != "cuda":
        raise ValueError(f"make_batch_mesh: no mesh of {kind!r} devices")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"make_batch_mesh: {n} devices requested, {count} "
                         "available")
    return BatchMesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


__all__ = ["BatchMesh", "BatchSharding", "Shards", "make_batch_mesh"]
