"""Device meshes: the 1-D :class:`BatchMesh` of batch-sharded plans,
streams and services (the counterpart of
``repro.launch.mesh.make_batch_mesh``), and the n-D :class:`Mesh` of the
sharded LM steps (``make_mesh``, ``make_local_mesh``,
``make_production_mesh``).

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

A :class:`Mesh` names its axes (``("data", "model")``, ``("pod",
"data", "model")``) and holds one device a position, in row-major order
over its shape; as in a :class:`BatchMesh`, a device may repeat (logical
shards of one card, or of the CPU).  One process drives every position
(:mod:`repro_torch.distributed.collectives`).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch


def _checked(devices, who: str) -> tuple:
    """``devices`` as indexed ``torch.device``s: one kind (CPU, cards of
    one name, or ``meta`` for a mesh that only sizes things); a card
    index beyond the visible cards raises."""
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError(f"{who}: no devices")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"{who}: the devices mix types "
                         f"{sorted(kinds)}; a mesh runs on one kind")
    kind = kinds.pop()
    if kind == "cpu":
        return tuple(torch.device("cpu") for _ in devs)
    if kind == "meta" and who == "Mesh":
        return tuple(torch.device("meta") for _ in devs)
    if kind != "cuda":
        raise ValueError(f"{who}: no mesh of {kind!r} devices")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if any(d.index is None for d in devs):
        if not count:
            raise ValueError(f"{who}: 'cuda' requested, 0 cards visible")
        cur = torch.cuda.current_device()
        devs = tuple(torch.device("cuda", cur if d.index is None
                                  else d.index) for d in devs)
    bad = [str(d) for d in devs if d.index >= count]
    if bad:
        raise ValueError(f"{who}: {bad} requested, {count} card(s) visible")
    names = {torch.cuda.get_device_name(d) for d in set(devs)}
    if len(names) > 1:
        raise ValueError(f"{who}: the cards differ ({sorted(names)}); "
                         "tuned winners are keyed on the card's name")
    return devs


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh: ``devices`` (indexed; a device may repeat) on ``axis``."""

    devices: tuple
    axis: str = "batch"

    def __post_init__(self):
        devs = _checked(self.devices, "BatchMesh")
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An n-D mesh: ``axes`` (names) of ``sizes``, and one device a
    position, in row-major order over the sizes (a device may repeat).
    ``shape`` is the ``{axis: size}`` dict that
    :mod:`repro_torch.distributed.sharding` reads."""

    sizes: tuple
    axes: tuple
    devices: tuple

    def __post_init__(self):
        sizes = tuple(int(n) for n in self.sizes)
        axes = tuple(self.axes)
        if len(sizes) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"Mesh: sizes {sizes} and axes {axes} do not "
                             "pair up")
        if min(sizes, default=0) < 1:
            raise ValueError(f"Mesh: sizes {sizes}")
        if len(self.devices) != math.prod(sizes):
            raise ValueError(f"Mesh: {len(self.devices)} devices for a "
                             f"{sizes} mesh")
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "devices", _checked(self.devices, "Mesh"))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def distinct(self) -> tuple:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def coords(self, i: int) -> dict:
        """Position ``i``'s index on every axis."""
        out = {}
        for a, n in zip(reversed(self.axes), reversed(self.sizes)):
            i, out[a] = divmod(i, n)
        return out

    def rank(self, i: int, axes) -> int:
        """Position ``i``'s index over ``axes`` taken together (the first
        the slowest), as a spec entry ``("pod", "data")`` splits a dim."""
        c = self.coords(i)
        r = 0
        for a in _names(axes):
            r = r * self.shape[a] + c[a]
        return r

    def count(self, axes) -> int:
        """The number of ranks over ``axes`` (1 for none)."""
        return math.prod(self.shape[a] for a in _names(axes))

    def groups(self, axes) -> list[list[int]]:
        """The positions that share every index off ``axes``, one list a
        group, each in rank order over ``axes``."""
        return _groups(self, axes)

    def group(self, g, names) -> "Group":
        """The :class:`Group` of positions ``g`` (one of
        ``groups(names)``): every member runs."""
        run = tuple(range(len(g)))
        return Group(tuple(g), run, run, tuple(g))


@dataclasses.dataclass(frozen=True)
class Group:
    """One group of a collective (:mod:`repro_torch.distributed.
    collectives`).  ``positions``: the whole mesh's positions of its n
    members, in rank order; ``slots[k]``: which of the run members'
    tensors member k's is (a member the mesh does not run mirrors a run
    one); ``kept[j]``: the member whose result is run member j's;
    ``members``: the run members (indices into a sharded list)."""
    positions: tuple
    slots: tuple
    kept: tuple
    members: tuple

    @property
    def size(self) -> int:
        return len(self.positions)

    def expand(self, ts) -> list:
        return [ts[k] for k in self.slots]

    def keep(self, ts) -> list:
        return [ts[k] for k in self.kept]


def _groups(mesh, axes) -> list[list[int]]:
    names = _names(axes)
    out: dict = {}
    for i in range(mesh.size):
        c = mesh.coords(i)
        key = tuple(c[a] for a in mesh.axes if a not in names)
        out.setdefault(key, []).append(i)
    return [sorted(g, key=lambda i: mesh.rank(i, names))
            for g in out.values()]


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh:
    """The positions of ``mesh`` whose index is 0 on every axis off
    ``keep`` (of a (data, model) or (pod, data, model) mesh, with
    ``keep=("model",)``: its first data row), standing for the whole
    mesh: a step on it runs those positions only, and a collective over
    an axis it leaves out takes each member it does not run as a copy of
    the run position with the same index on ``keep``
    (:mod:`repro_torch.distributed.collectives`).  The positions off the
    row hold blocks of the same shapes as the row's (a data axis splits
    every batch leaf and ZeRO block evenly), so a ``meta`` run sizes each
    card; the values would be the row's, so only a ``meta`` mesh may be
    cut this way.  Counts, ranks and shapes are the whole mesh's; ``size``
    and ``devices`` the row's."""

    mesh: Mesh
    keep: tuple = ("model",)

    def __post_init__(self):
        if self.mesh.device_type != "meta":
            raise ValueError("RowMesh: a mesh cut to a row sizes things "
                             "only: its devices must be 'meta'")
        keep = tuple(_names(self.keep))
        object.__setattr__(self, "keep", keep)
        object.__setattr__(self, "index", tuple(
            i for i in range(self.mesh.size)
            if all(self.mesh.coords(i)[a] == 0 for a in self.mesh.axes
                   if a not in keep)))

    axes = property(lambda self: self.mesh.axes)
    sizes = property(lambda self: self.mesh.sizes)
    shape = property(lambda self: self.mesh.shape)
    device_type = property(lambda self: "meta")

    @property
    def size(self) -> int:
        return len(self.index)

    @property
    def devices(self) -> tuple:
        return tuple(self.mesh.devices[i] for i in self.index)

    @property
    def distinct(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))

    def coords(self, i: int) -> dict:
        return self.mesh.coords(self.index[i])

    def rank(self, i: int, axes) -> int:
        return self.mesh.rank(self.index[i], axes)

    def count(self, axes) -> int:
        return self.mesh.count(axes)

    def groups(self, axes) -> list[list[int]]:
        return _groups(self, axes)

    def group(self, g, names) -> Group:
        """The :class:`Group` of run positions ``g`` over ``names``: its
        whole mesh's members, each it does not run mirroring the run
        member with the same index on ``keep``."""
        return _mirrored(self, tuple(g), _names(names))


@functools.lru_cache(maxsize=None)
def _mirrored(row: RowMesh, g: tuple, names: tuple) -> Group:
    full = row.mesh
    positions = tuple(row.index[i] for i in g)
    if len(g) == full.count(names):
        run = tuple(range(len(g)))
        return Group(positions, run, run, g)
    c0 = full.coords(positions[0])
    whole = sorted((p for p in range(full.size)
                    if all(full.coords(p)[a] == c0[a] for a in full.axes
                           if a not in names)),
                   key=lambda p: full.rank(p, names))
    slots = tuple(next(j for j, i in enumerate(g)
                       if all(row.coords(i)[a] == full.coords(p)[a]
                              for a in names if a in row.keep))
                  for p in whole)
    return Group(tuple(whole), slots,
                 tuple(whole.index(p) for p in positions), g)


def _names(axes) -> tuple:
    """A spec entry (None, a name, or a tuple of names) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_mesh(shape: tuple, axes: tuple, devices=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axes``.  ``devices``: None, the
    first prod(shape) visible cards, each once (fewer raise ValueError);
    one device (``"cpu"``, ``"cuda:0"``), repeated at every position
    (logical shards); or a sequence of prod(shape) devices."""
    n = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise ValueError(f"make_mesh: a {tuple(shape)} mesh needs {n} "
                             f"cards, {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    return Mesh(tuple(shape), tuple(axes), tuple(devices))


def make_local_mesh(*, model: int = 1, device=None, n: int | None = None
                    ) -> Mesh:
    """(data = n / model, model) over what this host has: on ``"cuda"``
    (the default) the visible cards (``n``: the first n of them); on
    ``"cpu"`` ``n`` logical shards of the CPU (None: one).  ``model`` is
    cut to n, as the reference cuts it to its device count."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        n = 1 if n is None else int(n)
        devices = "cpu"
    elif kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n is None else int(n)
        if not 1 <= n <= count:
            raise ValueError(f"make_local_mesh: {n} cards requested, "
                             f"{count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"make_local_mesh: no mesh of {kind!r} devices")
    model = min(model, n)
    if n % model:
        raise ValueError(f"make_local_mesh: {n} devices do not split into "
                         f"model = {model}")
    return make_mesh((n // model, model), ("data", "model"), devices)


def make_production_mesh(*, multi_pod: bool = False, device="meta") -> Mesh:
    """The reference's production shapes: (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``.  On ``"meta"`` (the
    default) the mesh only sizes things (specs, the dry-run); on
    ``"cuda"`` it takes that many distinct cards and raises ValueError
    unless they are visible; on ``"cpu"`` or an indexed card, that many
    logical shards of it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if torch.device(device).type == "cuda":
        return make_mesh(shape, axes)
    return make_mesh(shape, axes, device)


def mesh_from_args(spec, device: str, *, multi_pod: bool = False):
    """The mesh a launcher's ``--mesh`` (or ``--multi-pod``: the
    reference's (2, 16, 16) production mesh) asks for, or None: over
    distinct cards for an unindexed ``cuda`` (ValueError naming the cards
    it needs and those visible, where they are fewer), else logical
    shards of ``device``.  Nothing shrinks a mesh to fit."""
    dev = torch.device(device)
    distinct = dev.type == "cuda" and dev.index is None
    if multi_pod:
        if spec is not None:
            raise SystemExit(f"--multi-pod and --mesh {spec}: one mesh")
        return make_production_mesh(multi_pod=True,
                                    device="cuda" if distinct else dev)
    if spec is None:
        return None
    shape = tuple(int(n) for n in spec.split(","))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(shape))
    if axes is None:
        raise SystemExit(f"--mesh {spec}: data,model or pod,data,model")
    return make_mesh(shape, axes, None if distinct else dev)


__all__ = ["BatchMesh", "BatchSharding", "Shards", "make_batch_mesh", "Mesh",
           "RowMesh", "Group",
           "make_mesh", "make_local_mesh", "make_production_mesh",
           "mesh_from_args"]
