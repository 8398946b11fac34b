"""Deterministic fault injection for the serving/tuning/cache stack.

Every robustness behavior in this repo — batch retry, poison-row
bisection, cache quarantine, runtime lowering degradation — must be
testable without monkeypatching internals.  This module provides named
**fault points** that production code consults at its failure-prone
boundaries:

  ``device_run``        the service's device dispatch (plan call)
  ``autotune_measure``  one tuner candidate measurement
  ``cache_io``          a read/write of the on-disk autotune cache

A fault point does nothing unless armed.  Arm points via the
``TINA_FAULTS`` env var or :func:`configure`::

    TINA_FAULTS="device_run:0.05,autotune_measure:0.1,cache_io:once"
    faults.configure("device_run:nan,device_run:once", seed=7)

Spec grammar — comma-separated ``point[@tag]:value`` entries (the same
point may appear multiple times; entries are consulted in order and the
first one that fires wins):

  ``0.05``     fire with probability 0.05 per check (seeded RNG —
               deterministic for a fixed seed *and* check sequence)
  ``once``     fire on the first check, then disarm (== ``x1``)
  ``x3``       fire on the first 3 checks, then disarm
  ``always``   fire on every check
  ``nan``      fire iff the check's ``payload`` contains a non-finite
               value — the deterministic "poison row" fault: retries
               keep failing (the data doesn't change), so the service
               must bisect
  ``off``      never fire (explicitly disarm an env-armed point)

``@tag`` restricts an entry to checks carrying a matching ``tag=`` —
the service tags ``device_run`` checks with the bucket plan's lowering,
so ``device_run@pallas:always`` stops firing once the bucket degrades
to the reference lowering (that is how degradation is tested end to
end).  Untagged entries match every check.

Validation is strict, like ``TINA_TELEMETRY``: an unknown point name, a
malformed value, or a probability outside [0, 1] raises ``ValueError``
the first time the config is loaded (``PipelineService`` loads it at
construction so a typo'd ``TINA_FAULTS`` fails the launch, not the
100th request).

Determinism: rate entries draw from a per-entry ``random.Random``
seeded from ``(seed, point, tag, index)``; the seed comes from
``TINA_FAULTS_SEED`` (default 0) or ``configure(seed=)``.  Identical
config + identical check sequence => identical faults.

Injected faults raise :class:`InjectedFault` (``.point`` names the
fault point; ``.persistent`` is True for ``nan`` entries — retrying the
same payload cannot succeed, so the service skips straight to
isolation).  Every fire bumps the ``faults.injected.<point>`` counter
on the global :mod:`repro_torch.obs` registry.

When nothing is armed, :func:`check` is one attribute read — safe on
the hottest paths.
"""
from __future__ import annotations

import os
import random
import threading

from repro_torch.obs.telemetry import REGISTRY

ENV_VAR = "TINA_FAULTS"
SEED_VAR = "TINA_FAULTS_SEED"

#: the fault points production code consults — specs naming anything
#: else are rejected (strict validation: a typo must not silently
#: disarm the chaos run)
KNOWN_POINTS = ("device_run", "autotune_measure", "cache_io")


class InjectedFault(RuntimeError):
    """An artificial failure fired by an armed fault point.

    ``persistent`` distinguishes data-dependent faults (``nan`` specs:
    the payload is the problem, a retry of the same payload cannot
    succeed) from transient ones (rate/once/always: the next attempt
    redraws).
    """

    def __init__(self, point: str, kind: str, *, persistent: bool = False):
        super().__init__(f"injected fault at {point!r} ({kind})")
        self.point = point
        self.kind = kind
        self.persistent = persistent


class _Entry:
    __slots__ = ("point", "tag", "kind", "rate", "remaining", "_rng")

    def __init__(self, point: str, tag: str | None, kind: str,
                 rate: float = 0.0, remaining: int = -1, seed: int = 0,
                 index: int = 0):
        self.point = point
        self.tag = tag
        self.kind = kind          # "rate" | "count" | "always" | "nan" | "off"
        self.rate = rate
        self.remaining = remaining   # count entries; -1 = unlimited
        self._rng = random.Random(f"{seed}|{point}|{tag}|{index}")

    def fires(self, payload) -> bool:
        if self.kind == "off":
            return False
        if self.kind == "always":
            return True
        if self.kind == "rate":
            return self._rng.random() < self.rate
        if self.kind == "count":
            if self.remaining > 0:
                self.remaining -= 1
                return True
            return False
        if self.kind == "nan":
            if payload is None:
                return False
            import numpy as np     # lazy: keep module import stdlib-only
            return not bool(np.isfinite(payload).all())
        raise AssertionError(self.kind)


# config state: None = env not parsed yet; {} = parsed, nothing armed
_LOCK = threading.Lock()
_ENTRIES: dict[str, list[_Entry]] | None = None


def _parse(spec: str, seed: int) -> dict[str, list[_Entry]]:
    entries: dict[str, list[_Entry]] = {}
    spec = spec.strip()
    if not spec:
        return entries
    for i, part in enumerate(spec.split(",")):
        part = part.strip()
        if ":" not in part:
            raise ValueError(
                f"{ENV_VAR} entry {part!r}: expected 'point[@tag]:value' "
                "(e.g. 'device_run:0.05', 'cache_io:once')")
        name, _, value = part.partition(":")
        name, _, tag = name.strip().partition("@")
        tag = tag.strip() or None
        value = value.strip().lower()
        if name not in KNOWN_POINTS:
            raise ValueError(
                f"{ENV_VAR}: unknown fault point {name!r}; known points: "
                f"{', '.join(KNOWN_POINTS)}")
        if value in ("once", "always", "off", "nan"):
            kind = "count" if value == "once" else value
            e = _Entry(name, tag, kind, remaining=1, seed=seed, index=i)
        elif value.startswith("x"):
            try:
                n = int(value[1:])
            except ValueError:
                raise ValueError(
                    f"{ENV_VAR} entry {part!r}: 'x<N>' needs an integer "
                    "count") from None
            if n < 1:
                raise ValueError(
                    f"{ENV_VAR} entry {part!r}: count must be >= 1")
            e = _Entry(name, tag, "count", remaining=n, seed=seed, index=i)
        else:
            try:
                p = float(value)
            except ValueError:
                raise ValueError(
                    f"{ENV_VAR} entry {part!r}: expected a probability, "
                    "'once', 'x<N>', 'always', 'nan', or 'off'") from None
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"{ENV_VAR} entry {part!r}: probability must be in "
                    "[0, 1]")
            e = _Entry(name, tag, "rate", rate=p, seed=seed, index=i)
        entries.setdefault(name, []).append(e)
    return entries


def _seed_from_env() -> int:
    raw = os.environ.get(SEED_VAR, "0").strip()
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{SEED_VAR}={raw!r}: expected an integer seed") from None


def configure(spec: str | None = None, *, seed: int | None = None) -> None:
    """Arm fault points from ``spec`` (None: re-read ``$TINA_FAULTS``).

    Replaces the whole config — counts/RNG streams restart, so a test
    that configures ``"device_run:once"`` twice gets two fires.  Raises
    ``ValueError`` on a malformed spec (strict, like TINA_TELEMETRY).
    """
    global _ENTRIES
    if spec is None:
        spec = os.environ.get(ENV_VAR, "")
    if seed is None:
        seed = _seed_from_env()
    parsed = _parse(spec, seed)
    with _LOCK:
        _ENTRIES = parsed


def load() -> None:
    """Parse ``$TINA_FAULTS`` if it hasn't been yet (idempotent) —
    called by the service/tuner entry points so a malformed spec fails
    fast at construction, not on the Nth request."""
    if _ENTRIES is None:
        configure(None)


def reset() -> None:
    """Disarm everything and forget the parsed env (a later
    :func:`load` re-reads ``$TINA_FAULTS``)."""
    global _ENTRIES
    with _LOCK:
        _ENTRIES = None


def active(point: str | None = None) -> bool:
    """Is anything armed (or: is ``point`` armed)?"""
    with _LOCK:
        if not _ENTRIES:
            return False
        if point is None:
            return True
        return bool(_ENTRIES.get(point))


def check(point: str, *, payload=None, tag: str | None = None) -> None:
    """Consult a fault point; raises :class:`InjectedFault` when an
    armed entry fires.  ``payload`` feeds ``nan`` entries; ``tag``
    selects ``@tag``-restricted entries.  A no-op (one attribute read)
    when nothing is armed."""
    entries = _ENTRIES
    if not entries:           # None (env unparsed) or {} (nothing armed)
        if entries is None:
            load()
            entries = _ENTRIES
        if not entries:
            return
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r}; known points: "
                         f"{', '.join(KNOWN_POINTS)}")
    todo = entries.get(point)
    if not todo:
        return
    with _LOCK:
        fired = None
        for e in todo:
            if e.tag is not None and e.tag != tag:
                continue
            if e.fires(payload):
                fired = e
                break
    if fired is not None:
        REGISTRY.counter(f"faults.injected.{point}").add()
        REGISTRY.instant("faults.inject", cat="faults", point=point,
                         kind=fired.kind, tag=tag)
        raise InjectedFault(point, fired.kind,
                            persistent=fired.kind == "nan")


def stats() -> dict:
    """Injected-fault counts per point (off the global obs registry)."""
    return {p: REGISTRY.counter(f"faults.injected.{p}").value
            for p in KNOWN_POINTS}


__all__ = ["ENV_VAR", "SEED_VAR", "KNOWN_POINTS", "InjectedFault",
           "configure", "load", "reset", "active", "check", "stats"]
