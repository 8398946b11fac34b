"""Typed serving failures — the service's failure taxonomy.

A production front door must fail *predictably*: a client blocked in
``future.result()`` needs to distinguish "the system refused you"
(:class:`Overloaded`), "you took too long to schedule"
(:class:`DeadlineExceeded`), and "your payload was rejected"
(:class:`InvalidRequest`) from an actual execution error (which is
delivered as the original exception — a poison row isolated by batch
bisection receives the error that batch raised, unwrapped).

Injected faults raise :class:`repro_torch.obs.faults.InjectedFault`,
which is its own type on purpose: a chaos run's artificial failures must
never be mistaken for organic ones in logs or tests.
"""
from __future__ import annotations


class ServiceError(RuntimeError):
    """Base class of the service's own typed failures (not execution
    errors — those are delivered as whatever the plan raised)."""


class Overloaded(ServiceError):
    """The admission queue was full and the policy was ``shed`` or
    ``raise``: the request never entered the queue."""


class DeadlineExceeded(ServiceError):
    """The request's ``deadline_ms`` expired before a device dispatch
    picked it up; it never consumed a device slot."""


class InvalidRequest(ValueError):
    """``validate="strict"`` rejected the payload at submit time (e.g.
    a non-finite sample) — it never reached a batch."""


__all__ = ["ServiceError", "Overloaded", "DeadlineExceeded",
           "InvalidRequest"]
