"""The model zoo's steps and their distribution rules on the port: the
train, prefill and decode steps on one device or over a data x model
mesh (``step``), the collectives a sharded step runs (``collectives``),
the parameter / optimizer / batch / cache sharding specs
(``sharding``; the logical-axis context is
:mod:`repro_torch.partitioning`'s, re-exported here and by ``context``)
and the GPipe train step
over a ``stage`` mesh (``pipeline``)."""
from repro_torch.distributed.context import (axis_rules, constrain,
                                             current_rules, default_rules,
                                             logical_to_spec)

__all__ = ["axis_rules", "constrain", "current_rules", "default_rules",
           "logical_to_spec"]
