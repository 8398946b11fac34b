"""Re-export of the logical-axis context (it lives in
:mod:`repro_torch.partitioning`, as the reference's lives in
``repro.partitioning``)."""
from repro_torch.partitioning import (axis_rules, constrain, current_rules,
                                      default_rules, logical_to_spec)

__all__ = ["axis_rules", "constrain", "current_rules", "default_rules",
           "logical_to_spec"]
