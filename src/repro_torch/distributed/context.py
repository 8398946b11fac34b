"""Re-export of the logical-axis context, the port of the reference's
``repro.distributed.context`` (it lives in :mod:`repro_torch.partitioning`,
so that model code imports it without importing the distributed
package's steps)."""
from repro_torch.partitioning import (axis_rules, constrain, current_rules,
                                      default_rules, logical_to_spec)

__all__ = ["axis_rules", "constrain", "current_rules", "default_rules",
           "logical_to_spec"]
