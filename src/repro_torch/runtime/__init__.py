"""The fault-tolerant training runtime on one device: the port of the
reference's ``repro.runtime`` (``elastic_restore``, a re-mesh, waits for
the multi-device stack)."""
from repro_torch.runtime.straggler import StragglerDetector, StragglerEvent
from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                         run_with_auto_restart)

__all__ = ["Trainer", "TrainerConfig", "StragglerDetector",
           "StragglerEvent", "run_with_auto_restart"]
