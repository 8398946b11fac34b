"""The fault-tolerant training runtime, on one device or over a mesh,
and the elastic restore onto another mesh: the port of the reference's
``repro.runtime``."""
from repro_torch.runtime.elastic import elastic_restore
from repro_torch.runtime.straggler import StragglerDetector, StragglerEvent
from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                         run_with_auto_restart)

__all__ = ["elastic_restore", "Trainer", "TrainerConfig", "StragglerDetector",
           "StragglerEvent", "run_with_auto_restart"]
