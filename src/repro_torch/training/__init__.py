from .checkpoint import CheckpointManager
from .fault_tolerance import StragglerMonitor
from .train_loop import TrainConfig, make_step_fn, train

__all__ = ["CheckpointManager", "StragglerMonitor", "TrainConfig",
           "make_step_fn", "train"]
