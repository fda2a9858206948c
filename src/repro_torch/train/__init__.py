"""The training substrate (counterpart of ``repro.train``): the train
loop, atomic checkpoints and the fault-tolerance pieces."""
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault_tolerance import (PreemptionGuard,
                                               StragglerPolicy,
                                               run_step_with_retry)
from repro_torch.train.trainer import TrainLoopConfig, train_loop

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "PreemptionGuard", "StragglerPolicy",
           "run_step_with_retry", "TrainLoopConfig", "train_loop"]
