"""Training substrate: AdamW, microbatched train step, gradient
compression (error feedback), checkpointing, fault-tolerant supervisor."""
from repro_torch.train.optimizer import AdamWConfig, adamw_update, cosine_lr, init_opt_state
from repro_torch.train.train_step import TrainStepConfig, make_grad_fn, make_train_step
from repro_torch.train.checkpoint import (
    Checkpointer,
    CheckpointCorruptError,
    latest_step,
    restore,
    save,
    verify_checkpoint,
)
from repro_torch.train.fault_tolerance import (
    DeviceFailure,
    StepResult,
    Supervisor,
    SupervisorConfig,
    backoff_delay,
    classify_failure,
)

__all__ = [
    "AdamWConfig", "adamw_update", "cosine_lr", "init_opt_state",
    "TrainStepConfig", "make_grad_fn", "make_train_step",
    "Checkpointer", "latest_step", "restore", "save",
    "verify_checkpoint", "CheckpointCorruptError",
    "Supervisor", "SupervisorConfig", "StepResult", "DeviceFailure",
    "classify_failure", "backoff_delay",
]
