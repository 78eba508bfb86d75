"""Training substrate of the port: checkpointing and the fault-tolerant
supervisor (the optimizer, gradient compression and train step of the
reference's ``repro.train`` are not ported yet)."""
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
    "Checkpointer", "latest_step", "restore", "save",
    "verify_checkpoint", "CheckpointCorruptError",
    "Supervisor", "SupervisorConfig", "StepResult", "DeviceFailure",
    "classify_failure", "backoff_delay",
]
