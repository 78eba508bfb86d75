"""Fault-tolerant training supervisor: a tiered recovery ladder over
checkpoint/restart, plus straggler deadlines and elastic restore — the
port of ``repro.train.fault_tolerance``.

The supervisor wraps the train step in a loop that would run on
the coordinator of a 1000+-node job.  A failed step climbs the ladder
one rung at a time — each rung is strictly cheaper than the next:

1. **Classify** (:func:`classify_failure`) — *transient* (NaN loss,
   preemption, a flaky step) vs *fatal* (a :class:`DeviceFailure` whose
   hardware is gone for good).
2. **Backoff** (:func:`backoff_delay`) — exponential with deterministic
   jitter (seeded by ``(seed, step, attempt)``, so two supervisors with
   the same config never thundering-herd *and* replays are bit-
   reproducible).  Default base is 0 s: tests and CI pay nothing.
3. **Rollback** — restore the newest *intact* checkpoint
   (:func:`repro_torch.train.checkpoint.latest_step` with ``intact_only``,
   checksum-verified) and replay; the deterministic data pipeline makes
   the replayed trajectory bit-equal to a failure-free run.
4. **Evacuate + replan** — fatal failures hand every dead device to the
   communication layer in one batch (``evacuate_hook``; see
   :func:`repro_torch.core.replan.evacuate_devices` →
   :class:`repro_torch.snn.distributed.PlanBuffer`), so the exchange plan
   routes around the loss while training retries from the checkpoint.
5. **Degraded mode** — when the evacuate hook reports the shrunken
   group cannot absorb the load, the supervisor marks itself degraded
   (``allow_degraded``) and keeps stepping on the survivors instead of
   aborting the job; re-join (:func:`repro_torch.core.replan.rejoin_devices`)
   is the exit path once hardware returns.

Stragglers get a per-step wall-clock deadline (EWMA-based): a step
exceeding it is *recorded* (on real multi-host the coordinator would
re-slice the mesh; on CPU we log and continue — interface, not
simulation theater).  ``resume_with`` restores the newest intact
checkpoint onto another device.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from collections.abc import Callable
from typing import Any

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.train import checkpoint as ckpt_mod

__all__ = [
    "SupervisorConfig",
    "Supervisor",
    "StepResult",
    "DeviceFailure",
    "classify_failure",
    "backoff_delay",
]


class DeviceFailure(RuntimeError):
    """A step failure attributable to specific dead device(s).

    Raised by device health monitors (injected via ``failure_hook`` in
    tests and chaos runs — :func:`repro_torch.chaos.supervisor_hook`).  The
    supervisor reports the devices to its replan/evacuate hooks before
    rolling back, so the communication layer can evacuate them and swap
    in an incrementally replanned exchange (:mod:`repro_torch.core.replan` →
    :class:`repro_torch.snn.distributed.PlanBuffer`) while training retries
    from the last checkpoint.

    ``device`` (the first casualty) is kept for single-device callers;
    ``devices`` carries the whole batch.  ``fatal=False`` marks a
    transient hiccup (the device will come back) — the ladder stops at
    rollback for those.
    """

    def __init__(
        self,
        device: int | None = None,
        message: str | None = None,
        *,
        devices: tuple[int, ...] | None = None,
        fatal: bool = True,
    ):
        if devices is None:
            if device is None:
                raise ValueError("DeviceFailure needs device or devices")
            devices = (int(device),)
        else:
            devices = tuple(int(d) for d in devices)
            if not devices:
                raise ValueError("devices must be non-empty")
        super().__init__(
            message or f"device(s) {', '.join(map(str, devices))} failed"
        )
        self.devices = devices
        self.device = devices[0]
        self.fatal = bool(fatal)


def classify_failure(err: BaseException) -> str:
    """Ladder rung 1: ``'fatal'`` (hardware permanently gone — escalate
    to evacuate+replan) or ``'transient'`` (backoff + rollback suffice).
    Only a :class:`DeviceFailure` marked fatal is fatal; NaN losses,
    preemptions, and unknown step errors are transient by default."""
    if isinstance(err, DeviceFailure):
        return "fatal" if err.fatal else "transient"
    return "transient"


def backoff_delay(cfg: "SupervisorConfig", step: int, attempt: int) -> float:
    """Ladder rung 2: exponential backoff with deterministic jitter.

    ``base · factor^attempt · (1 + jitter · u)`` with ``u ∈ [-1, 1)``
    drawn from ``crc32((seed, step, attempt))`` — same config, same
    failure, same delay, bit-reproducibly, while distinct seeds
    decorrelate (no thundering herd on a shared fabric).
    """
    if cfg.backoff_base_s <= 0.0:
        return 0.0
    u = (
        zlib.crc32(f"{cfg.seed}:{step}:{attempt}".encode()) / 0xFFFFFFFF
    ) * 2.0 - 1.0
    delay = cfg.backoff_base_s * cfg.backoff_factor**attempt
    return min(delay * (1.0 + cfg.backoff_jitter * u), cfg.backoff_max_s)


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    max_retries_per_step: int = 3
    deadline_factor: float = 3.0  # straggler: step > factor × EWMA
    ewma_alpha: float = 0.1
    # recovery-ladder knobs: backoff_base_s = 0 disables sleeping
    # entirely, so unit tests and CI never pay wall-clock for chaos runs
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.1
    backoff_max_s: float = 30.0
    seed: int = 0
    allow_degraded: bool = True


@dataclasses.dataclass
class StepResult:
    """One completed step.  ``wall_time`` is cumulative across every
    attempt (rollback/retry cost included — historically only the final
    attempt was timed, hiding retries from the straggler EWMA);
    ``retries`` counts the failed attempts before success; ``degraded``
    marks steps run on a shrunken group after an evacuate+replan could
    not absorb a fatal loss."""

    step: int
    loss: float
    wall_time: float
    restarted: bool = False
    straggler: bool = False
    retries: int = 0
    degraded: bool = False


class Supervisor:
    """Drives (train_step, data_iter) with checkpoint/restart semantics."""

    def __init__(
        self,
        train_step: Callable,
        params: Any,
        opt_state: Any,
        data_iter: Any,
        cfg: SupervisorConfig | None = None,
        *,
        failure_hook: Callable[[int], None] | None = None,
        replan_hook: Callable[[int], None] | None = None,
        evacuate_hook: Callable[[tuple[int, ...]], bool] | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.data_iter = data_iter
        # a default-argument SupervisorConfig() would be evaluated once
        # and shared (mutably) by every supervisor in the process
        self.cfg = cfg if cfg is not None else SupervisorConfig()
        self.failure_hook = failure_hook
        # called with the (first) dead device id when a DeviceFailure is
        # caught, before rollback — the single-device replan entry point
        # kept for existing callers (see repro_torch.core.replan)
        self.replan_hook = replan_hook
        # batched ladder rung: called once per fatal failure with the
        # whole casualty tuple; returns truthy when evacuate+replan
        # absorbed the loss, falsy to drop into degraded mode
        self.evacuate_hook = evacuate_hook
        self._sleep = sleep
        self.checkpointer = ckpt_mod.Checkpointer(self.cfg.ckpt_dir)
        self.step = 0
        self._ewma: float | None = None
        self.history: list[StepResult] = []
        self._last_ckpt_step: int | None = None
        self.dead: list[int] = []
        self.degraded = False

    # -- checkpointing -------------------------------------------------
    def _maybe_checkpoint(self):
        if self.step % self.cfg.ckpt_every == 0:
            self.checkpointer.save_async(
                self.step, self.params, self.opt_state, meta={"step": self.step}
            )
            self._last_ckpt_step = self.step

    def _rollback(self) -> bool:
        with obs.span("supervisor.rollback", cat="recovery",
                      tid="supervisor") as sp:
            self.checkpointer.wait()
            # newest *intact* checkpoint: a corrupt latest (torn write,
            # bit-rot) fails its manifest checksums and the scan falls back
            # to the newest one that verifies
            latest = ckpt_mod.latest_step(self.cfg.ckpt_dir, intact_only=True)
            if latest is None:
                sp.set(restored=False)
                return False
            self.params, self.opt_state, manifest = ckpt_mod.restore(
                self.cfg.ckpt_dir, latest, self.params, self.opt_state
            )
            self.step = manifest["step"]
            sp.set(restored=True, to_step=self.step)
        return True

    # -- main loop -------------------------------------------------------
    def run(self, n_steps: int) -> list[StepResult]:
        start_step = self.step
        if self._last_ckpt_step is None:
            self._maybe_checkpoint()  # step-0 baseline for rollback
        while self.step < start_step + n_steps:
            restarted = False
            retries = 0
            t_step = time.monotonic()  # cumulative: every attempt counts
            _step_ts = obs.now_us()
            for attempt in range(self.cfg.max_retries_per_step + 1):
                # (re-)fetch for the *current* step: a rollback resets
                # self.step to the checkpoint, and replaying the
                # pre-failure batch against restored params silently
                # diverged from the failure-free trajectory
                batch = self.data_iter(self.step)
                try:
                    if self.failure_hook is not None:
                        self.failure_hook(self.step)
                    loss, params, opt_state, _ = self.train_step(
                        self.params, self.opt_state, batch
                    )
                    loss = float(loss)
                    if not np.isfinite(loss):
                        raise FloatingPointError(f"non-finite loss {loss}")
                    self.params, self.opt_state = params, opt_state
                    break
                except Exception as err:
                    restarted = True
                    retries += 1
                    if attempt >= self.cfg.max_retries_per_step:
                        raise
                    # the recovery ladder: classify → backoff → (fatal
                    # only) evacuate+replan → rollback; degraded mode if
                    # the shrunken group cannot absorb the loss
                    kind = classify_failure(err)
                    obs.instant(
                        "supervisor.failure", cat="recovery", tid="supervisor",
                        args={
                            "step": self.step, "attempt": attempt,
                            "kind": kind, "error": type(err).__name__,
                            "devices": list(getattr(err, "devices", ())),
                        },
                    )
                    obs.metric_inc("supervisor.retries")
                    obs.metric_inc(f"supervisor.failures.{kind}")
                    delay = backoff_delay(self.cfg, self.step, attempt)
                    if delay > 0:
                        _ts = obs.now_us()
                        self._sleep(delay)
                        obs.complete(
                            "supervisor.backoff", _ts, delay * 1e6,
                            cat="recovery", tid="supervisor",
                            args={"delay_s": delay, "attempt": attempt},
                        )
                    if isinstance(err, DeviceFailure) and kind == "fatal":
                        self.dead.extend(
                            d for d in err.devices if d not in self.dead
                        )
                        if self.replan_hook:
                            with obs.span("supervisor.replan", cat="recovery",
                                          tid="supervisor",
                                          args={"device": err.device}):
                                self.replan_hook(err.device)
                        if self.evacuate_hook:
                            with obs.span(
                                "supervisor.evacuate", cat="recovery",
                                tid="supervisor",
                                args={"devices": list(err.devices)},
                            ) as sp:
                                absorbed = bool(self.evacuate_hook(err.devices))
                                sp.set(absorbed=absorbed)
                            if not absorbed:
                                if not self.cfg.allow_degraded:
                                    raise
                                self.degraded = True
                                obs.instant(
                                    "supervisor.degraded", cat="recovery",
                                    tid="supervisor",
                                    args={"dead": list(self.dead)},
                                )
                    if not self._rollback():
                        # no checkpoint yet: retry with fresh state
                        continue
            dt = time.monotonic() - t_step
            straggler = self._ewma is not None and dt > self.cfg.deadline_factor * self._ewma
            self._ewma = (
                dt
                if self._ewma is None
                else (1 - self.cfg.ewma_alpha) * self._ewma + self.cfg.ewma_alpha * dt
            )
            self.step += 1
            obs.complete(
                "supervisor.step", _step_ts, dt * 1e6, cat="train",
                tid="supervisor",
                args={"step": self.step, "loss": loss, "retries": retries,
                      "straggler": straggler, "degraded": self.degraded},
            )
            self.history.append(
                StepResult(
                    self.step,
                    loss,
                    dt,
                    restarted=restarted,
                    straggler=straggler,
                    retries=retries,
                    degraded=self.degraded,
                )
            )
            self._maybe_checkpoint()
        self.checkpointer.wait()
        return self.history

    # -- elastic restore ---------------------------------------------------
    def resume_with(self, params_like: Any, opt_like: Any, device: Any | None = None):
        """Restore the newest intact checkpoint into the structures of
        ``params_like``/``opt_like``, its tensors placed on ``device``
        (default: where the targets' leaves live); returns (params,
        opt_state, step)."""
        self.checkpointer.wait()
        latest = ckpt_mod.latest_step(self.cfg.ckpt_dir, intact_only=True)
        if latest is None:
            raise RuntimeError("no checkpoint to resume from")
        params, opt_state, manifest = ckpt_mod.restore(
            self.cfg.ckpt_dir, latest, params_like, opt_like, device=device
        )
        return params, opt_state, manifest["step"]
