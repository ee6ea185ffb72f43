"""Fault-tolerance supervisor: restart-on-failure, stragglers.

Counterpart of `repro/runtime/supervisor.py`: the same control flow,
driven by injectable failures so every path is testable on one host:

  * failure -> restore last complete checkpoint -> replay (the data
    pipeline is stateless/seekable, so "replay" is just re-seeking the
    step index — no data loss, no double-visit);
  * straggler detection: per-step EWMA mean/variance; a step slower
    than mean + k*sigma raises a mitigation event (here: recorded +
    hook invoked).

A step's time ends when the card has finished its work
(`tree_util.block_until_ready`).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional

from repro_torch.tree_util import block_until_ready


class SimulatedFailure(RuntimeError):
    """Raised by failure injectors to model a node loss."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: fail when step hits a listed value."""

    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def __call__(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerDetector:
    """EWMA z-score step-time monitor."""

    alpha: float = 0.2
    threshold_sigma: float = 3.0
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # prime the stats
            self.mean = dt if self.n == 1 else (
                (1 - self.alpha) * self.mean + self.alpha * dt
            )
            self.var = (1 - self.alpha) * self.var + self.alpha * (
                (dt - self.mean) ** 2
            )
            return False
        sigma = math.sqrt(max(self.var, 1e-12))
        is_straggler = dt > self.mean + self.threshold_sigma * sigma
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "mean": self.mean})
        # update stats only with non-straggler samples (keep the
        # baseline clean)
        if not is_straggler:
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + self.alpha * (
                (dt - self.mean) ** 2
            )
        return is_straggler


class Supervisor:
    """Wraps a step function with checkpoint/restart + monitoring.

    `make_state` rebuilds the initial state; `step_fn(state, step_idx)`
    advances one step and returns (state, metrics).  Data is derived
    from step_idx (stateless pipeline), so restarts resume exactly.
    """

    def __init__(
        self,
        make_state: Callable[[], object],
        step_fn: Callable[[object, int], tuple],
        ckpt_manager,
        ckpt_every: int = 10,
        failure_injector: Optional[Callable[[int], None]] = None,
        straggler: Optional[StragglerDetector] = None,
        max_restarts: int = 10,
        on_straggler: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.make_state = make_state
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.inject = failure_injector or (lambda s: None)
        self.straggler = straggler or StragglerDetector()
        self.max_restarts = max_restarts
        self.on_straggler = on_straggler
        self.restarts = 0
        self.history: List[dict] = []

    def _restore_or_init(self):
        state = self.make_state()
        # a simulated failure leaves the checkpoint writer running: let
        # it finish, so the restart point does not depend on I/O speed
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        state = self.ckpt.restore(latest, like=state)
        return state, latest

    def run(self, total_steps: int):
        state, step = self._restore_or_init()
        while step < total_steps:
            try:
                self.inject(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, step)
                block_until_ready(metrics)
                dt = time.perf_counter() - t0
                if self.straggler.observe(step, dt) and self.on_straggler:
                    self.on_straggler(step)
                self.history.append(
                    {"step": step, **{k: float(v) for k, v in metrics.items()}}
                )
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self._restore_or_init()
        self.ckpt.wait()
        return state
