"""Fault tolerance for the training loop (the port's copy of
``repro/distributed/fault_tolerance.py``).

Mechanisms (all exercised by tests; the failure source is simulated):

* **checkpoint/restart** — the trainer always starts by scanning the
  checkpoint dir and resuming from the latest complete snapshot (atomic
  rename guarantees completeness).  State includes params, optimizer
  moments, quantizer codebooks, the data cursor and the RNG key, so a
  killed-and-restarted run reproduces the uninterrupted loss curve exactly.
* **failure injection** — ``FailureInjector`` raises (or hard-exits) at a
  configured step, driven by env ``REPRO_FAIL_AT_STEP`` / constructor.
* **straggler mitigation** — ``StragglerMonitor`` tracks a robust moving
  estimate of step time (read from the clock its caller hands the timer:
  only the launcher reads the wall clock); steps slower than ``factor``× the median are
  counted and logged (the port trains on one device: the reference's
  elastic path, which drops a slow host and re-shards, has no counterpart
  here).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["FailureInjector", "StragglerMonitor", "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: int | None = None
    mode: str = "raise"            # 'raise' | 'exit'

    def __post_init__(self):
        env = os.environ.get("REPRO_FAIL_AT_STEP")
        if env is not None and self.fail_at_step is None:
            self.fail_at_step = int(env)

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            if self.mode == "exit":
                os._exit(42)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    warmup: int = 3
    _times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def observe(self, seconds: float) -> bool:
        """Record a step time; returns True if this step was a straggler."""
        self._times.append(seconds)
        if len(self._times) <= self.warmup:
            return False
        hist = sorted(self._times[:-1])
        median = hist[len(hist) // 2]
        is_straggler = seconds > self.factor * max(median, 1e-6)
        if is_straggler:
            self.stragglers += 1
        return is_straggler

    class timer:
        """Times its block with ``clock`` (a zero-argument callable giving
        seconds, e.g. ``time.monotonic``) and observes the result."""

        def __init__(self, monitor, clock):
            self.monitor = monitor
            self.clock = clock

        def __enter__(self):
            self.t0 = self.clock()
            return self

        def __exit__(self, *exc):
            self.seconds = self.clock() - self.t0
            self.straggler = self.monitor.observe(self.seconds)
            return False
