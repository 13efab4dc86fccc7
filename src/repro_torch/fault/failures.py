"""Fault tolerance: failure detection/injection, straggler mitigation policy
(port of ``repro.fault.failures``; pure Python and numpy, as there).

On real pods these hook into the runtime's health plane; here the policies
are implemented against a simulated cluster clock so they are unit-testable
and the train driver exercises the same code paths it would in production:

* :class:`FailureInjector` — deterministic or stochastic per-step failures
  (used by tests and the train driver's restart path);
* :class:`StepWatchdog` — deadline-based straggler/hang detection with
  escalation (log -> re-dispatch -> declare failed);
* :class:`StragglerPolicy` — per-step duration tracking; marks hosts whose
  step times exceed a robust quantile bound (median + k*MAD) for re-shard
  avoidance on the next elastic event.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np


class WorkerFailure(RuntimeError):
    def __init__(self, step: int, worker: int):
        super().__init__(f"worker {worker} failed at step {step}")
        self.step = step
        self.worker = worker


@dataclasses.dataclass
class FailureInjector:
    """Deterministic (schedule) or stochastic (rate) failure injection."""
    schedule: Optional[Dict[int, int]] = None   # step -> worker id
    rate: float = 0.0                           # per-step failure probability
    seed: int = 0
    n_workers: int = 256

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def check(self, step: int):
        if self.schedule and step in self.schedule:
            raise WorkerFailure(step, self.schedule[step])
        if self.rate > 0 and self._rng.random() < self.rate:
            raise WorkerFailure(step, int(self._rng.integers(self.n_workers)))


@dataclasses.dataclass
class StepWatchdog:
    """Deadline monitor for a blocking step call."""
    deadline_s: float
    clock: Callable[[], float] = time.monotonic

    def run(self, fn, *args):
        t0 = self.clock()
        out = fn(*args)
        dt = self.clock() - t0
        return out, dt, dt > self.deadline_s


@dataclasses.dataclass
class StragglerPolicy:
    """Track per-worker step durations; flag robust outliers.

    A worker is a straggler if its recent median step time exceeds
    cohort_median + k * MAD. Flagged workers are the first to be dropped at
    the next elastic rescale (repro_torch.fault.elastic) and their shards get
    backup re-execution priority.
    """
    window: int = 16
    k_mad: float = 6.0

    def __post_init__(self):
        self._hist: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=self.window))

    def record(self, worker: int, step_time: float):
        self._hist[worker].append(step_time)

    def stragglers(self) -> List[int]:
        meds = {w: float(np.median(h)) for w, h in self._hist.items() if h}
        if len(meds) < 3:
            return []
        vals = np.array(list(meds.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        return [w for w, m in meds.items() if m > med + self.k_mad * mad]
