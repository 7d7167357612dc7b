"""Fault-tolerance runtime for the training loop (port of
repro/train/fault_tolerance.py).

* SIGTERM/SIGINT -> drain: finish the in-flight step, checkpoint, exit 0
  (plays nice with preemptible machines);
* per-step retry with bounded attempts (transient host/network errors);
  non-transient errors re-raise after ``max_retries``. A retry runs the
  step again from the inputs the failed attempt was given, which is sound
  because the train step is functional (train/step.py): it never updates
  a tensor in place, so a failure halfway through applies nothing;
* straggler watchdog: per-step wall-time EMA + variance; steps slower than
  mean + k*std are counted and logged;
* ``fail_at`` hooks used by tests to inject a crash at step N.
"""

from __future__ import annotations

import logging
import signal
import time

log = logging.getLogger("repro_torch.ft")


class DrainSignal:
    """Latches SIGTERM/SIGINT; loop checks .draining each step."""

    def __init__(self, install: bool = True):
        self.draining = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._latch)
                signal.signal(signal.SIGINT, self._latch)
            except ValueError:
                pass  # not in main thread (tests)

    def _latch(self, signum, frame):
        log.warning("drain signal %s received; will checkpoint and exit", signum)
        self.draining = True


class StragglerWatchdog:
    def __init__(self, *, k_sigma: float = 3.0, warmup_steps: int = 5):
        self.k = k_sigma
        self.warmup = warmup_steps
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.straggler_steps = 0

    def observe(self, dt: float) -> bool:
        """Returns True when this step was a straggler."""
        self.n += 1
        delta = dt - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (dt - self.mean)
        if self.n <= self.warmup:
            return False
        std = (self.m2 / (self.n - 1)) ** 0.5
        if dt > self.mean + self.k * max(std, 1e-9):
            self.straggler_steps += 1
            log.warning("straggler step: %.3fs vs mean %.3fs (+%.1f sigma)",
                        dt, self.mean, (dt - self.mean) / max(std, 1e-9))
            return True
        return False


def run_with_retries(fn, *args, max_retries: int = 3,
                     transient=(RuntimeError, OSError), backoff: float = 0.5,
                     fail_at=None, **kw):
    """Execute fn with bounded retries on transient errors.

    fail_at: optional callable(attempt)->bool used by tests to inject
    failures.
    """
    last = None
    for attempt in range(max_retries + 1):
        try:
            if fail_at is not None and fail_at(attempt):
                raise RuntimeError("injected failure")
            return fn(*args, **kw)
        except transient as e:  # noqa: PERF203
            last = e
            log.warning("step failed (attempt %d/%d): %s", attempt + 1,
                        max_retries + 1, e)
            time.sleep(backoff * (2 ** attempt))
    raise last


class TrainSupervisor:
    """Composes drain + retries + straggler detection around a step fn."""

    def __init__(self, step_fn, *, checkpoint_fn=None, max_retries: int = 2):
        self.step_fn = step_fn
        self.checkpoint_fn = checkpoint_fn
        self.max_retries = max_retries
        self.drain = DrainSignal(install=False)
        self.watchdog = StragglerWatchdog()

    def install_signals(self):
        self.drain = DrainSignal(install=True)

    def run(self, state, batches, *, n_steps: int, ckpt_every: int = 0,
            fail_at=None):
        """state: (params, opt_state). Returns (state, history): one dict
        of the step's metrics as floats a step, with ``step_s``, the step's
        wall seconds."""
        history = []
        for i in range(n_steps):
            if self.drain.draining:
                break
            batch = next(batches)
            t0 = time.monotonic()
            state = run_with_retries(
                self.step_fn, *state, batch,
                max_retries=self.max_retries,
                fail_at=(lambda a, i=i: fail_at(i, a)) if fail_at else None)
            state, metrics = state[:-1], state[-1]
            # the clock stops after the metrics are read: float() of a
            # device tensor waits for the step's work, where the step
            # function's return (eager torch) only means it was enqueued
            row = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.watchdog.observe(dt)
            history.append({**row, "step_s": dt})
            if ckpt_every and self.checkpoint_fn and \
                    (i + 1) % ckpt_every == 0:
                self.checkpoint_fn(state, i + 1)
        if self.drain.draining and self.checkpoint_fn:
            self.checkpoint_fn(state, -1)
        return state, history
