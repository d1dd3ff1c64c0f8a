"""Deterministic fault injection for the fault-tolerance suite.

The port's own copy of ``repro.testing.faults`` (which imports no JAX);
the two are held equal by ``tests/test_torch_isolation.py``.

Real clusters fail asynchronously; tests must not. The helpers here turn
"executor died", "host straggled" and "time passed" into plain, replayable
Python so every failure path in ``repro_torch.distributed.fault_tolerance`` is
exercised in tier-1 tests with zero real sleeping and zero flakiness:

* :class:`Preemption` / :class:`FaultInjector` — kill the run at exact
  segment boundaries through the resumable driver's ``on_segment`` /
  ``on_segment_start`` seams (after-commit and before-commit faults
  respectively).
* :class:`FakeClock` — an injectable ``clock`` whose time only moves when a
  test calls :meth:`FakeClock.advance`; plant a straggler by advancing it
  inside a segment.
* :class:`ClockAdvancer` — the declarative form of that planting: a seam
  callback that advances the clock by scheduled amounts at chosen
  ``iters_done`` values, so a segment *reads* as slow without sleeping.
* :class:`SleepRecorder` — an injectable ``sleep`` that records requested
  backoff delays instead of waiting them out.
"""
from __future__ import annotations

from typing import Dict, List


class Preemption(RuntimeError):
    """An injected executor death. RuntimeError (not ValueError) on purpose:
    supervisors retry it, while ValueError — misconfiguration — propagates."""


class FaultInjector:
    """Kills the run at chosen segment boundaries, a bounded number of times.

    ``schedule`` maps ``iters_done`` (the value the driver hands to its
    segment seams) to how many times a :class:`Preemption` should be raised
    there. The instance is the callback: pass it as ``on_segment`` (fault
    after the segment's checkpoint committed) or ``on_segment_start`` (fault
    before the segment runs — no new progress) to
    ``driver.run_resumable`` / ``SegmentSupervisor.run_resumable``. Each
    visit decrements the budget, so a supervised retry that replays past the
    same boundary sails through once the budget is spent — exactly the
    transient-fault model. ``seen`` logs every visit for assertions.
    """

    def __init__(self, schedule: Dict[int, int]):
        for done, count in schedule.items():
            if done < 0 or count < 1:
                raise ValueError(
                    f"schedule entries need iters_done >= 0 and count >= 1, "
                    f"got {done}: {count}")
        self.remaining = dict(schedule)
        self.seen: List[int] = []
        self.faults_raised = 0

    def __call__(self, iters_done: int):
        self.seen.append(iters_done)
        if self.remaining.get(iters_done, 0) > 0:
            self.remaining[iters_done] -= 1
            self.faults_raised += 1
            raise Preemption(f"injected fault at iters_done={iters_done}")

    @property
    def exhausted(self) -> bool:
        """True once every scheduled fault has been raised."""
        return all(count == 0 for count in self.remaining.values())


class FakeClock:
    """Deterministic ``time.monotonic`` stand-in: returns a number that only
    moves when the test calls :meth:`advance`."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float):
        if dt < 0:
            raise ValueError(f"time only moves forward, got dt={dt}")
        self.now += dt


class ClockAdvancer:
    """Plants stragglers declaratively: a segment-seam callback that
    advances a :class:`FakeClock` by ``schedule[iters_done]`` seconds when
    it fires at ``iters_done``.

    Pass it as ``on_segment_start`` under a supervisor built with the same
    clock: the supervisor timestamps the segment at ``on_segment_start``
    *before* chaining to the caller's callback and reads the clock again
    at ``on_segment``, so an advance planted at a segment's starting
    ``iters_done`` lands inside the measured window and that segment
    *reads* as ``schedule[iters_done]`` seconds slow — with zero real
    sleeping. (Planted at ``on_segment`` it would land *after* the
    measurement.) ``seen`` logs every visit; each scheduled advance fires
    on every visit to its ``iters_done`` (a retried boundary straggles
    again).
    """

    def __init__(self, clock: FakeClock, schedule: Dict[int, float]):
        for done, dt in schedule.items():
            if done < 0 or dt < 0:
                raise ValueError(
                    f"schedule entries need iters_done >= 0 and dt >= 0, "
                    f"got {done}: {dt}")
        self.clock = clock
        self.schedule = dict(schedule)
        self.seen: List[int] = []

    def __call__(self, iters_done: int):
        self.seen.append(iters_done)
        dt = self.schedule.get(iters_done, 0.0)
        if dt:
            self.clock.advance(dt)


class SleepRecorder:
    """Deterministic ``time.sleep`` stand-in: records each requested delay
    (the supervisor's backoff sequence) without waiting. Optionally advances
    a :class:`FakeClock` so slept time is visible to timing code."""

    def __init__(self, clock: FakeClock = None):
        self.delays: List[float] = []
        self.clock = clock

    def __call__(self, seconds: float):
        self.delays.append(float(seconds))
        if self.clock is not None:
            self.clock.advance(seconds)
