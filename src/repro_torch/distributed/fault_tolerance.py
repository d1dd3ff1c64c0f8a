"""Fault tolerance: supervised runs with checkpoint/restart, straggler
detection and elastic rescale, wired into the resumable driver.

Counterpart of ``repro.distributed.fault_tolerance`` for the port's
single-device backends. The failure signals are injected deterministically
by ``repro_torch.testing.faults`` through the driver's segment seams.
Restart-safety comes from the step-atomic checkpoints plus the
deterministic data (a tile and a sample are pure functions of the seed and
their coordinates, so a restore replays identically); elasticity comes
from SODDA's structure: dropping an observation partition just shrinks P
(pi_q is redrawn next iteration, and Theorems 1-4 hold for any P).

Three layers, bottom up:

* :class:`StragglerPolicy` — z-score outlier detection over a trailing
  window of wall times (per segment here).
* :class:`SegmentSupervisor` — runs
  :func:`repro_torch.core.driver.run_resumable` under retry-with-restore:
  a failed segment is retried with exponential backoff after the driver
  restores the latest committed carry (bitwise), the restart budget counts
  *consecutive* failures (committed progress resets it), and per-segment
  wall times feed the straggler policy. A streak of
  ``straggler_patience`` flagged segments triggers ``straggler_action``:
  "rescale" raises :class:`StragglerRescale` for the elastic layer,
  "speculate" re-executes the flagged span with
  :func:`repro_torch.core.driver.replay_segment` and checks it bitwise.
* :func:`run_elastic` / :func:`run_elastic_auto` — a *shrink* drops a lost
  partition at a committed boundary (:func:`rescale_plan` plans it,
  :func:`repro_torch.core.engine.rescale_config` rescales the grid, the
  carry migrates through :func:`repro_torch.core.driver.migrate_resumable`);
  a *grow* re-adds partitions regenerated from the plane's ``(seed, p, q)``
  tiles (:func:`regrow_plane`). ``run_elastic_auto`` lets the supervisor's
  straggler response choose the shrink boundary. A rescaled run is another
  optimization problem, held to the same-optimum ``STALENESS`` policy.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data import synthetic
from repro_torch.data.plane import DataPlane, DenseDataPlane, as_data_plane

__all__ = ["StragglerPolicy", "StragglerRescale", "TrainSupervisor",
           "SegmentSupervisor", "SurvivorDataPlane", "GrownDataPlane",
           "rescale_plan", "shrink_plane", "regrow_plane", "run_elastic",
           "run_elastic_auto", "suggest_commit_every"]


@dataclasses.dataclass
class StragglerPolicy:
    """Flags steps (segments, hosts) whose duration is a z-score outlier;
    production response is re-sharding the slow host's partition (elastic)
    or speculative re-execution.

    window: trailing steps used for the statistics — ``_durations`` is
    bounded to this many entries, so :attr:`p50` is always the trailing
    window's median, not the whole run's. warmup: recorded steps required
    before detection can fire (default ``min(10, window)``, so a small
    window still arms the detector — a hard-coded 10 would permanently
    disarm any ``window < 10``).
    """

    window: int = 50
    z_threshold: float = 3.0
    warmup: Optional[int] = None
    _durations: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.warmup is None:
            self.warmup = min(10, self.window)
        if not 1 <= self.warmup <= self.window:
            raise ValueError(
                f"warmup must be in [1, window={self.window}], got "
                f"{self.warmup} (a warmup beyond the window never fires)")

    def record(self, duration_s: float) -> bool:
        """Returns True if this duration is a straggler event (an outlier
        against the trailing window *before* it)."""
        hist = list(self._durations)
        self._durations.append(float(duration_s))
        if len(self._durations) > self.window:
            del self._durations[:len(self._durations) - self.window]
        if len(hist) < self.warmup:
            return False
        mu, sd = float(np.mean(hist)), float(np.std(hist)) + 1e-9
        return (duration_s - mu) / sd > self.z_threshold

    @property
    def p50(self):
        return float(np.median(self._durations)) if self._durations else 0.0


def rescale_plan(old_P: int, new_P: int, n_per_partition: int):
    """Elastic rescale plan for the SODDA observation grid. Deterministic
    and communication-minimal in both directions.

    Shrink (``new_P < old_P``): the plan maps each surviving partition to
    the old partitions it absorbs — only the ``old_P - new_P`` lost
    partitions move, round-robin over the survivors.

    Grow (``new_P > old_P``): the plan is a *re-partitioning* plan — each
    existing partition keeps its own rows (``{p: [p]}``) and the
    ``new_P - old_P`` new partitions start empty (``{p: []}``); their rows
    are materialized by the data plane (:func:`regrow_plane` regenerates
    them bitwise from the plane's generation seed), not shuffled from
    survivors. ``moved`` counts the rows the new partitions must be filled
    with: ``(new_P - old_P) * n_per_partition``.

    Either way ``plan`` covers exactly ``range(new_P)`` and every listed
    source is a valid old partition, so a caller can drive placement
    directly off it.
    """
    if new_P < 1:
        raise ValueError(f"new_P must be >= 1, got {new_P}")
    if new_P > old_P:  # grow: keep every old row in place, fill the tail
        plan = {p: [p] for p in range(old_P)}
        plan.update({p: [] for p in range(old_P, new_P)})
        moved = (new_P - old_P) * n_per_partition
        return plan, moved
    plan = {p: [p] for p in range(new_P)}
    for lost in range(new_P, old_P):  # shrink: round-robin the lost rows
        plan[lost % new_P].append(lost)
    moved = sum(len(v) - 1 for v in plan.values()) * n_per_partition
    return plan, moved


class StragglerRescale(RuntimeError):
    """Control-flow signal from a :class:`SegmentSupervisor` whose
    ``straggler_action`` is ``"rescale"``: a consecutive-flag streak hit
    ``straggler_patience``, so the run should shrink past the flagged
    worker instead of continuing to wait on it.

    Deliberately a RuntimeError subclass that the supervisor's own retry
    loop **re-raises instead of retrying** — the decision must reach the
    elastic layer (:func:`run_elastic_auto`), which restores the committed
    iterate and restarts on the smaller grid. Carries ``iters_done`` (the
    committed boundary the decision was made at) and ``streak``.
    """

    def __init__(self, iters_done: int, streak: int):
        super().__init__(
            f"straggler streak of {streak} flagged segments at "
            f"iters_done={iters_done}: rescale past the flagged worker")
        self.iters_done = int(iters_done)
        self.streak = int(streak)


class TrainSupervisor:
    """Run a step function under retry-with-restore semantics.

    The step_fn owns device state; on failure (preemption, numerical abort)
    the supervisor restores the latest committed checkpoint and replays.
    ``restarts`` counts *consecutive* failures: a restore that lands on a
    strictly newer committed step than the previous one proves the run is
    making progress and resets the budget, so a long run with occasional
    transient faults is not killed after ``max_restarts`` cumulative events.
    Exercised with injected faults in the tests.
    """

    def __init__(self, ckpt: CheckpointManager, max_restarts: int = 3):
        self.ckpt = ckpt
        self.max_restarts = max_restarts
        self.restarts = 0  # consecutive restarts without committed progress
        self._last_restore: Optional[int] = None
        self.straggler = StragglerPolicy()
        self.events: List[str] = []

    def run(self, total_steps: int, make_state: Callable, template_fn: Callable,
            step_fn: Callable, save_extra: Optional[Callable] = None):
        """make_state() -> state; step_fn(state, step) -> state (may raise)."""
        start, state, extra = self.ckpt.restore_or_init(template_fn(), make_state)
        step = start
        while step < total_steps:
            try:
                t0 = time.monotonic()
                state = step_fn(state, step, extra)
                dt = time.monotonic() - t0
                if self.straggler.record(dt):
                    self.events.append(f"straggler@{step}:{dt:.3f}s")
                step += 1
                self.ckpt.maybe_save(step, state,
                                     save_extra(step) if save_extra else {"step": step})
            except Exception as e:  # preemption / injected fault
                self.events.append(f"restart@{step}:{type(e).__name__}")
                committed = latest_step(self.ckpt.directory)
                landed = 0 if committed is None else committed
                if self._last_restore is not None and landed > self._last_restore:
                    self.restarts = 0  # committed progress since last restore
                self.restarts += 1
                self._last_restore = landed
                if self.restarts > self.max_restarts:
                    raise
                start, state, extra = self.ckpt.restore_or_init(
                    template_fn(), make_state)
                step = start
        return state


# ---------------------------------------------------------------------------
# Segment-level supervision: retry-with-restore around the resumable driver.
# ---------------------------------------------------------------------------
class SegmentSupervisor:
    """Fault-tolerant :func:`repro_torch.core.driver.run_resumable`: the segment
    scheduler with retries, backoff and straggler detection.

    Each attempt runs the resumable driver, which restores the latest
    committed carry from ``checkpoint_dir`` and replays compiled segments —
    so a retry after a mid-run fault resumes **bitwise** where the last
    committed segment left off (the driver's existing resume contract). On
    a fault the supervisor sleeps an exponential backoff
    (``backoff_base_s * 2**(restarts-1)``, capped at ``backoff_max_s``) and
    retries; ``restarts`` counts *consecutive* failures and is reset
    whenever an attempt committed a strictly newer checkpoint than the
    previous failure saw — only a run that stops making progress exhausts
    ``max_restarts``. ``ValueError`` is never retried (misconfiguration
    replays verbatim; a budget of retries cannot fix an argument).

    Per-segment wall times — measured between the driver's
    ``on_segment_start`` and ``on_segment`` seams, so they cover the
    compiled dispatch plus the checkpoint write — feed ``straggler``
    (:class:`StragglerPolicy`); a flagged segment is recorded in
    :attr:`events` and handed to ``on_straggler(iters_done, seconds)``.

    The supervisor can also *respond*: ``straggler_patience`` consecutive
    flagged segments (the serial stand-in for "the same worker flagged in
    consecutive windows") trigger ``straggler_action``:

    * ``None`` — log the response event and call
      ``on_straggler_response(iters_done, streak)``; scheduling continues.
    * ``"rescale"`` — raise :class:`StragglerRescale` so the elastic layer
      (:func:`run_elastic_auto`) shrinks past the flagged worker. The
      retry loop re-raises it — a rescale decision is not a fault.
    * ``"speculate"`` — speculative re-execution:
      :func:`repro_torch.core.driver.replay_segment` re-runs the flagged span
      from the previous commit and cross-checks the committed carry
      bitwise. A mismatch raises (the commit is not trustworthy); a match
      or a refusal (no predecessor commit) is logged and the run continues.

    The streak resets on any unflagged segment and after a response fires.

    ``sleep`` and ``clock`` are injectable so the fault-injection suite runs
    with a fake clock and zero real sleeping (``repro_torch.testing.faults``).
    """

    def __init__(self, max_restarts: int = 3, backoff_base_s: float = 0.05,
                 backoff_max_s: float = 5.0,
                 straggler: Optional[StragglerPolicy] = None,
                 on_straggler: Optional[Callable] = None,
                 straggler_patience: int = 0,
                 straggler_action: Optional[str] = None,
                 on_straggler_response: Optional[Callable] = None,
                 sleep: Callable = time.sleep,
                 clock: Callable = time.monotonic):
        if straggler_action not in (None, "rescale", "speculate"):
            raise ValueError(
                f"straggler_action must be None, 'rescale' or 'speculate', "
                f"got {straggler_action!r}")
        if straggler_patience < 0:
            raise ValueError(
                f"straggler_patience must be >= 0, got {straggler_patience}")
        if straggler_action is not None and straggler_patience < 1:
            raise ValueError(
                f"straggler_action={straggler_action!r} needs "
                f"straggler_patience >= 1 to ever fire, got "
                f"{straggler_patience}")
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.straggler = straggler if straggler is not None else StragglerPolicy()
        self.on_straggler = on_straggler
        self.straggler_patience = straggler_patience
        self.straggler_action = straggler_action
        self.on_straggler_response = on_straggler_response
        self.sleep = sleep
        self.clock = clock
        self.restarts = 0  # consecutive restarts without committed progress
        self.total_restarts = 0
        self._last_committed: Optional[int] = None
        self._streak = 0  # consecutive flagged segments
        self.events: List[str] = []

    def backoff_delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based):
        ``backoff_base_s * 2**(attempt-1)`` capped at ``backoff_max_s`` —
        non-decreasing in ``attempt`` (property-tested)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        return min(self.backoff_max_s,
                   self.backoff_base_s * 2 ** (attempt - 1))

    def note_failure(self, committed: Optional[int],
                     exc_name: str = "Exception") -> Optional[float]:
        """Account one failed attempt against the consecutive-restart
        budget. ``committed`` is the newest committed step visible after
        the failure; a step strictly newer than the previous failure saw
        proves progress and resets the consecutive counter **before** this
        failure is counted. Returns the backoff delay to sleep before
        retrying, or ``None`` when the budget is exhausted (caller
        re-raises)."""
        progressed = committed is not None and (
            self._last_committed is None or committed > self._last_committed)
        if progressed:
            self.restarts = 0
        self._last_committed = committed
        self.restarts += 1
        self.total_restarts += 1
        self.events.append(
            f"restart#{self.restarts}@"
            f"{'-' if committed is None else committed}:{exc_name}")
        if self.restarts > self.max_restarts:
            return None
        delay = self.backoff_delay(self.restarts)
        self.events.append(f"backoff:{delay:.3f}s")
        return delay

    def run_resumable(self, seed, data, cfg, iters: int,
                      backend: str = "reference", *, checkpoint_dir: str,
                      on_segment: Optional[Callable] = None,
                      on_segment_start: Optional[Callable] = None,
                      **kwargs):
        """:func:`repro_torch.core.driver.run_resumable` under supervision.

        Same signature and ``(final_state, history)`` contract; the two
        segment seams are wrapped (timing + straggler detection/response)
        and chained to the caller's callbacks, which remain the
        fault-injection points.
        """
        from repro_torch.core import driver

        self._last_committed = latest_step(checkpoint_dir)
        t_ref = [self.clock()]

        def _start(done):
            t_ref[0] = self.clock()
            if on_segment_start is not None:
                on_segment_start(done)

        def _end(done):
            dt = self.clock() - t_ref[0]
            if self.straggler.record(dt):
                self.events.append(f"straggler@{done}:{dt:.3f}s")
                self._streak += 1
                if self.on_straggler is not None:
                    self.on_straggler(done, dt)
            else:
                self._streak = 0
            respond = (self.straggler_patience
                       and self._streak >= self.straggler_patience)
            if on_segment is not None:
                on_segment(done)
            if respond:
                # After the caller's seam: an injected boundary fault wins
                # over the response, like a real preemption racing it.
                self._respond(done, seed, data, cfg, backend,
                              checkpoint_dir, kwargs)

        while True:
            try:
                return driver.run_resumable(
                    seed, data, cfg, iters, backend,
                    checkpoint_dir=checkpoint_dir, on_segment=_end,
                    on_segment_start=_start, **kwargs)
            except StragglerRescale:
                raise  # a scheduling decision, not a fault — never retried
            except ValueError:
                raise  # misconfiguration — a retry would replay it verbatim
            except Exception as exc:
                delay = self.note_failure(latest_step(checkpoint_dir),
                                          type(exc).__name__)
                if delay is None:
                    raise
                self.sleep(delay)

    def _respond(self, done, seed, data, cfg, backend, checkpoint_dir,
                 kwargs):
        """Fire the configured straggler response at committed boundary
        ``done`` and reset the streak."""
        from repro_torch.core import driver

        streak, self._streak = self._streak, 0
        action = self.straggler_action or "log"
        self.events.append(
            f"straggler-response@{done}:{action}(streak={streak})")
        if self.on_straggler_response is not None:
            self.on_straggler_response(done, streak)
        if self.straggler_action == "rescale":
            raise StragglerRescale(done, streak)
        if self.straggler_action == "speculate":
            # the replay takes the run's device, sampler and engine options
            eng = {k: v for k, v in kwargs.items()
                   if k not in ("segment_iters", "record_every", "keep",
                                "stream_stats", "commit_every", "on_commit",
                                "prefetch_depth", "history")}
            report = driver.replay_segment(
                seed, data, cfg, backend, checkpoint_dir=checkpoint_dir,
                segment_iters=kwargs["segment_iters"],
                record_every=kwargs.get("record_every", 1), **eng)
            if report["replayed"]:
                self.events.append(
                    f"speculate@{done}:[{report['start']},{report['end']}] "
                    f"match={report['match']}")
                if not report["match"]:
                    raise RuntimeError(
                        f"speculative re-execution of "
                        f"[{report['start']}, {report['end']}] diverged "
                        "from the committed carry: the flagged worker's "
                        "commit is not trustworthy")
            else:
                self.events.append(
                    f"speculate@{done}:skipped({report['reason']})")


# ---------------------------------------------------------------------------
# Shrink-P elasticity: partition loss as a live rescale, not a failure.
# ---------------------------------------------------------------------------
class SurvivorDataPlane(DataPlane):
    """View of a ``repro_torch.data.plane.DataPlane`` keeping observation
    partitions ``0..new_P-1``: the survivors of a :func:`rescale_plan`
    shrink (the lost partitions are the tail indices).

    Pure delegation: every surviving tile and label block is the base
    plane's own (bitwise), so for a seed-derived plane a survivor view
    equals a fresh plane built on the smaller grid. Not a registered plane:
    it is a view over one, never built from a seed.
    """

    def __init__(self, base, new_P: int):
        if not 1 <= new_P <= base.P:
            raise ValueError(
                f"new_P must be in [1, {base.P}], got {new_P}")
        self._base = base
        self._init_grid(base.n * new_P, base.M, new_P, base.Q)
        self.device = base.device
        self.dtype = base.dtype

    def x_tile(self, p: int, q: int):
        if not (0 <= p < self.P and 0 <= q < self.Q):
            raise IndexError(f"tile ({p}, {q}) outside surviving grid "
                             f"({self.P}, {self.Q})")
        return self._base.x_tile(p, q)

    def y_block(self, p: int):
        if not 0 <= p < self.P:
            raise IndexError(f"row block {p} outside surviving grid "
                             f"P={self.P}")
        return self._base.y_block(p)

    def materialize(self):
        """Over a resident ``dense`` base the survivors are X's leading
        ``N`` rows, a view with no copy; any other base is assembled tile by
        tile."""
        if isinstance(self._base, DenseDataPlane):
            X, y = self._base.materialize()
            return X[:self.N], y[:self.N]
        return super().materialize()

    @property
    def generation_seed(self):
        """Delegated: a survivor view regrows from its base's seed, so a
        shrink followed by a grow round-trips through the same tiles."""
        return self._base.generation_seed

    @property
    def flip_prob(self):
        return self._base.flip_prob


def shrink_plane(data, new_P: int):
    """The surviving data after a shrink to ``new_P`` observation
    partitions: a :class:`SurvivorDataPlane` view over the first ``new_P``
    row blocks. The lost partitions' rows leave the optimization problem —
    SODDA's convergence theory holds for any P, which is what makes the
    drop a legitimate live rescale."""
    return SurvivorDataPlane(as_data_plane(data), new_P)


class GrownDataPlane(DataPlane):
    """View of a ``repro_torch.data.plane.DataPlane`` extended to
    ``new_P > base.P`` observation partitions: capacity returning after a
    shrink, or a scale-up.

    Partitions below ``base.P`` delegate to the base (bitwise its tiles);
    partitions at and above regenerate on the base's device from the base's
    generation seed. The tile generators seed each tile by ``(seed, p, q)``
    alone, never by the grid, so a regrown partition is bitwise the one a
    fresh plane on the ``(new_P, Q)`` grid holds.

    Only seed-derived static planes can grow: a plane without a
    ``generation_seed`` has no recipe for rows it never held, and a
    streaming plane's windows advance with the cursor; both raise
    TypeError.
    """

    def __init__(self, base, new_P: int):
        if base.is_streaming:
            raise TypeError(
                "cannot grow a streaming plane: its windows advance with "
                "the run's stream epoch, so regrown partitions have no "
                "static recipe — grow the underlying static plane instead")
        if base.generation_seed is None:
            raise TypeError(
                f"{type(base).__name__} has no generation seed: only "
                "seed-derived planes can regrow lost partitions bitwise")
        if not new_P > base.P:
            raise ValueError(
                f"GrownDataPlane only grows: need new_P > {base.P}, got "
                f"{new_P} (use shrink_plane to shrink)")
        self._base = base
        self._init_grid(base.n * new_P, base.M, new_P, base.Q)
        self.device = base.device
        self.dtype = base.dtype

    def x_tile(self, p: int, q: int):
        if not (0 <= p < self.P and 0 <= q < self.Q):
            raise IndexError(f"tile ({p}, {q}) outside grown grid "
                             f"({self.P}, {self.Q})")
        if p < self._base.P:
            return self._base.x_tile(p, q)
        return synthetic.svm_tile_x(self.generation_seed, p, q, self.n,
                                    self.m, device=self.device)

    def y_block(self, p: int):
        if not 0 <= p < self.P:
            raise IndexError(f"row block {p} outside grown grid P={self.P}")
        if p < self._base.P:
            return self._base.y_block(p)
        return synthetic.svm_label_block(
            self.generation_seed, p, self.n, self.Q, self.m,
            flip_prob=self.flip_prob, device=self.device)

    @property
    def generation_seed(self):
        """Delegated, so a grown plane can shrink or grow again bitwise."""
        return self._base.generation_seed

    @property
    def flip_prob(self):
        return self._base.flip_prob


def regrow_plane(data, new_P: int):
    """The data after growing back to ``new_P`` observation partitions: a
    :class:`GrownDataPlane` view regenerating partitions ``base.P..new_P-1``
    bitwise from the base's generation seed. Like the shrink, another
    optimization problem with the same optimum family, held to the
    ``STALENESS`` policy across the transition."""
    return GrownDataPlane(as_data_plane(data), new_P)


def _check_elastic_plane(plane, cfg):
    if plane.P != cfg.P:
        raise ValueError(
            f"elastic rescale needs the data plane partitioned like the run "
            f"(plane P={plane.P}, cfg P={cfg.P}); pass a plane built on "
            "cfg's grid")


def run_elastic(seed, data, cfg, iters: int, backend: str = "reference", *,
                checkpoint_dir: str, segment_iters: int,
                lose_partition_at: int, new_P: Optional[int] = None,
                regrow_at: Optional[int] = None,
                regrow_P: Optional[int] = None,
                record_every: int = 1, keep: int = 3, device=None,
                commit_every: int = 0,
                supervisor: Optional[SegmentSupervisor] = None,
                on_segment: Optional[Callable] = None,
                on_segment_start: Optional[Callable] = None,
                sampler: Optional[Callable] = None, **options):
    """A SODDA run that survives losing an observation partition mid-run.

    Phase 1 runs (supervised) to ``lose_partition_at``, a segment
    boundary, under ``cfg``'s full ``P``. The loss is handled as a live
    rescale: :func:`rescale_plan` plans the shrink to ``new_P`` (default
    ``P - 1``), :func:`repro_torch.core.engine.rescale_config` rescales the
    config (each phase's driver builds its own bundle), and the finalized
    ``SoddaState`` (the ``(M,)`` iterate, the step counter and the seed:
    P-independent) is re-seeded as a committed checkpoint in the shrunk run's directory
    through :func:`repro_torch.core.driver.migrate_resumable` (the async
    carry gets a fresh warm-up exchange there). Phase 2 resumes it to
    ``iters`` on the surviving data.

    With ``regrow_at`` (a later segment boundary) the run grows back to
    ``regrow_P`` partitions (default ``cfg.P``): :func:`regrow_plane`
    regenerates the regrown partitions bitwise from the generation seed,
    and the carry migrates again.

    All phases run under one :class:`SegmentSupervisor`, each keeps the
    driver's bitwise kill-and-resume contract (``commit_every`` included),
    and ``on_segment`` / ``on_segment_start`` reach every phase.
    ``sampler(t)`` reaches every phase's driver and migration: it is
    :func:`repro_torch.core.driver.run`'s replay seam, and since ``t``
    fixes the phase (the shrink's first step is ``lose_partition_at + 1``),
    one sampler can serve the draws of every grid. Returns
    ``(final_state, history, report)``: the history at the uninterrupted
    run's ticks (each phase's objectives over its own data), and the plans,
    moved rows, rescaled configs and planes and the supervisor's events.
    """
    from repro_torch.core import driver, engine

    sup = supervisor if supervisor is not None else SegmentSupervisor()
    new_P = cfg.P - 1 if new_P is None else new_P
    plane = as_data_plane(data)
    _check_elastic_plane(plane, cfg)
    if not 1 <= new_P < cfg.P:
        raise ValueError(
            f"a partition loss shrinks the grid: need 1 <= new_P < {cfg.P}, "
            f"got {new_P} (regrow_at/regrow_P is the grow direction)")
    if not 0 < lose_partition_at < iters:
        raise ValueError(
            f"lose_partition_at must be inside the run (0, {iters}), got "
            f"{lose_partition_at}")
    if lose_partition_at % segment_iters:
        raise ValueError(
            f"lose_partition_at ({lose_partition_at}) must be a segment "
            f"boundary (multiple of segment_iters={segment_iters}): a "
            "partition is droppable exactly where a committed carry exists")
    if regrow_at is not None:
        regrow_P = cfg.P if regrow_P is None else regrow_P
        if not lose_partition_at < regrow_at < iters:
            raise ValueError(
                f"regrow_at must be inside ({lose_partition_at}, {iters}), "
                f"got {regrow_at}")
        if regrow_at % segment_iters:
            raise ValueError(
                f"regrow_at ({regrow_at}) must be a segment boundary "
                f"(multiple of segment_iters={segment_iters})")
        if regrow_P <= new_P:
            raise ValueError(
                f"regrow_P must exceed the shrunk P ({new_P}), got "
                f"{regrow_P}")
    elif regrow_P is not None:
        raise ValueError("regrow_P without regrow_at: pass the boundary "
                         "the capacity returns at")

    plan, moved = rescale_plan(cfg.P, new_P, cfg.n)  # validates the shrink

    d_full = os.path.join(checkpoint_dir, f"P{cfg.P}")
    d_shrunk = os.path.join(checkpoint_dir, f"P{new_P}")

    common = dict(segment_iters=segment_iters, record_every=record_every,
                  keep=keep, device=device, sampler=sampler)
    seams = {"on_segment": on_segment, "on_segment_start": on_segment_start}
    state1, hist1 = sup.run_resumable(
        seed, plane, cfg, lose_partition_at, backend, checkpoint_dir=d_full,
        commit_every=commit_every, **common, **seams, **options)
    sup.events.append(
        f"rescale@{lose_partition_at}:P{cfg.P}->P{new_P} ({moved} rows "
        "absorbable; dropped here)")

    new_cfg = engine.rescale_config(cfg, new_P)
    survivors = shrink_plane(plane, new_P)
    if latest_step(d_shrunk) is None:
        # strip the boundary objective (measured over the full data); the
        # shrunk run re-records that tick over the surviving data
        driver.migrate_resumable(
            seed, survivors, new_cfg, lose_partition_at, state1, backend,
            checkpoint_dir=d_shrunk, history=hist1[:-1], **common,
            **options)
    phase2_end = iters if regrow_at is None else regrow_at
    state, hist = sup.run_resumable(
        seed, survivors, new_cfg, phase2_end, backend,
        checkpoint_dir=d_shrunk, commit_every=commit_every, **common,
        **seams, **options)
    report = {"plan": plan, "moved_rows": moved, "new_cfg": new_cfg,
              "survivors": survivors}
    if regrow_at is not None:
        grow_plan, regrown = rescale_plan(new_P, regrow_P, cfg.n)
        sup.events.append(
            f"rescale@{regrow_at}:P{new_P}->P{regrow_P} ({regrown} rows "
            "regrown from the generation seed)")
        grow_cfg = engine.rescale_config(new_cfg, regrow_P)
        grown = regrow_plane(survivors, regrow_P)
        # "-regrown" keeps this directory distinct from d_full even when
        # capacity returns to the original P
        d_grown = os.path.join(checkpoint_dir, f"P{regrow_P}-regrown")
        if latest_step(d_grown) is None:
            driver.migrate_resumable(
                seed, grown, grow_cfg, regrow_at, state, backend,
                checkpoint_dir=d_grown, history=hist[:-1], **common,
                **options)
        state, hist = sup.run_resumable(
            seed, grown, grow_cfg, iters, backend, checkpoint_dir=d_grown,
            commit_every=commit_every, **common, **seams, **options)
        report.update(grow_plan=grow_plan, regrown_rows=regrown,
                      grow_cfg=grow_cfg, grown=grown)
    report["events"] = list(sup.events)
    return state, hist, report


def run_elastic_auto(seed, data, cfg, iters: int,
                     backend: str = "reference", *, checkpoint_dir: str,
                     segment_iters: int, new_P: Optional[int] = None,
                     patience: int = 2, record_every: int = 1,
                     keep: int = 3, device=None, commit_every: int = 0,
                     supervisor: Optional[SegmentSupervisor] = None,
                     on_segment: Optional[Callable] = None,
                     on_segment_start: Optional[Callable] = None,
                     sampler: Optional[Callable] = None, **options):
    """:func:`run_elastic` with the shrink boundary chosen by the
    supervisor's straggler response instead of preplanned.

    The run starts on ``cfg``'s full grid under a
    :class:`SegmentSupervisor` with ``straggler_action="rescale"`` (a
    supplied ``supervisor`` must be configured that way). When
    ``patience`` consecutive segments are flagged, the supervisor raises
    :class:`StragglerRescale` at a committed boundary; this function lifts
    the committed iterate off the aborted run with
    :func:`repro_torch.core.driver.restore_resumable_state`, shrinks to
    ``new_P`` (default ``P - 1``) as :func:`run_elastic` does, and
    finishes on the surviving data under the same supervisor. A run that
    never triggers the response completes on the full grid and reports
    ``rescaled=False``. ``sampler`` is :func:`run_elastic`'s. Returns
    ``(final_state, history, report)``;
    ``report["rescaled"]`` says whether the response fired and
    ``report["boundary"]`` where.
    """
    from repro_torch.core import driver, engine

    if supervisor is None:
        sup = SegmentSupervisor(straggler_patience=patience,
                                straggler_action="rescale")
    else:
        sup = supervisor
        if sup.straggler_action != "rescale":
            raise ValueError(
                "run_elastic_auto needs a supervisor with "
                f"straggler_action='rescale', got {sup.straggler_action!r}")
    plane = as_data_plane(data)
    _check_elastic_plane(plane, cfg)
    new_P = cfg.P - 1 if new_P is None else new_P
    if not 1 <= new_P < cfg.P:
        raise ValueError(
            f"the straggler response shrinks the grid: need 1 <= new_P < "
            f"{cfg.P}, got {new_P}")

    d_full = os.path.join(checkpoint_dir, f"P{cfg.P}")
    d_shrunk = os.path.join(checkpoint_dir, f"P{new_P}")
    common = dict(segment_iters=segment_iters, record_every=record_every,
                  keep=keep, device=device, sampler=sampler)
    seams = {"on_segment": on_segment, "on_segment_start": on_segment_start}
    try:
        state, hist = sup.run_resumable(
            seed, plane, cfg, iters, backend, checkpoint_dir=d_full,
            commit_every=commit_every, **common, **seams, **options)
        return state, hist, {"rescaled": False, "events": list(sup.events)}
    except StragglerRescale as sig:
        boundary = sig.iters_done

    # The decision fired right after the boundary commit, so the latest
    # committed state *is* the boundary; restore it as the migration seed.
    done, state1, hist1 = driver.restore_resumable_state(
        seed, plane, cfg, backend, checkpoint_dir=d_full, device=device,
        step=boundary, **options)
    plan, moved = rescale_plan(cfg.P, new_P, cfg.n)
    sup.events.append(
        f"rescale@{boundary}:P{cfg.P}->P{new_P} (straggler response; "
        f"{moved} rows absorbable, dropped here)")
    new_cfg = engine.rescale_config(cfg, new_P)
    survivors = shrink_plane(plane, new_P)
    if latest_step(d_shrunk) is None:
        # stamped histories stop before the boundary tick, so nothing to
        # strip (unlike run_elastic's fresh-run history)
        driver.migrate_resumable(
            seed, survivors, new_cfg, boundary, state1, backend,
            checkpoint_dir=d_shrunk, history=hist1, **common, **options)
    state, hist = sup.run_resumable(
        seed, survivors, new_cfg, iters, backend, checkpoint_dir=d_shrunk,
        commit_every=commit_every, **common, **seams, **options)
    report = {"rescaled": True, "boundary": boundary, "plan": plan,
              "moved_rows": moved, "new_cfg": new_cfg,
              "survivors": survivors, "events": list(sup.events)}
    return state, hist, report


def suggest_commit_every(supervision: dict, *, max_overhead: float = 0.25,
                         segment_iters: Optional[int] = None,
                         record_every: Optional[int] = None) -> int:
    """Derive a ``commit_every`` cadence from a measured supervision cell.

    ``supervision`` is the reference bench driver's supervision block
    (``results/BENCH_sodda.json["supervision"]``; the port writes no such
    block yet, so this is the reference's policy kept for parity): its
    ``in_scan_commit_overhead_ratio`` is the per-iteration slowdown the
    in-scan commit path measured at the ``commit_every_small`` cell's
    cadence ``c0``. Commits cost a fixed amount each, so in bare-iteration
    units one commit costs ``k = (ratio - 1) * c0`` and a run at cadence
    ``c`` pays overhead ``k / c``. This picks the **smallest** cadence —
    the least work lost to a mid-segment kill — whose modeled overhead
    stays within ``max_overhead``, among the legal cadences (multiples of
    ``record_every`` that divide ``segment_iters``, both defaulted from
    the block's own stamps). Returns ``0`` — boundary-only commits — when
    no legal cadence is cheap enough (or ``max_overhead <= 0``): paying
    more than the budget on every iteration is worse than losing a
    segment on the rare kill.
    """
    if max_overhead <= 0:
        return 0
    seg = int(segment_iters if segment_iters is not None
              else supervision["segment_iters"])
    rec = int(record_every if record_every is not None
              else supervision["record_every"])
    if seg < 1 or rec < 1 or seg % rec:
        raise ValueError(
            f"record_every={rec} must be >= 1 and divide "
            f"segment_iters={seg}")
    ratio = float(supervision["in_scan_commit_overhead_ratio"])
    c0 = int(supervision["cells"]["commit_every_small"]["commit_every"])
    if c0 < 1:
        raise ValueError(
            f"commit_every_small cell measured cadence {c0}; need >= 1")
    # per-commit cost in bare-iteration units; measurement noise can put
    # the ratio under 1.0, which just means commits are free here
    k = max(0.0, ratio - 1.0) * c0
    for cadence in range(rec, seg + 1, rec):
        if seg % cadence == 0 and k <= max_overhead * cadence:
            return cadence
    return 0
