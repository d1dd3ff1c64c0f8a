"""The port's fault-tolerance layer (``repro_torch.distributed``) against
``repro.distributed.fault_tolerance``: every single-device case of
``tests/test_fault_tolerance.py`` on the port. Supervised runs survive
injected kills bitwise, mid-segment commits resume bitwise, straggler
detection and its responses fire deterministically under the fake clock,
restart budgets are consecutive, and shrink and grow rescales are bitwise
their hand-made composition and land on the rescaled problem's optimum
under STALENESS. The policy pieces that hold no run are also held equal to
the reference's on the same inputs."""
import dataclasses
import os
import shutil
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.data import plane as ref_plane
from repro.data import synthetic as ref_synthetic
from repro.distributed import fault_tolerance as ref_ft
from repro.testing import small_fixture_config
from repro.testing.tolerances import (F32_REDUCTION,
                                      assert_trajectories_close)
from repro_torch.checkpoint import (CheckpointManager, committed_steps,
                                    latest_step, read_extra)
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import driver, engine, partition, sodda
from repro_torch.data.plane import DataPlane, DenseDataPlane, make_plane
from repro_torch.distributed import fault_tolerance as port_ft
from repro_torch.distributed.fault_tolerance import (GrownDataPlane,
                                                     SegmentSupervisor,
                                                     StragglerPolicy,
                                                     StragglerRescale,
                                                     SurvivorDataPlane,
                                                     TrainSupervisor,
                                                     regrow_plane,
                                                     rescale_plan,
                                                     run_elastic,
                                                     run_elastic_auto,
                                                     shrink_plane,
                                                     suggest_commit_every)
from repro_torch.testing.faults import (ClockAdvancer, FakeClock,
                                        FaultInjector, Preemption,
                                        SleepRecorder)
from repro_torch.testing.tolerances import (STALENESS,
                                            assert_objectives_close)

ITERS, SEGMENT, RECORD = 10, 4, 2
SETTINGS = [("reference", {}), ("cuda", {}), ("async", {"staleness": 0}),
            ("async", {"staleness": 1}), ("radisa-avg", {})]
IDS = ["reference", "cuda", "async-s0", "async-s1", "radisa-avg"]


@pytest.fixture(scope="module")
def cfg():
    return port_configs.SoddaConfig(
        **dataclasses.asdict(small_fixture_config()))


def _plane(cfg, kind="tiled", P=None):
    P = cfg.P if P is None else P
    return make_plane(kind, 0, cfg.n * P, cfg.M, P, cfg.Q, device="cpu")


@pytest.fixture(scope="module")
def plane(cfg):
    return _plane(cfg)


@pytest.fixture(scope="module")
def stream_plane(cfg):
    return _plane(cfg, "streaming")


def _same(a, b):
    assert a[1] == b[1]
    assert torch.equal(a[0].w, b[0].w) and a[0].t == b[0].t


def _resumable(data, cfg, iters, d, backend="reference", seed=1, **kw):
    return driver.run_resumable(seed, data, cfg, iters, backend,
                                checkpoint_dir=d, device="cpu", **kw)


# ---------------------------------------------------------------------------
# StragglerPolicy and rescale_plan
# ---------------------------------------------------------------------------
def test_straggler_small_window_detects_outlier():
    sp = StragglerPolicy(window=5, z_threshold=3.0)
    for _ in range(5):
        assert not sp.record(0.1)
    assert sp.record(1.5)


def test_straggler_history_bounded_to_window():
    sp = StragglerPolicy(window=5)
    for _ in range(95):
        sp.record(0.1)
    for _ in range(5):
        sp.record(0.4)
    assert len(sp._durations) == 5
    assert sp.p50 == pytest.approx(0.4)


def test_straggler_outlier_judged_against_prior_window():
    sp = StragglerPolicy(window=8, warmup=4)
    for _ in range(4):
        sp.record(0.1)
    assert sp.record(2.0)
    for _ in range(6):
        sp.record(2.0)
    assert not sp.record(2.0)


def test_straggler_policy_validation():
    with pytest.raises(ValueError, match="window"):
        StragglerPolicy(window=0)
    with pytest.raises(ValueError, match="warmup"):
        StragglerPolicy(window=5, warmup=0)
    with pytest.raises(ValueError, match="warmup"):
        StragglerPolicy(window=5, warmup=6)
    assert StragglerPolicy(window=5).warmup == 5
    assert StragglerPolicy(window=50).warmup == 10


def test_straggler_flags_match_reference_on_the_same_durations():
    rng = np.random.default_rng(0)
    durations = np.concatenate([rng.uniform(0.1, 0.12, 30), [2.0, 0.11],
                                rng.uniform(0.1, 0.5, 30), [9.0]])
    port, ref = StragglerPolicy(window=12), ref_ft.StragglerPolicy(window=12)
    assert [port.record(d) for d in durations] == \
        [ref.record(d) for d in durations]
    assert port.p50 == ref.p50


def test_rescale_plan_grow_is_a_repartitioning_plan():
    plan, moved = rescale_plan(4, 6, n_per_partition=10)
    assert plan == {0: [0], 1: [1], 2: [2], 3: [3], 4: [], 5: []}
    assert moved == 20
    with pytest.raises(ValueError, match=">= 1"):
        rescale_plan(4, 0, n_per_partition=10)


@pytest.mark.parametrize("old_P,new_P", [(3, 1), (8, 6), (5, 4), (2, 5)])
def test_rescale_plan_matches_reference(old_P, new_P):
    assert rescale_plan(old_P, new_P, 7) == \
        ref_ft.rescale_plan(old_P, new_P, 7)


def test_rescale_plan_shrink_to_one():
    plan, moved = rescale_plan(3, 1, n_per_partition=7)
    assert plan == {0: [0, 1, 2]}
    assert moved == 14


# ---------------------------------------------------------------------------
# TrainSupervisor: consecutive restart budget
# ---------------------------------------------------------------------------
def _step_supervisor(tmp_path, name, every, max_restarts, fault_steps):
    sup = TrainSupervisor(CheckpointManager(str(tmp_path / name),
                                            every=every),
                          max_restarts=max_restarts)
    remaining = dict.fromkeys(fault_steps, 1)

    def make_state():
        return {"w": torch.zeros(4)}

    def step_fn(state, step, extra):
        if remaining.get(step, 0):
            remaining[step] -= 1
            raise Preemption(f"injected@{step}")
        return {"w": torch.as_tensor(state["w"]) + float(step)}

    return sup, lambda: sup.run(10, make_state, make_state, step_fn)


def test_train_supervisor_budget_is_consecutive(tmp_path):
    sup, run = _step_supervisor(tmp_path, "consec", every=1, max_restarts=1,
                                fault_steps=(3, 5, 7))
    state = run()
    assert torch.equal(state["w"], torch.full((4,), float(sum(range(10)))))
    assert len([e for e in sup.events if e.startswith("restart@")]) == 3
    assert sup.restarts == 1


def test_train_supervisor_exhausts_without_progress(tmp_path):
    sup = TrainSupervisor(CheckpointManager(str(tmp_path / "s2"), every=100),
                          max_restarts=2)

    def step_fn(state, step, extra):
        if step == 4:
            raise Preemption("permanent fault")
        return state

    def make_state():
        return {"w": torch.zeros(2)}

    with pytest.raises(Preemption):
        sup.run(10, make_state, make_state, step_fn)
    assert sup.restarts == 3


# ---------------------------------------------------------------------------
# SegmentSupervisor
# ---------------------------------------------------------------------------
def _sup(**kw):
    return SegmentSupervisor(sleep=kw.pop("sleep", SleepRecorder()),
                             clock=kw.pop("clock", FakeClock()), **kw)


def test_supervised_retry_is_bitwise(cfg, plane, tmp_path):
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu")
    plain = driver.run_resumable(1, plane, cfg, ITERS, "reference",
                                 checkpoint_dir=str(tmp_path / "plain"), **kw)
    inj_end = FaultInjector({SEGMENT: 1})
    inj_start = FaultInjector({2 * SEGMENT: 1})
    sleeps = SleepRecorder()
    sup = _sup(max_restarts=3, sleep=sleeps)
    got = sup.run_resumable(1, plane, cfg, ITERS, "reference",
                            checkpoint_dir=str(tmp_path / "sup"),
                            on_segment=inj_end, on_segment_start=inj_start,
                            **kw)
    _same(plain, got)
    assert inj_end.exhausted and inj_start.exhausted
    assert sup.total_restarts == 2 and len(sleeps.delays) == 2


def test_supervisor_backoff_and_budget_exhaustion(cfg, plane, tmp_path):
    inj = FaultInjector({0: 99})
    sleeps = SleepRecorder()
    sup = _sup(max_restarts=3, backoff_base_s=0.05, sleep=sleeps)
    with pytest.raises(Preemption):
        sup.run_resumable(1, plane, cfg, ITERS, "reference",
                          checkpoint_dir=str(tmp_path / "c"),
                          segment_iters=SEGMENT, record_every=RECORD,
                          device="cpu", on_segment_start=inj)
    assert sup.restarts == 4
    assert sleeps.delays == pytest.approx([0.05, 0.10, 0.20])
    assert latest_step(str(tmp_path / "c")) is None


def test_supervisor_budget_resets_on_committed_progress(cfg, plane, tmp_path):
    inj = FaultInjector({SEGMENT: 1, 2 * SEGMENT: 1})
    sup = _sup(max_restarts=1)
    s, _ = sup.run_resumable(1, plane, cfg, ITERS, "reference",
                             checkpoint_dir=str(tmp_path / "c"),
                             segment_iters=SEGMENT, record_every=RECORD,
                             device="cpu", on_segment_start=inj)
    assert s.t == ITERS + 1
    assert sup.total_restarts == 2 and sup.restarts == 1


def test_supervisor_does_not_retry_valueerror(cfg, plane, tmp_path):
    sup = _sup()
    with pytest.raises(ValueError, match="segment_iters"):
        sup.run_resumable(1, plane, cfg, ITERS, "reference",
                          checkpoint_dir=str(tmp_path / "c"),
                          segment_iters=0, device="cpu")
    assert sup.restarts == 0 and sup.events == []


def test_supervisor_straggler_detection(cfg, plane, tmp_path):
    clock = FakeClock()
    flagged = []

    def slow_segment(done):
        if done == 8:
            clock.advance(5.0)

    sup = _sup(straggler=StragglerPolicy(window=4, z_threshold=3.0),
               on_straggler=lambda done, dt: flagged.append((done, dt)),
               clock=clock)
    sup.run_resumable(1, plane, cfg, ITERS, "reference",
                      checkpoint_dir=str(tmp_path / "c"), segment_iters=2,
                      record_every=2, device="cpu",
                      on_segment_start=slow_segment)
    assert flagged == [(10, pytest.approx(5.0))]
    assert any(e.startswith("straggler@10") for e in sup.events)


@pytest.mark.parametrize("attempts", [1, 4, 12])
def test_backoff_and_note_failure_match_reference(attempts):
    kw = dict(max_restarts=3, backoff_base_s=0.05, backoff_max_s=0.3)
    port = _sup(**kw)
    ref = ref_ft.SegmentSupervisor(sleep=lambda s: None, **kw)
    assert [port.backoff_delay(a) for a in range(1, attempts + 1)] == \
        [ref.backoff_delay(a) for a in range(1, attempts + 1)]
    seen = [None, None, 2, 2, 4, None, 6, 6, 6, 6, 8, 8][:attempts]
    assert [port.note_failure(c) for c in seen] == \
        [ref.note_failure(c) for c in seen]
    assert port.events == ref.events


# ---------------------------------------------------------------------------
# Shrink and grow planes; rescale_bundle
# ---------------------------------------------------------------------------
def test_shrink_plane_is_bitwise_view_of_survivors(cfg, plane):
    survivors = shrink_plane(plane, 1)
    assert isinstance(survivors, SurvivorDataPlane)
    assert (survivors.P, survivors.Q) == (1, cfg.Q)
    assert survivors.N == cfg.n and survivors.M == cfg.M
    for q in range(cfg.Q):
        assert torch.equal(survivors.x_tile(0, q), plane.x_tile(0, q))
    assert torch.equal(survivors.y_block(0), plane.y_block(0))
    with pytest.raises(IndexError):
        survivors.x_tile(1, 0)
    with pytest.raises(IndexError):
        survivors.y_block(1)
    with pytest.raises(ValueError):
        shrink_plane(plane, cfg.P + 1)


def test_survivors_of_a_dense_plane_are_a_row_view(cfg, plane):
    """Over a resident dense plane the survivors' X is the base's leading
    rows, no copy, and equals the tile-by-tile assembly."""
    X, y = plane.materialize()
    dense = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    Xs, ys = shrink_plane(dense, 1).materialize()
    assert Xs.data_ptr() == X.data_ptr() and ys.data_ptr() == y.data_ptr()
    Xt, yt = shrink_plane(plane, 1).materialize()
    assert torch.equal(Xs, Xt) and torch.equal(ys, yt)


def test_shrink_plane_equals_fresh_smaller_plane(cfg, plane):
    fresh = _plane(cfg, P=1)
    survivors = shrink_plane(plane, 1)
    for q in range(cfg.Q):
        assert torch.equal(survivors.x_tile(0, q), fresh.x_tile(0, q))
    assert torch.equal(survivors.y_block(0), fresh.y_block(0))
    Xs, ys = survivors.materialize()
    Xf, yf = fresh.materialize()
    assert torch.equal(Xs, Xf) and torch.equal(ys, yf)


def test_rescale_bundle_rebuilds_grid(cfg):
    new_cfg, new_mesh, bundle = engine.rescale_bundle(cfg, "reference", 1,
                                                      device="cpu")
    assert new_cfg.P == 1 and new_cfg.Q == cfg.Q and new_cfg.n == cfg.n
    assert new_cfg.m_tilde == cfg.M // (cfg.Q * 1)
    assert new_mesh is None and bundle.step is not None
    with pytest.raises(ValueError, match="takes no mesh"):
        engine.rescale_bundle(cfg, "reference", 1, device="cpu",
                              mesh=object())


def test_rescale_bundle_grows_grid(cfg):
    big_cfg, big_mesh, bundle = engine.rescale_bundle(cfg, "reference",
                                                      2 * cfg.P, device="cpu")
    assert big_cfg.P == 2 * cfg.P and big_cfg.Q == cfg.Q
    assert big_cfg.n == cfg.n and big_cfg.N == cfg.n * 2 * cfg.P
    assert big_cfg.m_tilde == cfg.M // (cfg.Q * 2 * cfg.P)
    assert big_mesh is None and bundle.step is not None
    with pytest.raises(ValueError, match="split into"):
        engine.rescale_bundle(cfg, "reference", 3, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        engine.rescale_bundle(cfg, "reference", 0, device="cpu")


def test_grown_plane_matches_fresh_larger_plane_bitwise(cfg, plane):
    grown = regrow_plane(plane, 2 * cfg.P)
    assert isinstance(grown, GrownDataPlane)
    assert (grown.P, grown.Q) == (2 * cfg.P, cfg.Q)
    assert grown.N == 2 * cfg.N and grown.M == cfg.M
    fresh = _plane(cfg, P=2 * cfg.P)
    for p in range(2 * cfg.P):
        for q in range(cfg.Q):
            assert torch.equal(grown.x_tile(p, q), fresh.x_tile(p, q))
        assert torch.equal(grown.y_block(p), fresh.y_block(p))


def test_shrink_then_regrow_round_trips_bitwise(cfg, plane):
    regrown = regrow_plane(shrink_plane(plane, 1), cfg.P)
    for p in range(cfg.P):
        for q in range(cfg.Q):
            assert torch.equal(regrown.x_tile(p, q), plane.x_tile(p, q))
        assert torch.equal(regrown.y_block(p), plane.y_block(p))


def test_grown_plane_rejections(cfg, plane):
    with pytest.raises(ValueError, match="only grows"):
        regrow_plane(plane, cfg.P)
    with pytest.raises(TypeError, match="generation seed"):
        regrow_plane(_plane(cfg, "dense").materialize(), 2 * cfg.P)
    with pytest.raises(TypeError, match="streaming"):
        regrow_plane(_plane(cfg, "streaming"), 2 * cfg.P)
    with pytest.raises(IndexError):
        regrow_plane(plane, 2 * cfg.P).x_tile(2 * cfg.P, 0)


# ---------------------------------------------------------------------------
# run_elastic
# ---------------------------------------------------------------------------
def _elastic(plane, cfg, d, iters=ITERS, seed=1, **kw):
    kw.setdefault("segment_iters", SEGMENT)
    kw.setdefault("lose_partition_at", SEGMENT)
    kw.setdefault("record_every", RECORD)
    return run_elastic(seed, plane, cfg, iters, "reference",
                       checkpoint_dir=d, device="cpu", **kw)


def test_run_elastic_structure_and_report(cfg, plane, tmp_path):
    s, hist, report = _elastic(plane, cfg, str(tmp_path / "e"))
    assert [t for t, _ in hist] == list(range(0, ITERS + 1, RECORD))
    assert s.t == ITERS + 1
    assert report["new_cfg"].P == cfg.P - 1
    assert report["survivors"].P == cfg.P - 1
    assert report["plan"] == {0: [0, 1]}
    assert report["moved_rows"] == cfg.n
    assert any(e.startswith(f"rescale@{SEGMENT}") for e in report["events"])


@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_run_elastic_is_bitwise_its_hand_composition(backend, options, cfg,
                                                     plane, tmp_path):
    """run_elastic is migrate_resumable + run_resumable over shrink_plane,
    done by hand, bitwise."""
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu",
              **options)
    s, hist, report = run_elastic(1, plane, cfg, ITERS, backend,
                                  checkpoint_dir=str(tmp_path / "e"),
                                  lose_partition_at=SEGMENT, **kw)
    s1, h1 = driver.run_resumable(1, plane, cfg, SEGMENT, backend,
                                  checkpoint_dir=str(tmp_path / "h1"), **kw)
    new_cfg = dataclasses.replace(cfg, name=f"{cfg.name}-P1", P=1)
    survivors = shrink_plane(plane, 1)
    driver.migrate_resumable(1, survivors, new_cfg, SEGMENT, s1, backend,
                             checkpoint_dir=str(tmp_path / "h2"),
                             history=h1[:-1], **kw)
    s2, h2 = driver.run_resumable(1, survivors, new_cfg, ITERS, backend,
                                  checkpoint_dir=str(tmp_path / "h2"), **kw)
    assert report["new_cfg"] == new_cfg
    _same((s, hist), (s2, h2))
    assert h2[:len(h1) - 1] == h1[:-1]


def test_run_elastic_deterministic_under_faults(cfg, plane, tmp_path):
    clean = _elastic(plane, cfg, str(tmp_path / "clean"))
    inj = FaultInjector({SEGMENT: 2, 2 * SEGMENT: 1})
    sup = _sup(max_restarts=2)
    faulty = _elastic(plane, cfg, str(tmp_path / "faulty"),
                      on_segment_start=inj, supervisor=sup)
    assert inj.exhausted and sup.total_restarts == 3
    _same(clean[:2], faulty[:2])


def test_run_elastic_converges_to_shrunk_optimum(cfg, tmp_path):
    plane = _plane(cfg)
    s, hist, report = _elastic(plane, cfg, str(tmp_path / "e"), iters=30,
                               seed=2, segment_iters=5,
                               lose_partition_at=10, record_every=5)
    _, h_ref = driver.run(2, shrink_plane(plane, cfg.P - 1),
                          report["new_cfg"], 30, "reference",
                          record_every=5, device="cpu")
    assert_objectives_close(h_ref[-1][1], hist[-1][1], STALENESS,
                            "elastic shrink-P vs from-scratch")
    assert hist[-1][1] < dict(hist)[10]


def test_run_elastic_validates_arguments(cfg, plane, tmp_path):
    d = str(tmp_path / "e")
    with pytest.raises(ValueError, match="segment boundary"):
        _elastic(plane, cfg, d, lose_partition_at=3)
    with pytest.raises(ValueError, match="inside the run"):
        _elastic(plane, cfg, d, lose_partition_at=ITERS)
    with pytest.raises(ValueError, match="shrink"):
        _elastic(plane, cfg, d, new_P=cfg.P + 1)
    with pytest.raises(ValueError, match="partitioned like the run"):
        _elastic(shrink_plane(plane, 1), cfg, d)


def test_migrate_resumable_validates_boundary(cfg, plane, tmp_path):
    state = sodda.init_state(1, cfg.M, "cpu")
    with pytest.raises(ValueError, match="segment boundary"):
        driver.migrate_resumable(1, plane, cfg, 3, state,
                                 checkpoint_dir=str(tmp_path / "m"),
                                 segment_iters=SEGMENT, device="cpu")


class _CountingPlane(DenseDataPlane):
    placements = 0

    def materialize(self):
        self.placements += 1
        return super().materialize()


@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_migrate_places_data_only_for_the_async_warm_up(backend, options,
                                                        cfg, plane,
                                                        tmp_path):
    """Only the async carry's warm-up exchange reads the data at a
    migration; the other backends' carries are the state itself."""
    counting = _CountingPlane(*plane.materialize(), grid=(cfg.P, cfg.Q))
    driver.migrate_resumable(1, counting, cfg, SEGMENT,
                             sodda.init_state(1, cfg.M, "cpu"), backend,
                             checkpoint_dir=str(tmp_path / "m"),
                             segment_iters=SEGMENT, device="cpu", **options)
    assert counting.placements == (backend == "async")
    assert latest_step(str(tmp_path / "m")) == SEGMENT


# ---------------------------------------------------------------------------
# Mid-segment commits
# ---------------------------------------------------------------------------
def test_in_scan_commits_do_not_change_trajectory(cfg, plane, tmp_path):
    committed = []
    kw = dict(segment_iters=SEGMENT, record_every=RECORD)
    bare = _resumable(plane, cfg, ITERS, str(tmp_path / "bare"), **kw)
    cmt = _resumable(plane, cfg, ITERS, str(tmp_path / "cmt"),
                     commit_every=RECORD, keep=99,
                     on_commit=committed.append, **kw)
    _same(bare, cmt)
    assert sorted(committed) == [2, 6, 10]
    assert committed_steps(str(tmp_path / "cmt")) == [2, 4, 6, 8, 10]
    # a mid-segment commit carries the history prefix it has
    step, extra = read_extra(str(tmp_path / "cmt"), step=6)
    assert [t for t, _ in extra["history"]] == [0, 2, 4]
    assert extra["history"] == [list(h) for h in bare[1][:3]]


def test_commit_every_validation(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    for bad in (3, 8, -2):
        with pytest.raises(ValueError, match="commit_every"):
            _resumable(plane, cfg, ITERS, d, segment_iters=SEGMENT,
                       record_every=RECORD, commit_every=bad)


@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_mid_segment_kill_resumes_bitwise(backend, options, cfg, plane,
                                          tmp_path):
    kill_at = SEGMENT + RECORD
    inj = FaultInjector({kill_at: 1})
    d = str(tmp_path / "ckpt")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, **options)
    with pytest.raises(RuntimeError, match="injected fault"):
        _resumable(plane, cfg, ITERS, d, backend, commit_every=RECORD,
                   on_commit=inj, **kw)
    # the commit the fault followed landed, and nothing after it
    assert latest_step(d) == kill_at and committed_steps(d) == [2, 4, 6]
    res = _resumable(plane, cfg, ITERS, d, backend, commit_every=RECORD,
                     **kw)
    full = _resumable(plane, cfg, ITERS, str(tmp_path / "c2"), backend, **kw)
    _same(res, full)


def test_supervisor_absorbs_in_scan_commit_fault(cfg, plane, tmp_path):
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu")
    plain = driver.run_resumable(1, plane, cfg, ITERS, "reference",
                                 checkpoint_dir=str(tmp_path / "plain"), **kw)
    inj = FaultInjector({RECORD: 1, SEGMENT + RECORD: 1})
    sup = _sup(max_restarts=3)
    got = sup.run_resumable(1, plane, cfg, ITERS, "reference",
                            checkpoint_dir=str(tmp_path / "sup"),
                            commit_every=RECORD, on_commit=inj, **kw)
    assert inj.exhausted and sup.total_restarts == 2 and sup.restarts == 1
    _same(plain, got)


@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_replay_segment_verifies_committed_span(backend, options, cfg, plane,
                                                tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu",
              **options)
    driver.run_resumable(1, plane, cfg, ITERS, backend, checkpoint_dir=d,
                         commit_every=RECORD, keep=99, **kw)
    rep = driver.replay_segment(1, plane, cfg, backend, checkpoint_dir=d,
                                step=6, **kw)
    assert rep == {"replayed": True, "start": 4, "end": 6, "match": True}
    rep = driver.replay_segment(1, plane, cfg, backend, checkpoint_dir=d,
                                **kw)
    assert rep["end"] == ITERS and rep["match"] is True
    rep = driver.replay_segment(1, plane, cfg, backend, checkpoint_dir=d,
                                step=committed_steps(d)[0], **kw)
    assert not rep["replayed"] and "predecessor" in rep["reason"]
    rep = driver.replay_segment(1, plane, cfg, backend,
                                checkpoint_dir=str(tmp_path / "empty"), **kw)
    assert not rep["replayed"] and "no committed" in rep["reason"]
    # the span is recomputed: over other data it no longer matches
    other = make_plane("tiled", 5, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")
    rep = driver.replay_segment(1, other, cfg, backend, checkpoint_dir=d,
                                step=6, **kw)
    assert rep["replayed"] and rep["match"] is False


# ---------------------------------------------------------------------------
# Streaming under preemption
# ---------------------------------------------------------------------------
def _prefetch_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("stream-prefetch")]


def test_streaming_kill_leaves_no_prefetch_thread(cfg, stream_plane,
                                                  tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, seed=8)
    inj = FaultInjector({2 * SEGMENT: 1})
    with pytest.raises(Preemption):
        _resumable(stream_plane, cfg, ITERS, d, on_segment=inj, **kw)
    assert _prefetch_threads() == []
    step, extra = read_extra(d)
    assert step == 2 * SEGMENT and extra["stream_epoch"] == 2
    stats = {}
    res = _resumable(stream_plane, cfg, ITERS, d, stream_stats=stats, **kw)
    full = _resumable(stream_plane, cfg, ITERS, str(tmp_path / "c2"), **kw)
    _same(res, full)
    assert stats and _prefetch_threads() == []


def test_streaming_mid_segment_commit_resumes_bitwise(cfg, stream_plane,
                                                      tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, seed=8)
    kill_at = SEGMENT + RECORD
    with pytest.raises(RuntimeError, match="injected fault"):
        _resumable(stream_plane, cfg, ITERS, d, commit_every=RECORD,
                   on_commit=FaultInjector({kill_at: 1}), **kw)
    step, extra = read_extra(d)
    assert step == kill_at and extra["stream_epoch"] == kill_at // SEGMENT
    res = _resumable(stream_plane, cfg, ITERS, d, commit_every=RECORD, **kw)
    full = _resumable(stream_plane, cfg, ITERS, str(tmp_path / "c2"), **kw)
    _same(res, full)


def test_replay_segment_refuses_stream_window_crossing(cfg, stream_plane,
                                                       tmp_path):
    d = str(tmp_path / "ckpt")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu")
    driver.run_resumable(8, stream_plane, cfg, ITERS, "reference",
                         checkpoint_dir=d, commit_every=RECORD, keep=99, **kw)
    rep = driver.replay_segment(8, stream_plane, cfg, "reference",
                                checkpoint_dir=d, step=6, **kw)
    assert rep["replayed"] and rep["match"] is True
    shutil.rmtree(os.path.join(d, f"step_{4:010d}"))
    rep = driver.replay_segment(8, stream_plane, cfg, "reference",
                                checkpoint_dir=d, step=6, **kw)
    assert not rep["replayed"] and "stream window" in rep["reason"]


# ---------------------------------------------------------------------------
# Grow elasticity
# ---------------------------------------------------------------------------
def test_run_elastic_grow_round_trip_structure(cfg, plane, tmp_path):
    d = str(tmp_path / "e")
    s, hist, report = _elastic(plane, cfg, d, regrow_at=2 * SEGMENT,
                               commit_every=RECORD)
    assert [t for t, _ in hist] == list(range(0, ITERS + 1, RECORD))
    assert s.t == ITERS + 1
    assert report["grow_cfg"].P == cfg.P and report["grown"].P == cfg.P
    assert report["grow_plan"] == {0: [0], 1: []}
    assert report["regrown_rows"] == cfg.n
    assert sorted(os.listdir(d)) == ["P1", "P2", "P2-regrown"]
    assert any(e.startswith(f"rescale@{2 * SEGMENT}:P1->P2")
               for e in report["events"])


def test_run_elastic_grow_deterministic_under_faults(cfg, plane, tmp_path):
    kw = dict(segment_iters=RECORD, regrow_at=2 * SEGMENT)
    clean = _elastic(plane, cfg, str(tmp_path / "clean"), **kw)
    inj = FaultInjector({RECORD: 1, SEGMENT + RECORD: 1, 2 * SEGMENT: 1})
    sup = _sup(max_restarts=2)
    faulty = _elastic(plane, cfg, str(tmp_path / "faulty"),
                      on_segment_start=inj, supervisor=sup, **kw)
    assert inj.exhausted and sup.total_restarts == 3
    _same(clean[:2], faulty[:2])


def test_run_elastic_grow_converges_to_regrown_optimum(cfg, tmp_path):
    plane = _plane(cfg)
    s, hist, _ = _elastic(plane, cfg, str(tmp_path / "e"), iters=30, seed=2,
                          segment_iters=5, lose_partition_at=5, regrow_at=10,
                          record_every=5)
    _, h_ref = driver.run(2, plane, cfg, 30, "reference", record_every=5,
                          device="cpu")
    assert_objectives_close(h_ref[-1][1], hist[-1][1], STALENESS,
                            "elastic shrink->grow vs from-scratch")
    assert hist[-1][1] < dict(hist)[10]


def test_run_elastic_grow_validations(cfg, plane, tmp_path):
    d = str(tmp_path / "e")
    with pytest.raises(ValueError, match="regrow_at must be inside"):
        _elastic(plane, cfg, d, regrow_at=SEGMENT)
    with pytest.raises(ValueError, match="regrow_at must be inside"):
        _elastic(plane, cfg, d, regrow_at=ITERS)
    with pytest.raises(ValueError, match="segment boundary"):
        _elastic(plane, cfg, d, regrow_at=SEGMENT + 1)
    with pytest.raises(ValueError, match="regrow_P must exceed"):
        _elastic(plane, cfg, d, regrow_at=2 * SEGMENT, regrow_P=1)
    with pytest.raises(ValueError, match="regrow_P without regrow_at"):
        _elastic(plane, cfg, d, regrow_P=cfg.P)
    with pytest.raises(ValueError, match="shrinks the grid"):
        _elastic(plane, cfg, d, new_P=cfg.P + 1)


# ---------------------------------------------------------------------------
# Straggler response
# ---------------------------------------------------------------------------
def _response_sup(clock, action, patience=2, **kw):
    return SegmentSupervisor(
        straggler=StragglerPolicy(window=8, warmup=1, z_threshold=1.0),
        straggler_patience=patience, straggler_action=action,
        sleep=SleepRecorder(clock), clock=clock, **kw)


def test_straggler_response_config_validation():
    with pytest.raises(ValueError, match="straggler_action"):
        SegmentSupervisor(straggler_action="panic")
    with pytest.raises(ValueError, match="straggler_patience"):
        SegmentSupervisor(straggler_patience=-1)
    with pytest.raises(ValueError, match="ever fire"):
        SegmentSupervisor(straggler_action="rescale")


def test_straggler_streak_resets_on_normal_segment(cfg, plane, tmp_path):
    clock = FakeClock()
    responses = []
    adv = ClockAdvancer(clock, {RECORD: 50.0, 4 * RECORD: 5000.0})
    sup = _response_sup(clock, None,
                        on_straggler_response=lambda *a: responses.append(a))
    sup.run_resumable(1, plane, cfg, ITERS, "reference",
                      checkpoint_dir=str(tmp_path / "c"),
                      segment_iters=RECORD, record_every=RECORD,
                      device="cpu", on_segment_start=adv)
    assert sum(1 for e in sup.events if e.startswith("straggler@")) == 2
    assert responses == []
    assert not any("straggler-response" in e for e in sup.events)


def test_straggler_response_rescale_is_deterministic(cfg, plane, tmp_path):
    def go(sub):
        clock = FakeClock()
        adv = ClockAdvancer(clock, {RECORD: 50.0, 2 * RECORD: 500.0})
        sup = _response_sup(clock, "rescale")
        with pytest.raises(StragglerRescale) as exc:
            sup.run_resumable(1, plane, cfg, ITERS, "reference",
                              checkpoint_dir=str(tmp_path / sub),
                              segment_iters=RECORD, record_every=RECORD,
                              device="cpu", on_segment_start=adv)
        return exc.value, list(sup.events)

    sig1, ev1 = go("a")
    sig2, ev2 = go("b")
    assert (sig1.iters_done, sig1.streak) == (3 * RECORD, 2)
    assert (sig2.iters_done, sig2.streak) == (3 * RECORD, 2)
    assert ev1 == ev2
    assert f"straggler-response@{3 * RECORD}:rescale(streak=2)" in ev1


def test_straggler_response_speculate_confirms_commit(cfg, plane, tmp_path):
    clock = FakeClock()
    adv = ClockAdvancer(clock, {RECORD: 50.0, 2 * RECORD: 500.0})
    sup = _response_sup(clock, "speculate")
    kw = dict(segment_iters=RECORD, record_every=RECORD, device="cpu")
    got = sup.run_resumable(1, plane, cfg, ITERS, "reference",
                            checkpoint_dir=str(tmp_path / "spec"),
                            commit_every=RECORD, on_segment_start=adv, **kw)
    spec = [e for e in sup.events if e.startswith("speculate@")]
    assert spec == [f"speculate@{3 * RECORD}:[{2 * RECORD},{3 * RECORD}] "
                    "match=True"]
    plain = driver.run_resumable(1, plane, cfg, ITERS, "reference",
                                 checkpoint_dir=str(tmp_path / "plain"), **kw)
    _same(plain, got)


def test_run_elastic_auto_shrinks_at_straggler_boundary(cfg, plane,
                                                        tmp_path):
    clock = FakeClock()
    adv = ClockAdvancer(clock, {RECORD: 50.0, 2 * RECORD: 500.0})
    sup = _response_sup(clock, "rescale")
    s, hist, report = run_elastic_auto(
        1, plane, cfg, ITERS, "reference", checkpoint_dir=str(tmp_path / "e"),
        segment_iters=RECORD, record_every=RECORD, device="cpu",
        supervisor=sup, on_segment_start=adv)
    assert report["rescaled"] is True and report["boundary"] == 3 * RECORD
    assert report["new_cfg"].P == cfg.P - 1
    assert [t for t, _ in hist] == list(range(0, ITERS + 1, RECORD))
    assert s.t == ITERS + 1
    assert any(e.startswith(f"rescale@{3 * RECORD}:P{cfg.P}->P{cfg.P - 1}")
               for e in report["events"])


def test_run_elastic_auto_without_stragglers_never_rescales(cfg, plane,
                                                            tmp_path):
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu")
    plain = driver.run_resumable(1, plane, cfg, ITERS, "reference",
                                 checkpoint_dir=str(tmp_path / "plain"), **kw)
    s, hist, report = run_elastic_auto(
        1, plane, cfg, ITERS, "reference", checkpoint_dir=str(tmp_path / "e"),
        supervisor=_response_sup(FakeClock(), "rescale"), **kw)
    assert report["rescaled"] is False
    _same(plain, (s, hist))


def test_run_elastic_auto_converges_to_shrunk_optimum(cfg, tmp_path):
    plane = _plane(cfg)
    clock = FakeClock()
    adv = ClockAdvancer(clock, {5: 50.0, 10: 500.0})
    s, hist, report = run_elastic_auto(
        2, plane, cfg, 30, "reference", checkpoint_dir=str(tmp_path / "e"),
        segment_iters=5, record_every=5, device="cpu",
        supervisor=_response_sup(clock, "rescale"), on_segment_start=adv)
    assert report["rescaled"] and report["boundary"] == 15
    _, h_ref = driver.run(2, shrink_plane(plane, cfg.P - 1),
                          report["new_cfg"], 30, "reference", record_every=5,
                          device="cpu")
    assert_objectives_close(h_ref[-1][1], hist[-1][1], STALENESS,
                            "auto shrink-P vs from-scratch")


def test_run_elastic_auto_validates_supervisor(cfg, plane, tmp_path):
    with pytest.raises(ValueError, match="straggler_action='rescale'"):
        run_elastic_auto(1, plane, cfg, ITERS,
                         checkpoint_dir=str(tmp_path / "e"),
                         segment_iters=SEGMENT, device="cpu",
                         supervisor=SegmentSupervisor())
    with pytest.raises(ValueError, match="shrinks the grid"):
        run_elastic_auto(1, plane, cfg, ITERS,
                         checkpoint_dir=str(tmp_path / "e"),
                         segment_iters=SEGMENT, device="cpu", new_P=cfg.P)


# ---------------------------------------------------------------------------
# Invariants without a run
# ---------------------------------------------------------------------------
def test_backoff_delay_monotone_and_capped():
    sup = _sup(backoff_base_s=0.05, backoff_max_s=1.0)
    delays = [sup.backoff_delay(a) for a in range(1, 16)]
    assert delays[0] == pytest.approx(0.05)
    assert all(b >= a for a, b in zip(delays, delays[1:]))
    assert max(delays) == 1.0
    with pytest.raises(ValueError, match="1-based"):
        sup.backoff_delay(0)


def test_note_failure_budget_resets_exactly_on_strictly_newer():
    sup = _sup(max_restarts=2)
    assert sup.note_failure(None) is not None
    assert sup.note_failure(None) is not None
    assert sup.note_failure(4) is not None
    assert sup.restarts == 1
    assert sup.note_failure(4) is not None
    assert sup.note_failure(4) is None
    assert sup.total_restarts == 5


def test_straggler_p50_is_trailing_window_median():
    sp = StragglerPolicy(window=4, warmup=1)
    for d in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        sp.record(d)
    assert len(sp._durations) == 4
    assert sp.p50 == pytest.approx(np.median([3.0, 4.0, 5.0, 6.0]))


@pytest.mark.parametrize("ratio,budget", [(1.02, 0.25), (1.5, 0.25),
                                          (3.0, 0.25), (0.98, 0.1),
                                          (1.2, 0.0)])
def test_suggest_commit_every_matches_reference(ratio, budget):
    block = {"segment_iters": 12, "record_every": 2,
             "in_scan_commit_overhead_ratio": ratio,
             "cells": {"commit_every_small": {"commit_every": 2}}}
    assert suggest_commit_every(block, max_overhead=budget) == \
        ref_ft.suggest_commit_every(block, max_overhead=budget)


# ---------------------------------------------------------------------------
# The elastic layer against the reference's
# ---------------------------------------------------------------------------
REF_KEY = jax.random.PRNGKey(0)


class _ReferenceTiles(DataPlane):
    """A port plane serving the reference's ``PRNGKey(seed)`` tiles as CPU
    tensors, with the port's ``generation_seed`` naming that key."""

    def __init__(self, N, M, P, Q, seed=0, flip_prob=0.01):
        self._init_grid(N, M, P, Q)
        self.seed, self.flip_prob = seed, flip_prob
        self.device = torch.device("cpu")
        self._ref = ref_plane.TiledDataPlane(jax.random.PRNGKey(seed), N, M,
                                             P, Q, flip_prob=flip_prob)

    def x_tile(self, p, q):
        return torch.tensor(np.asarray(self._ref.x_tile(p, q)))

    def y_block(self, p):
        return torch.tensor(np.asarray(self._ref.y_block(p)))


@pytest.fixture
def reference_regrowth(monkeypatch):
    """Regrown partitions generated by the reference's tile generators
    from ``PRNGKey(generation_seed)``, so a port regrowth over
    :class:`_ReferenceTiles` can be held bitwise to the reference's."""
    def svm_tile_x(seed, p, q, n, m, device=None):
        return torch.tensor(np.asarray(ref_synthetic.svm_tile_x(
            jax.random.PRNGKey(seed), p, q, n, m)))

    def svm_label_block(seed, p, n, Q, m, flip_prob=0.01, device=None):
        return torch.tensor(np.asarray(ref_synthetic.svm_label_block(
            jax.random.PRNGKey(seed), p, n, Q, m, flip_prob=flip_prob)))

    monkeypatch.setattr(port_ft, "synthetic", types.SimpleNamespace(
        svm_tile_x=svm_tile_x, svm_label_block=svm_label_block))


def _same_plane(port, ref):
    assert (port.N, port.M, port.P, port.Q, port.n, port.m) == \
        (ref.N, ref.M, ref.P, ref.Q, ref.n, ref.m)
    for p in range(ref.P):
        for q in range(ref.Q):
            assert np.array_equal(port.x_tile(p, q).numpy(),
                                  np.asarray(ref.x_tile(p, q)))
        assert np.array_equal(port.y_block(p).numpy(),
                              np.asarray(ref.y_block(p)))
    for got, want in zip(port.materialize(), ref.materialize()):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for plane in (port, ref):
        with pytest.raises(IndexError):
            plane.x_tile(ref.P, 0)
        with pytest.raises(IndexError):
            plane.y_block(ref.P)


@pytest.mark.parametrize("new_P", [1, 2, 3])
def test_shrink_plane_matches_reference(new_P):
    """On the same numpy (X, y), the port's survivors are the reference's,
    bitwise, tile by tile and assembled."""
    rng = np.random.default_rng(new_P)
    X = rng.standard_normal((32, 12)).astype(np.float32)
    y = np.sign(rng.standard_normal(32)).astype(np.float32)
    ref = ref_ft.shrink_plane(
        ref_plane.DenseDataPlane(jnp.asarray(X), jnp.asarray(y),
                                 grid=(4, 3)), new_P)
    port = shrink_plane(DenseDataPlane(torch.tensor(X), torch.tensor(y),
                                       grid=(4, 3)), new_P)
    _same_plane(port, ref)


@pytest.mark.parametrize("new_P,grow_P", [(1, 4), (2, 3), (3, 6)])
def test_shrink_and_regrow_planes_match_reference(new_P, grow_P,
                                                  reference_regrowth):
    """A shrink, then a regrowth from the generation seed, picks the same
    partitions and regenerates the same ones as the reference's."""
    ref = ref_plane.TiledDataPlane(jax.random.PRNGKey(0), 32, 12, 4, 3)
    port = _ReferenceTiles(32, 12, 4, 3)
    ref_shrunk = ref_ft.shrink_plane(ref, new_P)
    shrunk = shrink_plane(port, new_P)
    _same_plane(shrunk, ref_shrunk)
    _same_plane(regrow_plane(shrunk, grow_P),
                ref_ft.regrow_plane(ref_shrunk, grow_P))


@pytest.mark.parametrize("new_P", [1, 2, 4, 8, 3, 0])
def test_rescale_config_matches_reference(new_P):
    """The rescaled config, field by field and in its derived sizes, is the
    reference's ``rescale_bundle``'s, and a grid that cannot split is
    refused with the same message."""
    ref_cfg = small_fixture_config()
    cfg = port_configs.SoddaConfig(**dataclasses.asdict(ref_cfg))
    try:
        want, _, _ = ref_engine.rescale_bundle(ref_cfg, "reference", new_P)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            engine.rescale_config(cfg, new_P)
        assert str(got.value) == str(exc)
        with pytest.raises(ValueError) as got:
            engine.rescale_bundle(cfg, "reference", new_P, device="cpu")
        assert str(got.value) == str(exc)
        return
    for new_cfg in (engine.rescale_config(cfg, new_P),
                    engine.rescale_bundle(cfg, "reference", new_P,
                                          device="cpu")[0]):
        assert dataclasses.asdict(new_cfg) == dataclasses.asdict(want)
        assert (new_cfg.N, new_cfg.M, new_cfg.m_tilde) == \
            (want.N, want.M, want.m_tilde)


def _phase_sampler(phases):
    """Replays the reference's draws of an elastic run: ``phases`` lists
    ``(first_t, ref_cfg)`` in order, and iteration t draws on the grid of
    the last phase that has begun by t."""
    def sampler(t):
        ref_cfg = [c for first_t, c in phases if t >= first_t][-1]
        s = jax_partition.sample_iteration(
            REF_KEY, jnp.int32(t), ref_cfg.P, ref_cfg.Q, ref_cfg.n,
            ref_cfg.M, ref_cfg.L, *jax_sodda._counts(ref_cfg))
        return partition.sample_from_numpy(*(np.asarray(f) for f in s),
                                           device="cpu")

    return sampler


ELASTIC_CROSS = [("reference", {}, None), ("reference", {}, 2 * SEGMENT),
                 ("async", {"staleness": 1}, None)]


@pytest.mark.parametrize("backend,options,regrow_at", ELASTIC_CROSS,
                         ids=["reference-shrink", "reference-regrow",
                              "async-s1-shrink"])
def test_run_elastic_matches_reference(backend, options, regrow_at, tmp_path,
                                       reference_regrowth):
    """The port's ``run_elastic`` over the reference's tiles, with the
    reference's draws replayed on each phase's grid, is within
    F32_REDUCTION of the reference's ``run_elastic``: the same plans,
    rescaled configs and history ticks, each objective (the spliced tick
    at each rescale over the new data) and the final iterate."""
    ref_cfg = small_fixture_config()
    cfg = port_configs.SoddaConfig(**dataclasses.asdict(ref_cfg))
    grow = {} if regrow_at is None else {"regrow_at": regrow_at}
    kw = dict(segment_iters=SEGMENT, lose_partition_at=SEGMENT,
              record_every=RECORD, **grow, **options)
    ref_state, ref_hist, ref_report = ref_ft.run_elastic(
        REF_KEY, ref_plane.TiledDataPlane(REF_KEY, cfg.N, cfg.M, cfg.P,
                                          cfg.Q),
        ref_cfg, ITERS, backend, checkpoint_dir=str(tmp_path / "jax"), **kw)
    new_cfg = ref_report["new_cfg"]
    phases = [(0, ref_cfg), (SEGMENT + 1, new_cfg)]
    if regrow_at is not None:
        phases.append((regrow_at + 1, ref_report["grow_cfg"]))
    state, hist, report = run_elastic(
        0, _ReferenceTiles(cfg.N, cfg.M, cfg.P, cfg.Q), cfg, ITERS, backend,
        checkpoint_dir=str(tmp_path / "port"), device="cpu",
        sampler=_phase_sampler(phases), **kw)
    for k in ("plan", "moved_rows", "grow_plan", "regrown_rows"):
        assert report.get(k) == ref_report.get(k), k
    for k in ("new_cfg", "grow_cfg"):
        if k in ref_report:
            assert dataclasses.asdict(report[k]) == \
                dataclasses.asdict(ref_report[k]), k
    assert [t for t, _ in hist] == [t for t, _ in ref_hist]
    for (t, f_ref), (_, f) in zip(ref_hist, hist):
        assert_objectives_close(f_ref, f, F32_REDUCTION,
                                f"elastic {backend} t={t}")
    assert_trajectories_close([np.asarray(ref_state.w)], [state.w.numpy()],
                              F32_REDUCTION, f"elastic {backend} final w")
    assert int(state.t) == int(ref_state.t) == ITERS + 1
