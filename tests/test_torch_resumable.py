"""``repro_torch.core.driver.run_resumable`` against
``repro.core.driver.run_resumable``.

On the port alone, every case of ``tests/test_resumable.py``: a run killed
between segments and resumed is BITWISE the uninterrupted one, and with no
kill it is BITWISE ``driver.run``, for ``reference``, ``cuda`` (its plain
path on the CPU), ``async`` at staleness 0 and 1 and ``radisa-avg``, on
static and streaming planes; every resume-guard refusal of the reference
is matched.

Across the packages a checkpoint carries state, not draws: the reference
writes a boundary checkpoint over numpy data with ``PRNGKey(0)`` and the
port resumes it with ``sampler`` replaying the reference's draws (and the
reverse). The resumed run is held to F32_REDUCTION of the reference's
uninterrupted one, the history written before the kill bitwise.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import driver as jax_driver
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.testing import make_problem, small_fixture_config
from repro.testing.tolerances import (F32_REDUCTION, assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.checkpoint import latest_step, read_extra
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import driver, partition
from repro_torch.data.plane import make_plane
from repro_torch.distributed import SegmentSupervisor
from repro_torch.testing.faults import FakeClock, FaultInjector, SleepRecorder

ITERS, SEGMENT, RECORD = 10, 4, 2
SETTINGS = [("reference", {}), ("cuda", {}), ("async", {"staleness": 0}),
            ("async", {"staleness": 1}), ("radisa-avg", {})]
IDS = ["reference", "cuda", "async-s0", "async-s1", "radisa-avg"]


@pytest.fixture(scope="module")
def cfg():
    return port_configs.SoddaConfig(
        **dataclasses.asdict(small_fixture_config()))


def _plane(cfg, kind="tiled", seed=0):
    return make_plane(kind, seed, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")


@pytest.fixture(scope="module")
def plane(cfg):
    return _plane(cfg)


@pytest.fixture(scope="module")
def stream_plane(cfg):
    return _plane(cfg, "streaming")


def _resumable(seed, data, cfg, iters, backend="reference", **kw):
    return driver.run_resumable(seed, data, cfg, iters, backend,
                                device="cpu", **kw)


def _assert_same_run(a, b, msg=""):
    (s_a, h_a), (s_b, h_b) = a, b
    assert h_a == h_b, f"{msg}: histories differ"
    assert torch.equal(s_a.w, s_b.w), f"{msg}: final iterates differ"
    assert s_a.t == s_b.t and s_a.seed == s_b.seed


# ---------------------------------------------------------------------------
# Every case of tests/test_resumable.py, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_kill_and_resume_is_bitwise(backend, options, cfg, plane, tmp_path):
    killed_at = []

    def preempt(done):
        killed_at.append(done)
        if done == 2 * SEGMENT:
            raise RuntimeError("injected preemption")

    d = str(tmp_path / "ckpt")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, **options)
    with pytest.raises(RuntimeError, match="injected preemption"):
        _resumable(1, plane, cfg, ITERS, backend, checkpoint_dir=d,
                   on_segment=preempt, **kw)
    assert latest_step(d) == 2 * SEGMENT  # the kill landed after the save
    res = _resumable(1, plane, cfg, ITERS, backend, checkpoint_dir=d, **kw)
    full = _resumable(1, plane, cfg, ITERS, backend,
                      checkpoint_dir=str(tmp_path / "c2"), **kw)
    _assert_same_run(res, full, backend)
    assert res[0].t == ITERS + 1
    assert not hasattr(res[0], "mu")  # finalize stripped the async carry


@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_supervised_kill_and_resume_is_bitwise(backend, options, cfg, plane,
                                               tmp_path):
    inj_end = FaultInjector({SEGMENT: 1})
    inj_start = FaultInjector({2 * SEGMENT: 1})
    sleeps = SleepRecorder()
    sup = SegmentSupervisor(max_restarts=3, sleep=sleeps, clock=FakeClock())
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu",
              **options)
    sup_run = sup.run_resumable(1, plane, cfg, ITERS, backend,
                                checkpoint_dir=str(tmp_path / "sup"),
                                on_segment=inj_end,
                                on_segment_start=inj_start, **kw)
    full = driver.run_resumable(1, plane, cfg, ITERS, backend,
                                checkpoint_dir=str(tmp_path / "c2"), **kw)
    assert inj_end.exhausted and inj_start.exhausted
    assert sup.total_restarts == 2 and len(sleeps.delays) == 2
    _assert_same_run(sup_run, full, backend)


@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_segmented_matches_one_dispatch_run(backend, options, cfg, plane,
                                            tmp_path):
    """With no kill, run_resumable is bitwise driver.run."""
    seg = _resumable(1, plane, cfg, ITERS, backend,
                     checkpoint_dir=str(tmp_path / "c"),
                     segment_iters=SEGMENT, record_every=RECORD, **options)
    one = driver.run(1, plane, cfg, ITERS, backend, record_every=RECORD,
                     device="cpu", **options)
    _assert_same_run(seg, one, backend)


def test_resume_of_completed_run_recomputes_nothing(cfg, plane, tmp_path,
                                                    monkeypatch):
    d = str(tmp_path / "c")
    first = _resumable(2, plane, cfg, 8, checkpoint_dir=d, segment_iters=4,
                       record_every=2)
    assert latest_step(d) == 8
    from repro_torch.core import sodda
    steps, calls = [], []
    real = sodda.sodda_step
    monkeypatch.setattr(sodda, "sodda_step",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    again = _resumable(2, plane, cfg, 8, checkpoint_dir=d, segment_iters=4,
                       record_every=2, on_segment=calls.append)
    assert calls == [] and steps == []  # no segment and no step ran
    _assert_same_run(first, again)


def test_history_ticks_match_record_ticks(cfg, plane, tmp_path):
    _, hist = _resumable(3, plane, cfg, 7, checkpoint_dir=str(tmp_path / "c"),
                         segment_iters=3, record_every=3)
    assert [t for t, _ in hist] == list(driver.record_ticks(7, 3))


def test_run_resumable_validates_arguments(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    with pytest.raises(ValueError, match="segment_iters"):
        _resumable(0, plane, cfg, 4, checkpoint_dir=d, segment_iters=0)
    with pytest.raises(ValueError, match="multiple of"):
        _resumable(0, plane, cfg, 4, checkpoint_dir=d, segment_iters=3,
                   record_every=2)
    _resumable(0, plane, cfg, 6, checkpoint_dir=d, segment_iters=3)
    with pytest.raises(ValueError, match="beyond the requested"):
        _resumable(0, plane, cfg, 4, checkpoint_dir=d, segment_iters=2)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        _resumable(2 ** 32, plane, cfg, 4, checkpoint_dir=str(tmp_path / "s"),
                   segment_iters=2)


def test_resume_refuses_changed_parameters(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(4, plane, cfg, 4, checkpoint_dir=d, segment_iters=4,
               record_every=4)
    with pytest.raises(ValueError, match="record_every"):
        _resumable(4, plane, cfg, 8, checkpoint_dir=d, segment_iters=4,
                   record_every=2)
    with pytest.raises(ValueError, match="backend"):
        _resumable(4, plane, cfg, 8, "async", checkpoint_dir=d,
                   segment_iters=4, record_every=4)
    with pytest.raises(ValueError, match="segment_iters"):
        _resumable(4, plane, cfg, 8, checkpoint_dir=d, segment_iters=8,
                   record_every=4)
    s, hist = _resumable(4, plane, cfg, 8, checkpoint_dir=d, segment_iters=4,
                         record_every=4)
    assert [t for t, _ in hist] == [0, 4, 8]
    assert s.t == 9


def test_resume_compares_backend_names_literally(cfg, plane, tmp_path):
    """The port stamps its own names (`cuda`, not the reference's
    `pallas`): a `cuda` checkpoint does not resume as `reference`, though
    both step the same arithmetic on the CPU."""
    d = str(tmp_path / "c")
    _resumable(4, plane, cfg, 4, "cuda", checkpoint_dir=d, segment_iters=4)
    assert read_extra(d)[1]["backend"] == "cuda"
    with pytest.raises(ValueError, match="backend='cuda'"):
        _resumable(4, plane, cfg, 8, "reference", checkpoint_dir=d,
                   segment_iters=4)


def test_resume_refuses_changed_engine_options(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(5, plane, cfg, 4, "async", checkpoint_dir=d, segment_iters=4,
               staleness=1)
    with pytest.raises(ValueError, match="options"):
        _resumable(5, plane, cfg, 8, "async", checkpoint_dir=d,
                   segment_iters=4, staleness=0)
    s, hist = _resumable(5, plane, cfg, 8, "async", checkpoint_dir=d,
                         segment_iters=4, staleness=1)
    assert s.t == 9 and hist[-1][0] == 8


def test_resume_refuses_changed_key(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(1, plane, cfg, 4, checkpoint_dir=d, segment_iters=4)
    assert read_extra(d)[1]["key"] == [0, 1]  # PRNGKey(1)
    with pytest.raises(ValueError, match="key"):
        _resumable(2, plane, cfg, 8, checkpoint_dir=d, segment_iters=4)


def test_resume_refuses_different_data(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(6, plane, cfg, 4, checkpoint_dir=d, segment_iters=4)
    with pytest.raises(ValueError, match="data"):
        _resumable(6, _plane(cfg, seed=123), cfg, 8, checkpoint_dir=d,
                   segment_iters=4)
    # the dense plane of the same seed is the same data (bitwise)
    s, hist = _resumable(6, _plane(cfg, "dense"), cfg, 8, checkpoint_dir=d,
                         segment_iters=4)
    assert s.t == 9 and hist[-1][0] == 8


def _rewrite_extra(ckpt_dir, fn):
    step_dir = os.path.join(ckpt_dir, f"step_{latest_step(ckpt_dir):010d}")
    path = os.path.join(step_dir, "manifest.json")
    with open(path) as f:
        man = json.load(f)
    man["extra"] = fn(dict(man["extra"]))
    with open(path, "w") as f:
        json.dump(man, f)


def _without(key):
    def drop(extra):
        del extra[key]
        return extra
    return drop


def test_resume_refuses_stampless_checkpoint(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(7, plane, cfg, 4, checkpoint_dir=d, segment_iters=4)
    _rewrite_extra(d, lambda extra: {"history": extra["history"]})
    with pytest.raises(ValueError, match="no resume-guard stamp"):
        _resumable(7, plane, cfg, 8, checkpoint_dir=d, segment_iters=4)


def test_resume_refuses_partially_stamped_checkpoint(cfg, plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(7, plane, cfg, 4, checkpoint_dir=d, segment_iters=4)
    _rewrite_extra(d, _without("data"))
    with pytest.raises(ValueError, match=r"no resume-guard stamp.*data"):
        _resumable(7, plane, cfg, 8, checkpoint_dir=d, segment_iters=4)


def test_resume_refuses_off_cadence_checkpoint(cfg, plane, tmp_path):
    """A commit off the record_every cadence is not one this run could have
    written."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core import sodda
    d = str(tmp_path / "c")
    _resumable(7, plane, cfg, 4, checkpoint_dir=d, segment_iters=4,
               record_every=2)
    _, extra = read_extra(d)
    state = sodda.init_state(7, cfg.M, "cpu")
    save_checkpoint(d, 5, sodda.carry_record(state), extra=extra)
    with pytest.raises(ValueError, match="record_every=2 cadence"):
        _resumable(7, plane, cfg, 8, checkpoint_dir=d, segment_iters=4,
                   record_every=2)


# ---------------------------------------------------------------------------
# Streaming plane through the segment driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,options", SETTINGS, ids=IDS)
def test_streaming_kill_and_resume_is_bitwise(backend, options, cfg,
                                              stream_plane, tmp_path):
    def preempt(done):
        if done == 2 * SEGMENT:
            raise RuntimeError("injected preemption")

    d = str(tmp_path / "ckpt")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, **options)
    with pytest.raises(RuntimeError, match="injected preemption"):
        _resumable(8, stream_plane, cfg, ITERS, backend, checkpoint_dir=d,
                   on_segment=preempt, **kw)
    res = _resumable(8, stream_plane, cfg, ITERS, backend, checkpoint_dir=d,
                     **kw)
    full = _resumable(8, stream_plane, cfg, ITERS, backend,
                      checkpoint_dir=str(tmp_path / "c2"), **kw)
    _assert_same_run(res, full, backend)


def test_streaming_run_differs_from_static_after_epoch_zero(cfg, stream_plane,
                                                            plane, tmp_path):
    kw = dict(segment_iters=SEGMENT, record_every=RECORD)
    s_stream, _ = _resumable(9, stream_plane, cfg, ITERS,
                             checkpoint_dir=str(tmp_path / "a"), **kw)
    s_static, _ = _resumable(9, plane, cfg, ITERS,
                             checkpoint_dir=str(tmp_path / "b"), **kw)
    assert not torch.equal(s_stream.w, s_static.w)
    # one segment is one window: epoch 0, which is the tiled plane's data
    one_stream = _resumable(9, stream_plane, cfg, SEGMENT,
                            checkpoint_dir=str(tmp_path / "c"), **kw)
    one_static = _resumable(9, plane, cfg, SEGMENT,
                            checkpoint_dir=str(tmp_path / "d"), **kw)
    _assert_same_run(one_stream, one_static, "single-segment stream")


def test_resume_refuses_missing_stream_cursor(cfg, stream_plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(10, stream_plane, cfg, 4, checkpoint_dir=d, segment_iters=4)
    _rewrite_extra(d, _without("stream_epoch"))
    with pytest.raises(ValueError, match="no stream_epoch cursor"):
        _resumable(10, stream_plane, cfg, 8, checkpoint_dir=d,
                   segment_iters=4)


def test_resume_refuses_tampered_stream_cursor(cfg, stream_plane, tmp_path):
    d = str(tmp_path / "c")
    _resumable(10, stream_plane, cfg, 4, checkpoint_dir=d, segment_iters=4)

    def bump(extra):
        extra["stream_epoch"] += 3
        return extra

    _rewrite_extra(d, bump)
    with pytest.raises(ValueError, match="stream_epoch"):
        _resumable(10, stream_plane, cfg, 8, checkpoint_dir=d,
                   segment_iters=4)


def test_resume_refuses_streaming_static_crossover(cfg, stream_plane, plane,
                                                   tmp_path):
    d1 = str(tmp_path / "stream")
    _resumable(11, stream_plane, cfg, 4, checkpoint_dir=d1, segment_iters=4)
    with pytest.raises(ValueError, match="streaming"):
        _resumable(11, plane, cfg, 8, checkpoint_dir=d1, segment_iters=4)
    d2 = str(tmp_path / "static")
    _resumable(11, plane, cfg, 4, checkpoint_dir=d2, segment_iters=4)
    with pytest.raises(ValueError, match="streaming"):
        _resumable(11, stream_plane, cfg, 8, checkpoint_dir=d2,
                   segment_iters=4)


def test_streaming_run_reports_prefetch_stats(cfg, stream_plane, tmp_path):
    stats = {}
    _resumable(12, stream_plane, cfg, ITERS,
               checkpoint_dir=str(tmp_path / "c"), segment_iters=SEGMENT,
               record_every=RECORD, stream_stats=stats)
    assert stats["consumed"] >= ITERS // SEGMENT
    assert 0.0 <= stats["overlap_ratio"] <= 1.0
    assert stats["cache"]["misses"] > 0


@pytest.mark.parametrize("depth", [1, 2])
def test_streaming_prefetch_depth_never_changes_the_run(depth, cfg, tmp_path):
    """Depth changes residency and overlap only; the run is bitwise a loop
    that places each window on the calling thread, with no prefetcher."""
    from repro_torch.core import engine, losses, sodda
    plane = _plane(cfg, "streaming")
    got = _resumable(13, plane, cfg, ITERS,
                     checkpoint_dir=str(tmp_path / "c"),
                     segment_iters=SEGMENT, record_every=RECORD,
                     prefetch_depth=depth)
    bundle = engine.make_bundle(cfg, "reference", device="cpu")
    carry, hist = sodda.init_state(13, cfg.M, "cpu"), []
    for done in range(0, ITERS, SEGMENT):
        X, y = plane.at_epoch(done // SEGMENT).materialize()
        for it in range(done, min(done + SEGMENT, ITERS)):
            if it % RECORD == 0:
                hist.append((it, float(losses.objective(cfg.loss, X, y,
                                                        carry.w))))
            carry = bundle.step(carry, X, y)
    hist.append((ITERS, float(losses.objective(cfg.loss, X, y, carry.w))))
    _assert_same_run(got, (carry, hist), f"depth {depth}")


# ---------------------------------------------------------------------------
# Across the packages: state, not draws
# ---------------------------------------------------------------------------
KEY = jax.random.PRNGKey(0)
CROSS = [("reference", {}), ("async", {"staleness": 1})]
CROSS_IDS = ["reference", "async-s1"]


@functools.lru_cache(maxsize=None)
def _problem():
    cfg = small_fixture_config()
    X, y = make_problem(cfg)
    return cfg, np.array(X), np.array(y)


def _replay(cfg):
    b, c, d = jax_sodda._counts(cfg)

    def sampler(t):
        s = jax_partition.sample_iteration(KEY, jnp.int32(t), cfg.P, cfg.Q,
                                           cfg.n, cfg.M, cfg.L, b, c, d)
        return partition.sample_from_numpy(*(np.asarray(f) for f in s),
                                           device="cpu")

    return sampler


def _kill_at(boundary):
    def preempt(done):
        if done == boundary:
            raise RuntimeError("injected preemption")
    return preempt


def _jax_resumable(d, X, y, cfg, backend, options, **kw):
    return jax_driver.run_resumable(
        KEY, (jnp.asarray(X), jnp.asarray(y)), cfg, ITERS, backend,
        checkpoint_dir=d, segment_iters=SEGMENT, record_every=RECORD,
        **options, **kw)


def _port_resumable(d, X, y, cfg, backend, options, **kw):
    return driver.run_resumable(
        0, (torch.tensor(X), torch.tensor(y)),
        port_configs.SoddaConfig(**dataclasses.asdict(cfg)), ITERS, backend,
        checkpoint_dir=d, segment_iters=SEGMENT, record_every=RECORD,
        device="cpu", sampler=_replay(cfg), **options, **kw)


def _assert_cross(final, hist, ref_final, ref_hist, prefix, msg):
    assert [t for t, _ in hist] == [t for t, _ in ref_hist]
    assert hist[:len(prefix)] == prefix, f"{msg}: restored history moved"
    for (t, f_ref), (_, f) in zip(ref_hist, hist):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"{msg} t={t}")
    assert_trajectories_close([np.asarray(ref_final.w)],
                              [np.asarray(final.w)], F32_REDUCTION,
                              f"{msg} final w")
    assert int(final.t) == int(ref_final.t) == ITERS + 1


@pytest.mark.parametrize("backend,options", CROSS, ids=CROSS_IDS)
def test_jax_boundary_checkpoint_resumes_in_the_port(backend, options,
                                                     tmp_path):
    cfg, X, y = _problem()
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected preemption"):
        _jax_resumable(d, X, y, cfg, backend, options,
                       on_segment=_kill_at(SEGMENT))
    assert latest_step(d) == SEGMENT
    _, written = read_extra(d)
    ref_final, ref_hist = _jax_resumable(str(tmp_path / "full"), X, y, cfg,
                                         backend, options)
    final, hist = _port_resumable(d, X, y, cfg, backend, options)
    prefix = [(int(t), float(f)) for t, f in written["history"]]
    assert prefix == ref_hist[:len(prefix)]
    _assert_cross(final, hist, ref_final, ref_hist, prefix,
                  f"jax -> port {backend}")


@pytest.mark.parametrize("backend,options", CROSS, ids=CROSS_IDS)
def test_port_boundary_checkpoint_resumes_in_jax(backend, options, tmp_path):
    cfg, X, y = _problem()
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected preemption"):
        _port_resumable(d, X, y, cfg, backend, options,
                        on_segment=_kill_at(SEGMENT))
    assert latest_step(d) == SEGMENT
    _, written = read_extra(d)
    ref_final, ref_hist = _jax_resumable(str(tmp_path / "full"), X, y, cfg,
                                         backend, options)
    final, hist = _jax_resumable(d, X, y, cfg, backend, options)
    prefix = [(int(t), float(f)) for t, f in written["history"]]
    _assert_cross(final, hist, ref_final, ref_hist, prefix,
                  f"port -> jax {backend}")
