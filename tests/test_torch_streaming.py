"""The port's ``streaming`` data plane and ``StreamPrefetcher``
(``repro_torch.data.plane``) against ``repro.data.plane``.

The port draws its own bits, so the streaming cases of
``tests/test_data_plane.py`` are held on the port alone: epoch 0 is the
``tiled`` plane bitwise, every epoch is a fresh window labelled against
the base seed's separator, the LRU budget regenerates bitwise, and the
prefetcher hands back exactly what a placement on the calling thread
gives. Against the JAX package, the port's streaming driver over a plane
that serves the reference's stream tiles is held to F32_REDUCTION of the
reference's streaming run, with the reference's draws replayed.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import driver as jax_driver
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.data import synthetic as ref_synthetic
from repro.testing import make_data_plane, small_fixture_config
from repro.testing.tolerances import (F32_REDUCTION, assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import driver, partition
from repro_torch.core.partition import _iteration_seed
from repro_torch.data.plane import (DataPlane, StreamingDataPlane,
                                    StreamPrefetcher, TiledDataPlane,
                                    make_plane)
from repro_torch.data.synthetic import (stream_epoch_seed,
                                        svm_feature_block_z,
                                        svm_label_block,
                                        svm_stream_label_block,
                                        svm_stream_tile_x, svm_tile_x)


def _stream(seed, N, M, P, Q, **kw):
    return StreamingDataPlane(seed, N, M, P, Q, device="cpu", **kw)


def test_streaming_epoch_zero_is_tiled_bitwise():
    tiled = TiledDataPlane(7, 24, 12, 3, 2, device="cpu")
    stream = _stream(7, 24, 12, 3, 2)
    assert stream.epoch == 0 and stream.is_streaming
    for p in range(3):
        assert torch.equal(stream.y_block(p), tiled.y_block(p))
        for q in range(2):
            assert torch.equal(stream.x_tile(p, q), tiled.x_tile(p, q))
    Xs, ys = stream.materialize()
    Xt, yt = tiled.materialize()
    assert torch.equal(Xs, Xt) and torch.equal(ys, yt)


def test_streaming_epochs_are_distinct_windows():
    stream = _stream(3, 16, 8, 2, 2)
    tiles = [stream.x_tile_at(e, 0, 0) for e in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(tiles[i], tiles[j])


def test_streaming_at_epoch_views_share_cache():
    stream = _stream(5, 16, 8, 2, 2)
    view = stream.at_epoch(2)
    assert view is not stream and view.epoch == 2 and stream.epoch == 0
    assert stream.at_epoch(0) is stream
    assert torch.equal(view.x_tile(1, 0), stream.x_tile_at(2, 1, 0))
    assert stream.cache_stats["hits"] >= 1
    with pytest.raises(ValueError, match="stream epoch"):
        stream.at_epoch(-1)


def test_static_plane_has_no_epochs():
    plane = TiledDataPlane(0, 8, 8, 2, 2, device="cpu")
    assert plane.at_epoch(0) is plane and not plane.is_streaming
    with pytest.raises(ValueError, match="no epoch"):
        plane.at_epoch(1)
    with pytest.raises(ValueError, match="no epoch"):
        plane.materialize_for("reference", epoch=3)


def test_streaming_budget_bounds_residency_and_regenerates_bitwise():
    stream = _stream(9, 16, 8, 2, 2, resident_tile_budget=3)
    first = {}
    for e in range(3):
        for p in range(2):
            for q in range(2):
                first[(e, p, q)] = stream.x_tile_at(e, p, q).clone()
                assert stream.cache_stats["resident"] <= 3
    for (e, p, q), tile in first.items():
        assert torch.equal(stream.x_tile_at(e, p, q), tile)
    assert stream.cache_stats["misses"] > 12


def test_streaming_zero_budget_disables_caching():
    stream = _stream(1, 8, 8, 2, 2, resident_tile_budget=0)
    assert torch.equal(stream.x_tile(0, 0), stream.x_tile(0, 0))
    assert stream.cache_stats["resident"] == 0
    assert stream.cache_stats["hits"] == 0


@pytest.mark.parametrize("epoch", [0, 2])
def test_streaming_materialize_bypasses_the_cache(epoch):
    """An assembled window is the resident copy of its tiles: materialize
    leaves the tile cache empty at the default budget and gives the
    per-tile reads' bits."""
    stream = _stream(7, 16, 8, 2, 2).at_epoch(epoch)
    X, y = stream.materialize()
    assert stream.cache_stats == {"hits": 0, "misses": 0, "resident": 0}
    for p in range(2):
        for q in range(2):
            assert torch.equal(X[8 * p:8 * (p + 1), 4 * q:4 * (q + 1)],
                               stream.x_tile(p, q))
        assert torch.equal(y[8 * p:8 * (p + 1)], stream.y_block(p))
    assert stream.cache_stats["misses"] == 6


def test_streaming_default_budget_is_two_windows():
    assert _stream(1, 16, 8, 2, 2).resident_tile_budget == 2 * (2 * 2 + 2)
    with pytest.raises(ValueError, match="resident_tile_budget"):
        _stream(1, 16, 8, 2, 2, resident_tile_budget=-1)
    with pytest.raises(ValueError, match="stream epoch"):
        _stream(1, 16, 8, 2, 2, epoch=-1)


def test_stream_epoch_seed_folds_the_epoch_in():
    """Epoch 0 is the base seed (the tiled anchor), every other epoch the
    seed folded with the epoch, as the reference's fold_in(key, e)."""
    assert stream_epoch_seed(11, 0) == 11
    assert stream_epoch_seed(11, 3) == _iteration_seed(11, 3) != 11
    assert len({stream_epoch_seed(11, e) for e in range(6)}) == 6
    with pytest.raises(ValueError, match="must be >= 0"):
        stream_epoch_seed(0, -1)
    with pytest.raises(ValueError, match="must be >= 0"):
        ref_synthetic.stream_epoch_key(jax.random.PRNGKey(0), -1)


def test_stream_labels_share_base_seed_separator():
    n, Q, m = 8, 2, 4
    for e in (0, 2):
        y = svm_stream_label_block(13, e, 0, n, Q, m, flip_prob=0.0,
                                   device="cpu")
        acc = torch.zeros(n)
        for q in range(Q):
            xq = svm_stream_tile_x(13, e, 0, q, n, m, standardize=False,
                                   device="cpu")
            acc = acc + xq @ svm_feature_block_z(13, q, m, device="cpu")
        assert torch.equal(y, torch.where(acc >= 0, 1.0, -1.0))
    assert torch.equal(svm_stream_label_block(13, 0, 1, n, Q, m,
                                              device="cpu"),
                       svm_label_block(13, 1, n, Q, m, device="cpu"))
    assert torch.equal(svm_stream_tile_x(13, 0, 1, 1, n, m, device="cpu"),
                       svm_tile_x(13, 1, 1, n, m, device="cpu"))


def test_make_plane_passes_streaming_options():
    plane = make_plane("streaming", 4, 16, 8, 2, 2, device="cpu",
                       resident_tile_budget=5, epoch=3)
    assert isinstance(plane, StreamingDataPlane)
    assert (plane.resident_tile_budget, plane.epoch, plane.seed) == (5, 3, 4)
    assert plane.generation_seed == 4 and plane.flip_prob == 0.01


def test_streaming_cache_is_consistent_under_threads():
    """The tile cache is shared by the prefetch thread and the run's: many
    threads reading through a small budget each get the tile's bits, the
    resident count stays within the budget, and no hit or miss is lost."""
    import sys
    stream = _stream(6, 16, 8, 2, 2, resident_tile_budget=3)
    want = {(e, p, q): svm_stream_tile_x(6, e, p, q, 8, 4, device="cpu")
            for e in range(3) for p in range(2) for q in range(2)}
    keys, errors, reads = list(want), [], 40

    def reader(k):
        try:
            for i in range(reads):
                e, p, q = keys[(k + 5 * i) % len(keys)]
                if not torch.equal(stream.x_tile_at(e, p, q), want[e, p, q]):
                    errors.append((e, p, q))
                if stream.cache_stats["resident"] > 3:
                    errors.append("over budget")
        except Exception as exc:  # noqa: BLE001 - reported by the assert
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    stats = stream.cache_stats
    assert stats["hits"] + stats["misses"] == 12 * reads
    assert stats["resident"] <= 3


# ---------------------------------------------------------------------------
# StreamPrefetcher
# ---------------------------------------------------------------------------
def test_stream_prefetcher_issue_consume_bitwise():
    stream = _stream(2, 16, 8, 2, 2)

    def place(e):
        return stream.at_epoch(e).materialize()

    with StreamPrefetcher(place) as pf:
        pf.issue(0)
        pf.issue(0)  # idempotent
        X0, y0 = pf.consume(0)
        Xr, yr = place(0)
        assert torch.equal(X0, Xr) and torch.equal(y0, yr)
        pf.issue(1)
        X1, _ = pf.consume(1)
        assert torch.equal(X1, place(1)[0])
        pf.consume(3)  # never issued: a cold miss, issued on demand
        stats = pf.stats()
        assert stats["cold_misses"] == 1 and stats["consumed"] == 3
        assert 0.0 <= pf.overlap_ratio <= 1.0
    assert pf.closed


def test_stream_prefetcher_depth_bounds_the_issue_queue():
    placed, gate = [], threading.Event()

    def place(e):
        gate.wait(10)
        placed.append(e)
        return torch.full((1,), float(e)), torch.zeros(1)

    with pytest.raises(ValueError, match="depth"):
        StreamPrefetcher(place, depth=0)
    pf = StreamPrefetcher(place, depth=2)
    try:
        for e in (1, 2, 3):
            pf.issue(e)  # 3 is past depth 2: a no-op
        gate.set()
        assert float(pf.consume(1)[0]) == 1.0
        pf.issue(3)  # room again once 1 is consumed
        assert float(pf.consume(3)[0]) == 3.0
        assert pf.stats()["queue_high_water"] == 2
        assert pf.cold_misses == 0 and sorted(placed) == [1, 2, 3]
    finally:
        pf.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("stream-prefetch") and t.is_alive()]


# ---------------------------------------------------------------------------
# Against the reference's streaming run
# ---------------------------------------------------------------------------
KEY = jax.random.PRNGKey(0)
ITERS, SEGMENT, RECORD = 10, 4, 2


class _ReferenceStream(DataPlane):
    """A port plane serving the reference's stream tiles as CPU tensors."""

    is_streaming = True

    def __init__(self, cfg, epoch=0):
        self._init_grid(cfg.N, cfg.M, cfg.P, cfg.Q)
        self.cfg, self.epoch, self.device = cfg, epoch, torch.device("cpu")

    def at_epoch(self, epoch):
        return _ReferenceStream(self.cfg, epoch)

    def x_tile(self, p, q):
        return torch.tensor(np.asarray(ref_synthetic.svm_stream_tile_x(
            KEY, self.epoch, p, q, self.n, self.m)))

    def y_block(self, p):
        return torch.tensor(np.asarray(ref_synthetic.svm_stream_label_block(
            KEY, self.epoch, p, self.n, self.Q, self.m)))


def test_port_streaming_run_matches_the_reference(tmp_path):
    cfg = small_fixture_config()
    b, c, d = jax_sodda._counts(cfg)

    def sampler(t):
        s = jax_partition.sample_iteration(KEY, jnp.int32(t), cfg.P, cfg.Q,
                                           cfg.n, cfg.M, cfg.L, b, c, d)
        return partition.sample_from_numpy(*(np.asarray(f) for f in s),
                                           device="cpu")

    ref_final, ref_hist = jax_driver.run_resumable(
        KEY, make_data_plane(cfg, "streaming"), cfg, ITERS, "reference",
        checkpoint_dir=str(tmp_path / "jax"), segment_iters=SEGMENT,
        record_every=RECORD)
    final, hist = driver.run_resumable(
        0, _ReferenceStream(cfg), port_configs.SoddaConfig(
            **dataclasses.asdict(cfg)), ITERS, "reference",
        checkpoint_dir=str(tmp_path / "port"), segment_iters=SEGMENT,
        record_every=RECORD, device="cpu", sampler=sampler)
    assert [t for t, _ in hist] == [t for t, _ in ref_hist]
    for (t, f_ref), (_, f) in zip(ref_hist, hist):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"stream t={t}")
    assert_trajectories_close([np.asarray(ref_final.w)], [final.w.numpy()],
                              F32_REDUCTION, "stream final w")
