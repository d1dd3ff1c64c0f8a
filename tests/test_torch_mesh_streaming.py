"""The streaming plane on the port's mesh: a 3 x 2 grid of spawned CPU
ranks over gloo, each prefetching only its own tile and label block of
the next window, against the port's single-device streaming runs.

One spawn runs every mesh run: 8 iterations in segments of 2 (4 windows)
on ``shard_map`` (prefetch depth 1, then a replay of its last span),
``shard_map+cuda`` (depth 2) and ``async-mesh`` (staleness 1), one
window's run beside the ``tiled`` mesh run, a run interrupted at its seam
and resumed, every rank's placement of each window, and the mesh over the
JAX package's stream windows with its draws replayed. In process, a 1 x 1
gloo grid against the single-device streaming run.

Policies: every rank's w and history BITWISE equal; window 0 of a mesh
streaming run BITWISE the mesh ``tiled`` run; each rank's tile of window e
BITWISE the (p, q) slice of the single-device window e; the resume and
the kernel backend on the CPU BITWISE; the 1 x 1 grid BITWISE the
single-device run; the mesh within F32_REDUCTION of the single-device
streaming run and of the JAX package's streaming ``run_resumable``,
``async-mesh`` within STALENESS of ``async``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sodda_svm import SoddaConfig as JaxConfig
from repro.core import driver as jax_driver
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.testing import make_data_plane
from repro.testing.tolerances import (BITWISE, F32_REDUCTION, STALENESS,
                                      assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.checkpoint import read_extra
from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import driver
from repro_torch.core.distributed import Mesh
from repro_torch.data.plane import make_plane
from repro_torch.distributed import multihost
from repro_torch.testing import multiprocess as mp

CFG = SoddaConfig(P=3, Q=2, n=40, m=24, L=6, lr0=0.05)
WORLD = CFG.P * CFG.Q
SEED, ITERS, SEGMENT, RECORD = 4, 8, 2, 2
WINDOWS = ITERS // SEGMENT
STREAM = ("streaming", 0, CFG.N, CFG.M, CFG.P, CFG.Q)
TILED = ("tiled", 0, CFG.N, CFG.M, CFG.P, CFG.Q)
JAX_CFG = JaxConfig(**dataclasses.asdict(CFG))
REF_KEY = jax.random.PRNGKey(0)
JAX_BACKENDS = ("shard_map", "shard_map+cuda")

# name: (backend, options, resumable extras, iters)
RUNS = {
    "stream": ("shard_map", {}, {"prefetch_depth": 1, "replay": True},
               ITERS),
    "stream-cuda": ("shard_map+cuda", {}, {"prefetch_depth": 2}, ITERS),
    "stream-async": ("async-mesh", {"staleness": 1}, {}, ITERS),
    "one-window": ("shard_map", {}, {}, SEGMENT),
    "interrupted": ("shard_map", {}, {"interrupt_at": 2 * SEGMENT}, ITERS),
    "resumed": ("shard_map", {}, {}, ITERS),
}


def _dir(root, name):
    return os.path.join(root, "interrupted" if name == "resumed" else name)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_streaming"))


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """The JAX package's single-device streaming ``run_resumable``, its
    windows and its draws."""
    plane = make_data_plane(JAX_CFG, "streaming")
    state, hist = jax_driver.run_resumable(
        REF_KEY, plane, JAX_CFG, ITERS, "reference",
        checkpoint_dir=str(tmp_path_factory.mktemp("jax_stream")),
        segment_iters=SEGMENT, record_every=RECORD)
    windows = [tuple(np.asarray(a) for a in plane.at_epoch(e).materialize())
               for e in range(WINDOWS)]
    b, c, d = jax_sodda._counts(JAX_CFG)
    samples = {t: tuple(np.asarray(f) for f in jax_partition.sample_iteration(
        REF_KEY, jnp.int32(t), CFG.P, CFG.Q, CFG.n, CFG.M, CFG.L, b, c, d))
        for t in range(1, ITERS + 1)}
    return dict(w=np.asarray(state.w), history=hist, windows=windows,
                samples=samples)


@pytest.fixture(scope="module")
def launch(root, jax_stream):
    runs = [dict(backend=b, options=o, iters=iters, record_every=RECORD,
                 seed=SEED, resumable=dict(checkpoint_dir=_dir(root, name),
                                           segment_iters=SEGMENT, **extra))
            for name, (b, o, extra, iters) in RUNS.items()]
    tiled = [dict(backend="shard_map", iters=SEGMENT, record_every=RECORD,
                  seed=SEED)]
    replayed = [dict(backend=b, iters=ITERS, record_every=RECORD, seed=0,
                     samples=jax_stream["samples"],
                     resumable=dict(checkpoint_dir=os.path.join(root, b),
                                    segment_iters=SEGMENT))
                for b in JAX_BACKENDS]
    windows = ("windows", jax_stream["windows"], (CFG.P, CFG.Q))
    jobs = [(mp.rank_runs, (CFG, STREAM, runs, "cpu")),
            (mp.rank_runs, (CFG, TILED, tiled, "cpu")),
            (mp.rank_tiles, (CFG, STREAM, list(range(WINDOWS)), "cpu")),
            (mp.rank_runs, (CFG, windows, replayed, "cpu"))]
    out = mp.launch_coordinated(mp.rank_batch, WORLD, (jobs,),
                                backend="gloo", timeout=180)
    assert out.exit_codes == {}
    return out


def _runs(launch, name):
    k = list(RUNS).index(name)
    return [res[0][k] for res in launch.results]


def _single(backend, tmp_path, **options):
    plane = make_plane("streaming", *STREAM[1:], device="cpu")
    return driver.run_resumable(SEED, plane, CFG, ITERS, backend,
                                checkpoint_dir=str(tmp_path),
                                segment_iters=SEGMENT, record_every=RECORD,
                                device="cpu", **options)


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_returns_the_same_run(launch, name):
    runs = _runs(launch, name)
    for run in runs[1:]:
        assert run["history"] == runs[0]["history"]
        if run["w"] is not None:
            np.testing.assert_array_equal(run["w"], runs[0]["w"])


def test_window_zero_is_the_tiled_mesh_run(launch):
    """The reference's conformance anchor on the mesh: one window's
    streaming run is the tiled run, bitwise."""
    stream, tiled = _runs(launch, "one-window")[0], launch.results[0][1][0]
    assert_trajectories_close([tiled["w"]], [stream["w"]], BITWISE,
                              "window 0 vs tiled")
    assert stream["history"] == tiled["history"]


def test_each_rank_places_its_slice_of_every_window(launch):
    plane = make_plane("streaming", *STREAM[1:], device="cpu")
    n, m = CFG.n, CFG.m
    for e in range(WINDOWS):
        X, y = plane.at_epoch(e).materialize()
        for rank, res in enumerate(launch.results):
            p, q = divmod(rank, CFG.Q)
            x_tile, y_block = res[2][e]
            np.testing.assert_array_equal(
                x_tile, X[p * n:(p + 1) * n, q * m:(q + 1) * m].numpy())
            np.testing.assert_array_equal(y_block,
                                          y[p * n:(p + 1) * n].numpy())


@pytest.mark.parametrize("name,backend,options", [
    ("stream", "reference", {}), ("stream-cuda", "cuda", {})])
def test_mesh_streaming_matches_the_single_device_port(launch, tmp_path,
                                                       name, backend,
                                                       options):
    state, hist = _single(backend, tmp_path, **options)
    got = _runs(launch, name)[0]
    assert [t for t, _ in got["history"]] == [t for t, _ in hist]
    for (t, f_ref), (_, f) in zip(hist, got["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"{name} t={t}")
    assert_trajectories_close([state.w.numpy()], [got["w"]], F32_REDUCTION,
                              f"{name} final w")


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_mesh_streaming_matches_the_jax_streaming_run(launch, jax_stream,
                                                      backend):
    """Each rank prefetches its tile of the JAX package's windows, with the
    reference's draws replayed: the mesh run is its streaming
    run_resumable's within F32_REDUCTION, the same on every rank."""
    runs = [res[3][JAX_BACKENDS.index(backend)] for res in launch.results]
    for run in runs[1:]:
        assert run["history"] == runs[0]["history"]
        np.testing.assert_array_equal(run["w"], runs[0]["w"])
    got, ref = runs[0], jax_stream
    assert [t for t, _ in got["history"]] == [t for t, _ in ref["history"]]
    for (t, f_ref), (_, f) in zip(ref["history"], got["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"jax t={t}")
    assert_trajectories_close([ref["w"]], [got["w"]], F32_REDUCTION,
                              f"{backend} vs the JAX stream, final w")
    assert got["stream"]["cold_misses"] == 1


def test_kernel_backend_is_the_plain_mesh_on_the_cpu(launch):
    a, b = (_runs(launch, n)[0] for n in ("stream", "stream-cuda"))
    assert_trajectories_close([a["w"]], [b["w"]], BITWISE, "depth 2, cuda")
    assert a["history"] == b["history"]


def test_async_mesh_streams_within_staleness_of_async(launch, tmp_path):
    state, hist = _single("async", tmp_path, staleness=1)
    got = _runs(launch, "stream-async")[0]
    assert_objectives_close(hist[-1][1], got["history"][-1][1], STALENESS,
                            "async-mesh vs async, streaming")
    assert_trajectories_close([state.w.numpy()], [got["w"]], F32_REDUCTION,
                              "async-mesh vs async final w")


def test_an_interrupted_stream_resumes_bitwise(launch):
    want = _runs(launch, "stream")[0]
    assert {r["interrupted"] for r in _runs(launch, "interrupted")} == {
        2 * SEGMENT}
    got = _runs(launch, "resumed")
    for run in got:
        np.testing.assert_array_equal(run["w"], want["w"])
        assert run["history"] == want["history"]
    assert [r["saves"] for r in got] == [WINDOWS - 2] + [0] * (WORLD - 1)


def test_the_prefetcher_runs_ahead_on_every_rank(launch):
    for name, depth in (("stream", 1), ("stream-cuda", 2)):
        for run in _runs(launch, name):
            stats = run["stream"]
            assert stats["depth"] == depth and stats["cold_misses"] == 1
            assert stats["queue_high_water"] == depth
            assert 0.0 <= stats["overlap_ratio"] <= 1.0


def test_replay_checks_the_last_span_on_the_mesh(launch):
    for run in _runs(launch, "stream"):
        assert run["replay"] == {"replayed": True, "start": ITERS - SEGMENT,
                                 "end": ITERS, "match": True}


def test_the_resume_guard_stamps_epoch_zero_on_the_mesh_grid(launch, root):
    """Rank 0's stamp is the single-device plane's: epoch 0's tile (0, 0)
    on the (P, Q) grid, whichever window the boundary is in."""
    plane = make_plane("streaming", *STREAM[1:], device="cpu")
    _, extra = read_extra(_dir(root, "stream"), ITERS)
    assert extra["data"] == driver._data_fingerprint(plane)
    assert extra["streaming"] is True
    assert extra["stream_epoch"] == WINDOWS
    other = make_plane("streaming", 0, CFG.N, CFG.M, 2 * CFG.P, 1,
                       device="cpu")
    assert extra["data"] != driver._data_fingerprint(other)


@pytest.fixture
def one_rank(monkeypatch, tmp_path):
    for name in (multihost.COORDINATOR_ENV, multihost.NUM_PROCESSES_ENV,
                 multihost.PROCESS_ID_ENV):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                                backend="gloo")
    try:
        yield
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("mesh_backend,backend,options", [
    ("shard_map", "reference", {}), ("shard_map+cuda", "cuda", {}),
    ("async-mesh", "async", {"staleness": 1})])
def test_a_one_rank_grid_streams_bitwise_the_single_device_run(
        one_rank, tmp_path, mesh_backend, backend, options):
    cfg = SoddaConfig(P=1, Q=1, n=120, m=32, L=6, lr0=0.05)
    plane = make_plane("streaming", 0, cfg.N, cfg.M, 1, 1, device="cpu")
    kw = dict(segment_iters=SEGMENT, record_every=RECORD, device="cpu",
              **options)
    got, got_h = driver.run_resumable(SEED, plane, cfg, ITERS, mesh_backend,
                                      checkpoint_dir=str(tmp_path / "mesh"),
                                      mesh=Mesh(1, 1, "cpu"), **kw)
    want, want_h = driver.run_resumable(SEED, plane, cfg, ITERS, backend,
                                        checkpoint_dir=str(tmp_path / "one"),
                                        **kw)
    assert torch.equal(got.w, want.w) and got_h == want_h
