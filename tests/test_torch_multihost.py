"""Multi-process runs of the port: ``repro_torch.distributed.multihost``,
the ``repro_torch.testing.multiprocess`` harness, and ``run_resumable`` on
a 2 x 2 mesh of spawned CPU ranks over gloo, with its checkpoints.

Three spawns: a 2 x 2 ``shard_map`` resumable run killed at its first
segment seam (every rank exits after rank 0's commit and the barrier); a
relaunch that resumes it beside the uninterrupted run, a mid-segment
committing run and ``async-mesh`` runs; and a rank that dies before a
collective. The resumed run is held BITWISE to the uninterrupted one, only
rank 0 writes, and the checkpoint restores in the single-device port and
in the JAX package (the format is unchanged). In-process cases cover
``initialize``'s no-op and conflict paths and the 1 x 1 degeneracy.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.core import sodda as jax_sodda
from repro.testing.tolerances import BITWISE, assert_trajectories_close
from repro_torch.checkpoint import committed_steps, read_extra, \
    restore_checkpoint
from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import driver, engine, sodda
from repro_torch.core.distributed import Mesh
from repro_torch.data.plane import make_plane
from repro_torch.distributed import multihost
from repro_torch.testing import multiprocess as mp

CFG = SoddaConfig(P=2, Q=2, n=80, m=16, L=6, lr0=0.05)
WORLD = CFG.P * CFG.Q
SEED, ITERS, SEGMENT, RECORD = 5, 8, 4, 2
SPEC = ("tiled", 0, CFG.N, CFG.M, CFG.P, CFG.Q)


def _resumable(ckpt, backend="shard_map", iters=ITERS, kill_at=None,
               **options):
    return dict(backend=backend, iters=iters, record_every=RECORD, seed=SEED,
                options=options,
                resumable=dict(checkpoint_dir=ckpt, segment_iters=SEGMENT,
                               kill_at=kill_at))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    return {k: str(root / k) for k in ("killed", "whole", "commits",
                                       "async_whole", "async_split")}


@pytest.fixture(scope="module")
def killed(dirs):
    return mp.launch_coordinated(
        mp.rank_runs, WORLD,
        (CFG, SPEC, [_resumable(dirs["killed"], kill_at=SEGMENT)], "cpu"),
        backend="gloo", timeout=120)


@pytest.fixture(scope="module")
def relaunched(killed, dirs):
    runs = [
        _resumable(dirs["killed"]),  # resumes the killed run
        _resumable(dirs["whole"]),
        dict(backend="shard_map", iters=SEGMENT, record_every=RECORD,
             seed=SEED),
        dict(_resumable(dirs["commits"]), options={}),
        _resumable(dirs["async_whole"], "async-mesh", staleness=1),
        _resumable(dirs["async_split"], "async-mesh", iters=SEGMENT,
                   staleness=1),
        _resumable(dirs["async_split"], "async-mesh", staleness=1),
    ]
    runs[3]["resumable"]["commit_every"] = RECORD
    launch = mp.launch_coordinated(mp.rank_runs, WORLD,
                                   (CFG, SPEC, runs, "cpu"),
                                   backend="gloo", timeout=120)
    assert launch.exit_codes == {}
    return launch.results


def test_killed_ranks_exit_at_the_seam(killed, dirs):
    assert killed.exit_codes == {r: mp.KILL_EXIT_CODE for r in range(WORLD)}
    assert killed.results == [None] * WORLD
    assert committed_steps(dirs["killed"]) == [SEGMENT]


def test_resumed_run_is_bitwise_the_uninterrupted_run(relaunched):
    for r in range(WORLD):
        resumed, whole = relaunched[r][0], relaunched[r][1]
        assert_trajectories_close([whole["w"]], [resumed["w"]], BITWISE,
                                  f"rank {r}")
        assert resumed["history"] == whole["history"]
        assert resumed["t"] == whole["t"] == ITERS + 1


def test_every_rank_returns_the_same_run(relaunched):
    for k in range(len(relaunched[0])):
        for r in range(1, WORLD):
            np.testing.assert_array_equal(relaunched[r][k]["w"],
                                          relaunched[0][k]["w"])
            assert relaunched[r][k]["history"] == relaunched[0][k]["history"]


def test_a_resume_runs_only_its_own_iterations(relaunched):
    """On the CPU no kernel launches; the rank's payload shows the work:
    the resumed run's z reductions are half the uninterrupted run's."""
    resumed, whole = relaunched[0][0], relaunched[0][1]
    assert resumed["payload"]["z"] * 2 == whole["payload"]["z"]


def test_only_rank_zero_writes(relaunched, dirs):
    n_boundaries = ITERS // SEGMENT
    for r in range(WORLD):
        saves = [run["saves"] for run in relaunched[r]]
        # resumed: 1 boundary; whole: 2; plain run: 0; commits: 2
        # boundaries + 2 mid-segment commits; async: 2, 1, 1
        want = [1, n_boundaries, 0, 2 * n_boundaries, n_boundaries, 1, 1]
        assert saves == (want if r == 0 else [0] * len(want))
    assert committed_steps(dirs["whole"]) == [SEGMENT, ITERS]
    assert committed_steps(dirs["commits"]) == [4, 6, 8]  # keep=3


def test_mid_segment_commits_do_not_change_the_run(relaunched):
    whole, commits = relaunched[0][1], relaunched[0][3]
    np.testing.assert_array_equal(commits["w"], whole["w"])
    assert commits["history"] == whole["history"]


def test_async_mesh_resumes_bitwise_from_its_exchange(relaunched, dirs):
    """The second half of the split run restores w and the pending
    exchange mu from the checkpoint at 4 and continues bitwise."""
    whole, split = relaunched[0][4], relaunched[0][6]
    np.testing.assert_array_equal(split["w"], whole["w"])
    assert split["history"] == whole["history"]
    _, extra = read_extra(dirs["async_split"], ITERS)
    assert extra["backend"] == "async-mesh"


def test_checkpoint_restores_in_the_single_device_port(relaunched, dirs):
    step, record, extra = restore_checkpoint(
        dirs["killed"], sodda.record_template(False), step=SEGMENT)
    half = relaunched[0][2]  # the same run stopped at the seam
    assert step == SEGMENT and int(record.t) == SEGMENT + 1
    np.testing.assert_array_equal(record.w, half["w"])
    assert [tuple(h) for h in extra["history"]] == half["history"][:-1]
    plane = make_plane("tiled", 0, CFG.N, CFG.M, CFG.P, CFG.Q, device="cpu")
    done, state, _ = driver.restore_resumable_state(
        SEED, plane, CFG, "reference", checkpoint_dir=dirs["killed"],
        device="cpu")
    assert done == ITERS and state.seed == SEED
    np.testing.assert_array_equal(state.w.numpy(), relaunched[0][1]["w"])


@pytest.mark.parametrize("name,async_carry", [("killed", False),
                                              ("async_whole", True)])
def test_checkpoint_restores_in_the_jax_package(relaunched, dirs, name,
                                                async_carry):
    zeros = jnp.zeros(CFG.M, jnp.float32)
    template = jax_sodda.SoddaState(w=zeros, t=jnp.int32(0),
                                    key=jax.random.PRNGKey(0))
    if async_carry:
        template = jax_sodda.AsyncSoddaState(w=zeros, t=jnp.int32(0),
                                             key=jax.random.PRNGKey(0),
                                             mu=zeros)
    step, restored, _ = jax_ckpt.restore_checkpoint(dirs[name], template)
    final = relaunched[0][1 if name == "killed" else 4]
    assert step == ITERS and int(restored.t) == ITERS + 1
    np.testing.assert_array_equal(np.asarray(restored.w), final["w"])
    np.testing.assert_array_equal(np.asarray(restored.key),
                                  np.asarray(jax.random.PRNGKey(SEED)))
    if async_carry:
        assert np.isfinite(np.asarray(restored.mu)).all()


def test_a_dead_rank_returns_its_code_without_hanging(monkeypatch):
    monkeypatch.setattr(mp, "GRACE_S", 1.0)
    t0 = time.monotonic()
    launch = mp.launch_coordinated(mp.rank_exit, 2, ({1: 3},),
                                   backend="gloo", timeout=60)
    assert launch.exit_codes[1] == 3
    assert launch.exit_codes[0] != 0  # blocked on the dead rank, killed
    assert launch.results == [None, None]
    assert time.monotonic() - t0 < 50


# ---------------------------------------------------------------------------
# In process: the runtime bootstrap without and with a (one-rank) group.
# ---------------------------------------------------------------------------
@pytest.fixture
def no_rendezvous(monkeypatch):
    for name in (multihost.COORDINATOR_ENV, multihost.NUM_PROCESSES_ENV,
                 multihost.PROCESS_ID_ENV):
        monkeypatch.delenv(name, raising=False)


def test_initialize_without_a_rendezvous_is_a_no_op(no_rendezvous):
    assert multihost.initialize(backend="gloo") is False
    assert multihost.initialize(num_processes=1) is False
    assert not multihost.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_coordinator()
    multihost.barrier()  # no group: returns at once


def test_initialize_refuses_what_it_cannot_join(no_rendezvous):
    with pytest.raises(ValueError, match="rendezvous"):
        multihost.initialize(num_processes=2, backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("file:///nonexistent/store", 1, 0)
    with pytest.raises(ValueError, match="outside"):
        multihost.initialize("file:///nonexistent/store", 2, 2,
                             backend="gloo")


@pytest.fixture
def one_rank_group(no_rendezvous, tmp_path):
    url = f"file://{tmp_path / 'store'}"
    assert multihost.initialize(url, 1, 0, backend="gloo")
    try:
        yield url
    finally:
        multihost.shutdown()


def test_initialize_is_idempotent_and_refuses_a_conflict(one_rank_group):
    assert multihost.initialize(one_rank_group, 1, 0, backend="gloo")
    assert multihost.initialize()  # omitted arguments inherit the group
    with pytest.raises(RuntimeError, match="one process joins one group"):
        multihost.initialize(one_rank_group, 1, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="one process joins one group"):
        multihost.initialize("file:///elsewhere", 1, 0)


def test_a_mesh_needs_p_times_q_ranks(one_rank_group):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        Mesh(2, 2, "cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        engine.make_bundle(CFG, "shard_map", device="cpu")


@pytest.mark.parametrize("mesh_backend,backend", [
    ("shard_map", "reference"), ("shard_map+cuda", "cuda"),
    ("async-mesh", "async")])
def test_one_rank_mesh_is_bitwise_the_single_device_run(one_rank_group,
                                                        mesh_backend,
                                                        backend):
    """The 1 x 1 degeneracy: every collective is over one rank."""
    cfg = SoddaConfig(P=1, Q=1, n=160, m=32, L=6, lr0=0.05)
    plane = make_plane("tiled", 0, cfg.N, cfg.M, 1, 1, device="cpu")
    mesh = Mesh(1, 1, "cpu")
    got, got_h = driver.run(SEED, plane, cfg, 6, mesh_backend, mesh=mesh,
                            record_every=2, device="cpu")
    want, want_h = driver.run(SEED, plane, cfg, 6, backend, record_every=2,
                              device="cpu")
    assert torch.equal(got.w, want.w) and got_h == want_h


def _counting_new_group(monkeypatch):
    made = []
    new_group = torch.distributed.new_group

    def counted(*args, **kwargs):
        made.append(args)
        return new_group(*args, **kwargs)

    monkeypatch.setattr(torch.distributed, "new_group", counted)
    return made


def test_runs_without_a_mesh_make_no_new_group(no_rendezvous, tmp_path,
                                               monkeypatch):
    """A mesh's row and column groups are made once per process group:
    runs, objectives and bundles without a mesh make no new group after the
    first, and a new process group gets groups of its own."""
    made = _counting_new_group(monkeypatch)
    cfg = SoddaConfig(P=1, Q=1, n=40, m=8, L=4, lr0=0.05)
    plane = make_plane("tiled", 0, cfg.N, cfg.M, 1, 1, device="cpu")
    groups = []
    for k in range(2):
        assert multihost.initialize(f"file://{tmp_path / f'store{k}'}", 1, 0,
                                    backend="gloo")
        try:
            runs = [driver.run(SEED, plane, cfg, 2, "shard_map",
                               device="cpu")[1] for _ in range(2)]
            assert runs[0] == runs[1]
            # one group a process group: data and model are both rank 0
            assert len(made) == k + 1
            engine.make_objective(cfg, "shard_map", data=plane,
                                  device="cpu")
            groups.append(engine.make_mesh_for(cfg, "cpu").get_group("data"))
            mesh = engine.make_bundle(cfg, "async-mesh", device="cpu").mesh
            assert mesh.get_group("data") is groups[-1]
            assert len(made) == k + 1
        finally:
            multihost.shutdown()
    assert groups[0] is not groups[1]


@pytest.mark.parametrize("entry,args", [
    (mp.rank_runs, (CFG, SPEC, [])),
    (mp.rank_steps, (CFG, SPEC, "shard_map", [], [])),
    (mp.rank_consume, (CFG, SPEC, [])),
    (mp.rank_compressed, ((2, 2), [])),
])
def test_rank_entry_points_run_on_the_card_unless_asked(entry, args):
    """A rank's device defaults to the CUDA device, as every entry point's
    does: without a card that raises before anything runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the default device exists on this host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(*args)
