"""The elastic rescale on the port's mesh: ``run_elastic`` (shrink, and
shrink then grow), ``run_elastic_auto`` and the same rescales composed by
hand, on a 3 x 2 grid of spawned CPU ranks over gloo whose group is
re-formed at every rescale (``multihost.leave``/``reinitialize``), with
spare processes for the regrown row.

One spawn of 6 ranks and 8 spares runs every uninterrupted run; four more
spawns kill a shrink-then-grow run in each of its phases in turn and rerun
it. M = 48, so m_tilde goes 8 -> 12 at the shrink to P = 2 and back at the
grow.

Policies: every rank that finishes returns the same w, history and report
(BITWISE); a run is BITWISE its composition by hand and its runs killed
or faulted in every phase; the mesh is held within F32_REDUCTION of the
port's single-device ``run_elastic`` with the same draws and of the JAX
``run_elastic`` with its draws replayed; ``async-mesh`` at staleness 0 is
BITWISE ``shard_map+cuda`` and at staleness 1 within STALENESS of the
port's ``async`` under the same rescale.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sodda_svm import SoddaConfig as JaxConfig
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.data import plane as ref_plane
from repro.distributed import fault_tolerance as ref_ft
from repro.testing.tolerances import (BITWISE, F32_REDUCTION, STALENESS,
                                      assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import driver, engine
from repro_torch.data.plane import DenseDataPlane, make_plane
from repro_torch.distributed import multihost
from repro_torch.distributed.fault_tolerance import (ResidentPlane,
                                                     SegmentSupervisor,
                                                     StragglerPolicy,
                                                     regrow_plane,
                                                     run_elastic,
                                                     run_elastic_auto,
                                                     shrink_plane)
from repro_torch.testing import multiprocess as mp
from repro_torch.testing.faults import ClockAdvancer, FakeClock

CFG = SoddaConfig(P=3, Q=2, n=40, m=24, L=6, lr0=0.05)
WORLD, NEW_P = CFG.P * CFG.Q, 2
SEED, ITERS, SEGMENT, RECORD = 3, 12, 2, 2
LOSE, REGROW = 4, 8
SPEC = ("tiled", 0, CFG.N, CFG.M, CFG.P, CFG.Q)
LOST = list(range(NEW_P * CFG.Q, WORLD))  # the ranks of the lost row
STRAGGLER = (WORLD - 1, 4, 5.0)  # the last rank reads 5 s slow from 4
POLICY = dict(window=3, warmup=2)
JAX_CFG = JaxConfig(**dataclasses.asdict(CFG))
REF_KEY = jax.random.PRNGKey(0)

# name: (kind, backend, options, extra run keys)
RUNS = {
    "shrink": ("elastic", "shard_map", {}, {}),
    "hand": ("by-hand", "shard_map", {}, {}),
    "grow": ("elastic", "shard_map", {}, {"regrow_at": REGROW}),
    "hand-grow": ("by-hand", "shard_map", {}, {"regrow_at": REGROW}),
    "grow-faults": ("elastic", "shard_map+cuda", {},
                    {"regrow_at": REGROW, "faults": {2: 1, 6: 1, 10: 1}}),
    "grow-async": ("elastic", "async-mesh", {"staleness": 1},
                   {"regrow_at": REGROW}),
    "shrink-cuda": ("elastic", "shard_map+cuda", {}, {}),
    "shrink-async0": ("elastic", "async-mesh", {"staleness": 0}, {}),
    "shrink-async1": ("elastic", "async-mesh", {"staleness": 1}, {}),
    "auto": ("auto", "shard_map", {}, {}),
    "auto-cuda": ("auto", "shard_map+cuda", {}, {}),
    "auto-async": ("auto", "async-mesh", {"staleness": 1}, {}),
    "jax-draws": ("elastic", "shard_map", {}, {}),
}


def _run(root, name, kind, backend, options, extra):
    run = dict(kind=kind, backend=backend, options=options, iters=ITERS,
               record_every=RECORD, seed=SEED, segment_iters=SEGMENT,
               checkpoint_dir=os.path.join(root, name), new_P=NEW_P, **extra)
    if kind == "auto":
        run.update(straggler=STRAGGLER, policy=POLICY, patience=1)
    else:
        run["lose_at"] = LOSE
    if "regrow_at" in extra:
        run["regrow_P"] = CFG.P
    return run


def _jax_sample(t, cfg):
    b, c, d = jax_sodda._counts(cfg)
    return tuple(np.asarray(f) for f in jax_partition.sample_iteration(
        REF_KEY, jnp.int32(t), cfg.P, cfg.Q, cfg.n, cfg.M, cfg.L, b, c, d))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's single-device ``run_elastic`` on its tiled data,
    the data, and its draws on each phase's grid."""
    plane = ref_plane.TiledDataPlane(REF_KEY, CFG.N, CFG.M, CFG.P, CFG.Q)
    state, hist, report = ref_ft.run_elastic(
        REF_KEY, plane, JAX_CFG, ITERS, "reference",
        checkpoint_dir=str(tmp_path_factory.mktemp("jax_elastic")),
        segment_iters=SEGMENT, lose_partition_at=LOSE, record_every=RECORD)
    X, y = (np.asarray(a) for a in plane.materialize())
    samples = {t: _jax_sample(t, JAX_CFG if t <= LOSE else
                              report["new_cfg"]) for t in range(1, ITERS + 1)}
    return dict(w=np.asarray(state.w), history=hist, report=report, X=X,
                y=y, samples=samples)


@pytest.fixture(scope="module")
def shrunk_states():
    """The single-device trajectory on the shrunk grid: w^LOSE from the
    full grid, then a reference step at a time on the survivors."""
    plane = make_plane("tiled", *SPEC[1:], device="cpu")
    state, _ = driver.run(SEED, plane, CFG, LOSE, "reference", device="cpu")
    new_cfg = engine.rescale_config(CFG, NEW_P)
    X, y = shrink_plane(plane, NEW_P).materialize()
    bundle = engine.make_bundle(new_cfg, "reference", device="cpu")
    ws = [state.w.numpy()]
    for _ in range(LOSE, ITERS):
        state = bundle.step(state, X, y)
        ws.append(state.w.numpy())
    return ws, list(range(LOSE + 1, ITERS + 1))


@pytest.fixture(scope="module")
def launch(tmp_path_factory, jax_run, shrunk_states):
    root = str(tmp_path_factory.mktemp("mesh_elastic"))
    runs = [_run(root, name, *spec) for name, spec in RUNS.items()]
    jax_draws = runs[list(RUNS).index("jax-draws")]
    jax_draws.update(plane=("dense", jax_run["X"], jax_run["y"],
                            (CFG.P, CFG.Q)), samples=jax_run["samples"])
    ws, ts = shrunk_states
    runs.append(dict(kind="steps", backend="shard_map", seed=SEED,
                     new_P=NEW_P, lose_at=LOSE, ws=ws[:-1], ts=ts))
    spares = sum(1 for r in runs if "regrow_at" in r) * CFG.Q
    return mp.launch_coordinated(mp.rank_elastic, WORLD,
                                 (CFG, SPEC, runs, "cpu"), backend="gloo",
                                 spares=spares, timeout=240)


def _finished(launch, name):
    """The results of the processes that finished run `name` (not left)."""
    k = list(RUNS).index(name)
    return [res[k] for res in launch.results
            if res[k] is not None and res[k]["left"] is None]


def _one(launch, name):
    return _finished(launch, name)[0]


def _single(backend, tmp_path, grow=False, auto=False, **options):
    """The port's single-device run on the CPU tiled plane."""
    plane = make_plane("tiled", *SPEC[1:], device="cpu")
    kw = dict(checkpoint_dir=str(tmp_path), segment_iters=SEGMENT,
              record_every=RECORD, device="cpu", new_P=NEW_P, **options)
    if auto:
        clock = FakeClock()
        sup = SegmentSupervisor(straggler=StragglerPolicy(**POLICY),
                                straggler_patience=1,
                                straggler_action="rescale", clock=clock)
        return run_elastic_auto(
            SEED, plane, CFG, ITERS, backend, supervisor=sup,
            on_segment_start=ClockAdvancer(clock, {STRAGGLER[1]:
                                                   STRAGGLER[2]}), **kw)
    if grow:
        kw.update(regrow_at=REGROW, regrow_P=CFG.P)
    return run_elastic(SEED, plane, CFG, ITERS, backend,
                       lose_partition_at=LOSE, **kw)


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_returns_the_same_run(launch, name):
    runs = _finished(launch, name)
    grows = "regrow_at" in RUNS[name][3]
    assert len(runs) == (WORLD if grows else NEW_P * CFG.Q)
    for run in runs[1:]:
        np.testing.assert_array_equal(run["w"], runs[0]["w"])
        assert run["history"] == runs[0]["history"]
        assert run["report"] == runs[0]["report"]
        assert run["t"] == ITERS + 1
    assert [t for t, _ in runs[0]["history"]] == list(
        range(0, ITERS + 1, RECORD))
    assert runs[0]["world"] == (WORLD if grows else NEW_P * CFG.Q)


def test_lost_ranks_leave_and_regrown_ranks_join_holding_nothing(launch):
    """The lost row's processes leave the group at every shrink (exit 0,
    not a death), the survivors' group has new_P * Q ranks, and each
    regrown rank is a spare that held no group before it joined."""
    assert launch.exit_codes == {}
    shrinks = [3 * k for k in range(len(RUNS) + 1)]  # and the steps
    assert launch.departed == {r: shrinks for r in LOST}
    for k, name in enumerate(RUNS):
        left = [res[k] for res in launch.results[:WORLD]
                if res[k]["left"] is not None]
        assert [r["left"] for r in left] == [
            STRAGGLER[1] + SEGMENT if RUNS[name][0] == "auto" else LOSE] * 2
        assert all(r["w"] is None and r["world"] is None for r in left)
    spares = launch.results[WORLD:]
    assert len(spares) == 8
    for i, res in enumerate(spares):
        mine = [r for r in res if r is not None]
        assert len(mine) == 1, "a spare serves one grow"
        assert mine[0]["held"] == {"group": False, "cuda": False}
        joins = [h for h in launch.stamps[WORLD + i]["history"]
                 if h["event"] == "joined"]
        assert [(h["world"], h["rank"]) for h in joins] == [
            (WORLD, NEW_P * CFG.Q + i % CFG.Q)]
        assert joins[0]["generation"] % 3 == 2


@pytest.mark.parametrize("name,rescales", [
    ("grow", ((LOSE, (NEW_P, CFG.Q)), (REGROW, (CFG.P, CFG.Q)))),
    ("auto", ((STRAGGLER[1] + SEGMENT, (NEW_P, CFG.Q)),)),
    ("hand", ())])
def test_each_rebuild_is_timed_on_every_rank_in_the_new_group(launch, name,
                                                              rescales):
    """Every rank that ends a run notes each rebuild it joined, in parts:
    the rendezvous inside the re-forming, then the mesh and the
    migration, all after the boundary's commit (the composition by hand
    runs no supervisor)."""
    for rank, run in enumerate(_finished(launch, name)):
        regrown = run["held"] is not None
        want = rescales[1:] if regrown else rescales
        got = run["rebuilds"]
        assert [(r["at"], r["grid"]) for r in got] == list(want), rank
        for r in got:
            assert 0 <= r["rendezvous_s"] <= r["reform_s"]
            assert r["mesh_s"] >= 0 and r["migrate_s"] >= 0
            assert r["end"] == pytest.approx(
                r["start"] + r["reform_s"] + r["mesh_s"] + r["migrate_s"])


@pytest.mark.parametrize("name,by_hand", [("shrink", "hand"),
                                          ("grow", "hand-grow")])
def test_run_elastic_is_bitwise_its_composition_by_hand(launch, name,
                                                        by_hand):
    a, b = _one(launch, name), _one(launch, by_hand)
    assert_trajectories_close([a["w"]], [b["w"]], BITWISE, name)
    assert a["history"] == b["history"]
    assert dataclasses.asdict(a["report"]["new_cfg"]) == dataclasses.asdict(
        b["report"]["new_cfg"])


def test_faults_in_every_phase_are_bitwise_the_uninterrupted_run(launch):
    """A fault after a commit in each phase, retried by the supervisor on
    every rank alike (shard_map+cuda takes the plain chain on the CPU)."""
    a, b = _one(launch, "grow"), _one(launch, "grow-faults")
    assert_trajectories_close([a["w"]], [b["w"]], BITWISE, "faults")
    assert a["history"] == b["history"]
    restarts = [e for e in b["report"]["events"] if e.startswith("restart")]
    assert restarts == ["restart#1@2:Preemption", "restart#1@6:Preemption",
                        "restart#1@10:Preemption"]


@pytest.mark.parametrize("name,backend,grow", [
    ("shrink", "reference", False), ("grow", "reference", True),
    ("shrink-cuda", "cuda", False)])
def test_mesh_elastic_matches_the_single_device_port(launch, tmp_path, name,
                                                     backend, grow):
    state, hist, report = _single(backend, tmp_path, grow=grow)
    got = _one(launch, name)
    assert [t for t, _ in hist] == [t for t, _ in got["history"]]
    for (t, f_ref), (_, f) in zip(hist, got["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"{name} t={t}")
    assert_trajectories_close([state.w.numpy()], [got["w"]], F32_REDUCTION,
                              f"{name} final w")
    assert got["report"]["events"] == report["events"]
    for key in ("plan", "moved_rows", "grow_plan", "regrown_rows"):
        assert got["report"].get(key) == report.get(key), key


def test_mesh_elastic_matches_the_jax_run_elastic(launch, jax_run):
    """The JAX package's single-device run_elastic, its tiles and its
    draws replayed on each phase's grid."""
    got, ref = _one(launch, "jax-draws"), jax_run
    assert [t for t, _ in got["history"]] == [t for t, _ in ref["history"]]
    for (t, f_ref), (_, f) in zip(ref["history"], got["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"jax t={t}")
    assert_trajectories_close([ref["w"]], [got["w"]], F32_REDUCTION,
                              "jax final w")
    assert got["report"]["plan"] == ref["report"]["plan"]
    assert dataclasses.asdict(got["report"]["new_cfg"]) == \
        dataclasses.asdict(ref["report"]["new_cfg"])


def test_async_mesh_under_a_rescale(launch, tmp_path):
    """Staleness 0 is shard_map+cuda, bitwise; staleness 1 stays within
    STALENESS of the port's async under the same shrink (and within
    F32_REDUCTION of its iterate: one draw, one schedule)."""
    s0, sync = _one(launch, "shrink-async0"), _one(launch, "shrink-cuda")
    assert_trajectories_close([sync["w"]], [s0["w"]], BITWISE, "staleness 0")
    assert s0["history"] == sync["history"]
    state, hist, _ = _single("async", tmp_path, staleness=1)
    s1 = _one(launch, "shrink-async1")
    assert_objectives_close(hist[-1][1], s1["history"][-1][1], STALENESS,
                            "async-mesh vs async under a shrink")
    assert_trajectories_close([state.w.numpy()], [s1["w"]], F32_REDUCTION,
                              "async-mesh vs async final w")
    grown = _one(launch, "grow-async")
    assert grown["history"][-1][1] < grown["history"][0][1]


def test_each_step_on_the_shrunk_grid_is_the_single_device_step(
        launch, shrunk_states):
    """On the re-formed 2 x 2 group, one mesh step from each state of the
    single-device trajectory on the survivors (m_tilde 12), to
    F32_REDUCTION."""
    ws, _ = shrunk_states
    steps = [res[len(RUNS)]["steps"] for res in launch.results[:WORLD]
             if res[len(RUNS)]["left"] is None]
    assert len(steps) == NEW_P * CFG.Q
    for got in steps:
        np.testing.assert_array_equal(got, steps[0])
    for t, got in enumerate(steps[0]):
        assert_trajectories_close([ws[t + 1]], [got], F32_REDUCTION,
                                  f"step {LOSE + t + 1} on the shrunk grid")


@pytest.mark.parametrize("name", ["auto", "auto-cuda", "auto-async"])
def test_a_straggler_is_shrunk_away_on_every_rank_alike(launch, tmp_path,
                                                        name):
    """One rank's slow segment is every rank's (the group's max), rank 0
    decides, and every rank rescales at the same boundary with the same
    events; the run is the single-device run_elastic_auto's."""
    backend = {"auto": "reference", "auto-cuda": "cuda",
               "auto-async": "async"}[name]
    options = RUNS[name][2]
    state, hist, report = _single(backend, tmp_path, auto=True, **options)
    got = _one(launch, name)
    assert got["report"]["rescaled"] is report["rescaled"] is True
    assert got["report"]["boundary"] == report["boundary"] == \
        STRAGGLER[1] + SEGMENT
    assert got["report"]["events"] == report["events"]
    for (t, f_ref), (_, f) in zip(hist, got["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"{name} t={t}")
    assert_trajectories_close([state.w.numpy()], [got["w"]], F32_REDUCTION,
                              f"{name} final w")


# ---------------------------------------------------------------------------
# A shrink-then-grow run killed in each phase in turn, rerun each time
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """Four spawns of one run in one directory: killed after the commit
    at 2 (phase 1), at 6 (phase 2: the survivors), at 10 (phase 3: the
    survivors and the regrown ranks), then completed."""
    root = str(tmp_path_factory.mktemp("mesh_elastic_killed"))
    launches = []
    for kill_at, spares in ((2, 0), (6, 0), (10, CFG.Q), (None, CFG.Q)):
        run = _run(root, "killed", "elastic", "shard_map", {},
                   {"regrow_at": REGROW, "kill_at": kill_at})
        launches.append(mp.launch_coordinated(
            mp.rank_elastic, WORLD, (CFG, SPEC, [run], "cpu"),
            backend="gloo", spares=spares, timeout=120))
    return launches


def test_kills_in_every_phase_exit_only_the_ranks_of_that_phase(killed):
    kill = mp.KILL_EXIT_CODE
    survivors = [r for r in range(WORLD) if r not in LOST]
    assert killed[0].exit_codes == {r: kill for r in range(WORLD)}
    assert killed[1].exit_codes == {r: kill for r in survivors}
    assert killed[2].exit_codes == {
        r: kill for r in survivors + [WORLD, WORLD + 1]}
    assert killed[3].exit_codes == {}
    for launch in killed[1:]:
        assert sorted(launch.departed) == LOST


def test_a_run_killed_in_every_phase_reruns_bitwise(killed, launch):
    want = _one(launch, "grow")
    runs = [res[0] for res in killed[3].results if res[0]["left"] is None]
    assert len(runs) == WORLD
    for run in runs:
        np.testing.assert_array_equal(run["w"], want["w"])
        assert run["history"] == want["history"]


# ---------------------------------------------------------------------------
# In process: the re-forming primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("address,generation,want", [
    ("file:///tmp/store", 0, "file:///tmp/store"),
    ("file:///tmp/store", 3, "file:///tmp/store.g3"),
    ("localhost:29500", 2, "tcp://localhost:29502"),
    ("tcp://10.0.0.1:1234", 1, "tcp://10.0.0.1:1235")])
def test_generation_address(address, generation, want):
    assert multihost.generation_address(address, generation) == want


@pytest.fixture
def one_rank(monkeypatch, tmp_path):
    for name in (multihost.COORDINATOR_ENV, multihost.NUM_PROCESSES_ENV,
                 multihost.PROCESS_ID_ENV):
        monkeypatch.delenv(name, raising=False)
    url = f"file://{tmp_path / 'store'}"
    assert multihost.initialize(url, 1, 0, backend="gloo")
    try:
        yield url
    finally:
        multihost.shutdown()


def test_reinitialize_re_forms_the_group_and_releases_its_meshes(one_rank):
    from repro_torch.core.distributed import Mesh

    mesh = Mesh(1, 1, "cpu")
    multihost.reinitialize(1, 0, generation=1)
    assert multihost.generation() == 1 and multihost.is_initialized()
    with pytest.raises(RuntimeError, match="released"):
        mesh.get_group("data")
    assert Mesh(1, 1, "cpu").get_group("data") is not None
    with pytest.raises(ValueError, match="not newer"):
        multihost.reinitialize(1, 0, generation=1)
    multihost.leave()
    assert not multihost.is_initialized()
    assert [h["event"] for h in multihost.history()][-3:] == [
        "joined", "joined", "left"]


def test_a_failed_rendezvous_raises_and_leaves_no_group(one_rank,
                                                         monkeypatch):
    """A re-formed group whose other rank never comes raises within its
    timeout; the process is then in no group, not the old one."""
    monkeypatch.setattr(multihost, "DEFAULT_TIMEOUT_S", 2.0)
    with pytest.raises(RuntimeError):
        multihost.reinitialize(2, 0, generation=1)
    assert not multihost.is_initialized()


def _counted(plane, calls):
    """`plane` with each placement of its own counted in `calls`."""
    place = plane.place_tile
    plane.place_tile = lambda p, q: calls.append((p, q)) or place(p, q)
    return plane


def test_a_survivor_keeps_the_pair_it_placed_and_a_regrown_rank_draws():
    """Through a resident plane the survivor and grown views hand back a
    survivor's placed pair (no tile drawn again); a regrown worker draws
    its own, bitwise the fresh plane's; release drops the pair."""
    calls = []
    tiled = make_plane("tiled", *SPEC[1:], device="cpu")
    resident = ResidentPlane(_counted(tiled, calls))
    x, y = resident.place_tile(1, 1)
    survivors = shrink_plane(resident, NEW_P)
    grown = regrow_plane(survivors, CFG.P)
    for view in (resident, survivors, grown):
        got = view.place_tile(1, 1)
        assert got[0] is x and got[1] is y
    assert calls == [(1, 1)]
    xr, yr = grown.place_tile(CFG.P - 1, 0)
    want = make_plane("tiled", *SPEC[1:], device="cpu").place_tile(
        CFG.P - 1, 0)
    assert torch.equal(xr, want[0]) and torch.equal(yr, want[1])
    assert calls == [(1, 1)]
    with pytest.raises(IndexError):
        survivors.place_tile(NEW_P, 0)
    resident.release()
    assert resident.place_tile(1, 1)[0] is not x and len(calls) == 2
    with pytest.raises(TypeError, match="static"):
        ResidentPlane(make_plane("streaming", *SPEC[1:], device="cpu"))


def test_rank_zero_stamps_a_seed_derived_plane_once_a_grid(one_rank):
    """The resume guard's stamp on a mesh is hashed once per plane and
    grid for a plane drawn from a seed, every time for one wrapping
    tensors; it is the single-device stamp on a 1 x 1 grid."""
    from repro_torch.core.distributed import Mesh

    mesh, calls = Mesh(1, 1, "cpu"), []
    shape = (CFG.N, CFG.M, 1, 1)
    tiled = _counted(make_plane("tiled", 0, *shape, device="cpu"), calls)
    stamps = [driver._data_fingerprint(tiled, mesh) for _ in range(3)]
    assert len(set(stamps)) == 1 and len(calls) == 1
    assert stamps[0] == driver._data_fingerprint(tiled)
    dense = _counted(DenseDataPlane(*tiled.materialize()), calls)
    assert [driver._data_fingerprint(dense, mesh) for _ in range(2)] == \
        stamps[:2]
    assert len(calls) == 3


@pytest.mark.parametrize("entry,args", [
    (mp.rank_elastic, (CFG, SPEC, [])),
    (mp.rank_tiles, (CFG, SPEC, [])),
])
def test_the_new_rank_entry_points_run_on_the_card_unless_asked(entry, args):
    """As every rank entry point: the CUDA device by default, which raises
    here before anything runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the default device exists on this host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(*args)
