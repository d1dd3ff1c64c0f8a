"""The port's mesh backends (``shard_map``, ``shard_map+cuda``,
``async-mesh``) on spawned CPU ranks over gloo, against the JAX mesh step
and against the port's own single-device backends.

One spawn of the reference's 4 x 3 equivalence grid
(``tests/test_distributed.py``) runs every mesh run, step and consume the
tests read, on 12 ranks; JAX runs only here, in the parent, on a
``sodda_test_mesh`` of 12 host devices, and results cross as numpy.

Policies: ``shard_map`` with the JAX draws replayed is held to the JAX
``make_distributed_step`` (F32_REDUCTION on w every iteration and on the
distributed objective), and with the port's draws to the port's
single-device ``reference`` (F32_REDUCTION at every tick);
``consume_local`` BITWISE to ``consume_update`` from the same w and mu;
``async-mesh`` at staleness 0 BITWISE ``shard_map``, at staleness 1
within STALENESS of the port's ``async`` and F32_REDUCTION of the JAX
``make_distributed_async_step`` with replayed draws; ``gather_deltas=False``
F32_REDUCTION of the all-gather assembly; the int8 wires within QUANTIZED
of the exact run; every rank's w and history BITWISE equal.
"""
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sodda_svm import SoddaConfig as JaxConfig
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.core.distributed import (distributed_objective,
                                    iteration_collective_bytes,
                                    make_distributed_async_step,
                                    make_distributed_step)
from repro.data.synthetic import make_svm_data
from repro.testing import sodda_test_mesh
from repro.testing.tolerances import (BITWISE, F32_REDUCTION, QUANTIZED,
                                      STALENESS, assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import distributed as port_distributed
from repro_torch.core import driver, engine, partition, sodda
from repro_torch.data.plane import make_plane
from repro_torch.distributed import run_elastic, run_elastic_regrown
from repro_torch.testing import multiprocess as mp

KEY_SEED = 1  # the JAX draws' PRNGKey, made inside the tests
SEED = 3  # the port's own draws
ITERS = 5
JAX_CFG = JaxConfig(P=4, Q=3, n=120, m=24, L=8, lr0=0.05)
CFG = port_configs.SoddaConfig(**dataclasses.asdict(JAX_CFG))
WORLD = CFG.P * CFG.Q

# (name, backend, engine options, replayed JAX draws?)
RUNS = [
    ("jax_draws", "shard_map", {}, True),
    ("shard_map", "shard_map", {}, False),
    ("shard_map+cuda", "shard_map+cuda", {}, False),
    ("psum_deltas", "shard_map", {"gather_deltas": False}, False),
    ("async0", "async-mesh", {"staleness": 0}, False),
    ("async1", "async-mesh", {"staleness": 1}, False),
    ("async1_jax_draws", "async-mesh", {"staleness": 1}, True),
    ("int8", "shard_map", {"compress_mu": True, "compress_z": True}, False),
]


def _jax_sample(t):
    b, c, d = jax_sodda._counts(JAX_CFG)
    return jax_partition.sample_iteration(
        jax.random.PRNGKey(KEY_SEED), jnp.int32(t), JAX_CFG.P, JAX_CFG.Q,
        JAX_CFG.n, JAX_CFG.M, JAX_CFG.L, b, c, d)


def _numpy_samples(ts):
    return {t: tuple(np.asarray(f) for f in _jax_sample(t)) for t in ts}


@pytest.fixture(scope="module")
def data():
    X, y, _ = make_svm_data(jax.random.PRNGKey(0), JAX_CFG.N, JAX_CFG.M)
    return np.asarray(X), np.asarray(y)


@pytest.fixture(scope="module")
def mesh_results(data, jax_trajectory):
    """One 12-rank spawn: every mesh run, a step from each state of the
    JAX trajectory, and consume_local from fixed w and mu."""
    X, y = data
    spec = ("dense", X, y)
    samples = _numpy_samples(range(1, ITERS + 1))
    runs = []
    for name, backend, options, replay in RUNS:
        for iters in range(1, ITERS + 1):
            runs.append(dict(backend=backend, iters=iters, record_every=1,
                             seed=SEED, options=options,
                             samples=samples if replay else None))
    rng = np.random.default_rng(11)
    cases = [((rng.normal(size=CFG.M) * 0.1).astype(np.float32),
              (rng.normal(size=CFG.M) * 0.01).astype(np.float32), t, kernel)
             for t in (1, 4) for kernel in (False, True)]
    ws, ts = jax_trajectory[0][:-1], list(range(1, ITERS + 1))
    jobs = [(mp.rank_runs, (CFG, spec, runs, "cpu")),
            (mp.rank_steps, (CFG, spec, "shard_map", ws, ts, SEED, samples,
                             None, "cpu")),
            (mp.rank_consume, (CFG, spec, cases, SEED, "cpu"))]
    launch = mp.launch_coordinated(mp.rank_batch, WORLD, (jobs,),
                                   backend="gloo", timeout=240)
    assert launch.exit_codes == {}
    per_rank = [dict(runs=r[0], steps=r[1], consume=r[2])
                for r in launch.results]
    by_name = {}
    for r in range(WORLD):
        for k, (name, *_rest) in enumerate(RUNS):
            by_name.setdefault(name, []).append(
                per_rank[r]["runs"][k * ITERS:(k + 1) * ITERS])
    return dict(runs=by_name, ranks=per_rank, cases=cases)


def _jax_trajectory(X, y):
    mesh = sodda_test_mesh(JAX_CFG)
    step = make_distributed_step(mesh, JAX_CFG)
    obj = distributed_objective(mesh, JAX_CFG)
    s = jax_sodda.init_state(jax.random.PRNGKey(KEY_SEED), JAX_CFG.M)
    ws, fs = [np.asarray(s.w)], [float(obj(X, y, s.w))]
    for _ in range(ITERS):
        s = step(s, X, y)
        ws.append(np.asarray(s.w))
        fs.append(float(obj(X, y, s.w)))
    return ws, fs


@pytest.fixture(scope="module")
def jax_trajectory(data):
    return _jax_trajectory(*data)


def _trajectory(runs):
    """Rank 0's w after 1..ITERS iterations (w^0 = 0 first)."""
    return [np.zeros(CFG.M, np.float32)] + [r["w"] for r in runs]


def _single(data, backend, **options):
    """The port's single-device run of every length 1..ITERS."""
    X, y = (torch.tensor(a) for a in data)
    return [driver.run(SEED, (X, y), CFG, iters, backend, record_every=1,
                       device="cpu", **options) for iters in range(1, ITERS + 1)]


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_every_rank_returns_the_same_run(mesh_results, name):
    runs = mesh_results["runs"][name]
    for k in range(ITERS):
        first = runs[0][k]
        for rank in range(1, WORLD):
            other = runs[rank][k]
            np.testing.assert_array_equal(other["w"], first["w"])
            assert other["history"] == first["history"]
            assert other["t"] == first["t"] == k + 2


def test_shard_map_matches_the_jax_mesh_step(mesh_results, jax_trajectory):
    ws, fs = jax_trajectory
    runs = mesh_results["runs"]["jax_draws"][0]
    assert_trajectories_close(ws, _trajectory(runs), F32_REDUCTION,
                              "shard_map vs JAX make_distributed_step")
    hist = runs[-1]["history"]
    assert [t for t, _ in hist] == list(range(ITERS + 1))
    for (t, f), f_ref in zip(hist, fs):
        assert_objectives_close(f_ref, f, F32_REDUCTION,
                                f"distributed objective t={t}")


def test_steps_from_the_jax_states_match_the_jax_mesh_step(mesh_results,
                                                          jax_trajectory):
    ws, _ = jax_trajectory
    steps = mesh_results["ranks"][0]["steps"]
    for t in range(ITERS):
        assert_trajectories_close([ws[t + 1]], [steps[t]], F32_REDUCTION,
                                  f"one step from the JAX w^{t}")


@pytest.mark.parametrize("name,backend", [("shard_map", "reference"),
                                          ("shard_map+cuda", "cuda")])
def test_mesh_matches_the_single_device_port(mesh_results, data, name,
                                             backend):
    """The port's own draws: the mesh rank draws the whole sample and
    slices it, so it runs the single-device iteration over the grid."""
    single = _single(data, backend)
    runs = mesh_results["runs"][name][0]
    assert_trajectories_close(
        _trajectory([{"w": s.w.numpy()} for s, _ in single]),
        _trajectory(runs), F32_REDUCTION, f"{name} vs {backend}")
    for (t, f_ref), (_, f) in zip(single[-1][1], runs[-1]["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"{name} t={t}")


def test_kernel_backend_is_the_plain_mesh_on_the_cpu(mesh_results):
    """``ops.sodda_inner`` takes the plain chain for CPU tensors."""
    a, b = (mesh_results["runs"][n][0] for n in ("shard_map",
                                                 "shard_map+cuda"))
    assert_trajectories_close(_trajectory(a), _trajectory(b), BITWISE,
                              "shard_map+cuda vs shard_map on the CPU")


def test_consume_local_is_bitwise_consume_update(mesh_results, data):
    X, y = (torch.tensor(a) for a in data)
    b, c, d = sodda._counts(CFG)
    got = mesh_results["ranks"][0]["consume"]
    for (w, mu, t, kernel), w_mesh in zip(mesh_results["cases"], got):
        smp = partition.sample_iteration(SEED, t, CFG.P, CFG.Q, CFG.n, CFG.M,
                                         CFG.L, b, c, d, "cpu")
        want = sodda.consume_update(X, y, torch.tensor(w), torch.tensor(mu),
                                    smp, float(sodda._gamma(CFG, t)), CFG,
                                    use_kernel=kernel)
        np.testing.assert_array_equal(w_mesh, want.numpy(),
                                      err_msg=f"t={t} kernel={kernel}")


def test_psum_assembly_matches_the_gather(mesh_results):
    a, b = (mesh_results["runs"][n][0] for n in ("shard_map", "psum_deltas"))
    assert_trajectories_close(_trajectory(a), _trajectory(b), F32_REDUCTION,
                              "gather_deltas=False vs True")


def test_async_mesh_at_staleness_zero_is_bitwise_shard_map(mesh_results):
    a, b = (mesh_results["runs"][n][0] for n in ("shard_map+cuda", "async0"))
    assert_trajectories_close(_trajectory(a), _trajectory(b), BITWISE,
                              "async-mesh/staleness=0 vs shard_map+cuda")
    assert a[-1]["history"] == b[-1]["history"]


def test_async_mesh_at_staleness_one_matches_the_port_async(mesh_results,
                                                           data):
    single = _single(data, "async", staleness=1)
    runs = mesh_results["runs"]["async1"][0]
    assert_trajectories_close(
        _trajectory([{"w": s.w.numpy()} for s, _ in single]),
        _trajectory(runs), F32_REDUCTION, "async-mesh vs async, one draw")
    f_ref, f = single[-1][1][-1][1], runs[-1]["history"][-1][1]
    assert_objectives_close(f_ref, f, STALENESS, "async-mesh vs async")


def test_async_mesh_matches_the_jax_async_mesh_step(mesh_results, data):
    X, y = data
    bundle = make_distributed_async_step(sodda_test_mesh(JAX_CFG), JAX_CFG,
                                         staleness=1)
    carry = bundle.init_carry(
        jax_sodda.init_state(jax.random.PRNGKey(KEY_SEED), JAX_CFG.M), X, y)
    ws = [np.asarray(carry.w)]
    for _ in range(ITERS):
        carry = bundle.step(carry, X, y)
        ws.append(np.asarray(carry.w))
    runs = mesh_results["runs"]["async1_jax_draws"][0]
    assert_trajectories_close(ws, _trajectory(runs), F32_REDUCTION,
                              "async-mesh vs JAX make_distributed_async_step")


def test_int8_wires_stay_within_quantized_of_the_exact_run(mesh_results):
    exact, q8 = (mesh_results["runs"][n][0][-1]["history"]
                 for n in ("shard_map", "int8"))
    assert q8[-1][1] < q8[0][1]  # descends
    assert_objectives_close(exact[-1][1], q8[-1][1], QUANTIZED,
                            "int8 z and mu wires")


@pytest.mark.parametrize("name", ["shard_map", "psum_deltas", "int8"])
def test_payload_is_what_each_collective_hands_over(mesh_results, name):
    """Bytes a rank hands to each collective in a 5-iteration run: z is n
    f32 (n int8 and the scales on int8 wires), mu m, the gather one block,
    the padded delta m; the objective's n + 1 f32 at each of 6 ticks."""
    run = mesh_results["runs"][name][0][-1]
    n, m, mt, P, Q = CFG.n, CFG.m, CFG.m_tilde, CFG.P, CFG.Q
    want = {"objective": 6 * 4 * (n + 1), "gather": 4 * m}
    if name == "int8":
        # scale all-reduces (2 x 4 B), the int8 all-to-all, the int8 gather
        want.update(z=ITERS * (8 + n + n // Q), mu=ITERS * (8 + m + m // P),
                    delta=ITERS * 4 * mt)
    else:
        want.update(z=ITERS * 4 * n, mu=ITERS * 4 * m,
                    delta=ITERS * 4 * (mt if name == "shard_map" else m))
    assert run["payload"] == want


@pytest.mark.parametrize("P,Q", [(1, 1), (2, 2), (4, 3), (5, 3), (16, 16)])
@pytest.mark.parametrize("flags", [{}, {"gather_deltas": False},
                                   {"compress_mu": True},
                                   {"compress_z": True, "compress_mu": True}])
def test_iteration_collective_bytes_is_the_reference(P, Q, flags):
    jcfg = JaxConfig(P=P, Q=Q, n=120, m=48 * P, L=8)
    pcfg = port_configs.SoddaConfig(**dataclasses.asdict(jcfg))
    assert port_distributed.iteration_collective_bytes(pcfg, **flags) == \
        iteration_collective_bytes(jcfg, **flags)


# ---------------------------------------------------------------------------
# Option validation: no process group needed (a stand-in mesh object).
# ---------------------------------------------------------------------------
def _fake_mesh(cfg=CFG):
    return types.SimpleNamespace(shape=(cfg.P, cfg.Q),
                                 device=torch.device("cpu"),
                                 get_coordinate=lambda: (0, 0))


def test_mesh_backends_are_registered():
    assert {"shard_map", "shard_map+cuda", "async-mesh"} <= set(
        engine.available_backends())
    assert set(engine.NOT_PORTED) == {"pallas", "shard_map+pallas"}


@pytest.mark.parametrize("backend,hint", [("pallas", "'cuda'"),
                                          ("shard_map+pallas",
                                           "'shard_map+cuda'")])
def test_pallas_names_raise_with_their_counterpart(backend, hint):
    with pytest.raises(ValueError, match=re.escape(hint)):
        engine.make_bundle(CFG, backend, device="cpu")


@pytest.mark.parametrize("backend", ["reference", "cuda", "radisa-avg",
                                     "async"])
@pytest.mark.parametrize("option", [{"compress_mu": True},
                                    {"compress_z": True},
                                    {"gather_deltas": False}])
def test_wire_options_on_one_device_raise(backend, option):
    with pytest.raises(ValueError, match="distributed backend|no delta"):
        engine.make_bundle(CFG, backend, device="cpu", **option)


@pytest.mark.parametrize("backend", ["shard_map", "shard_map+cuda"])
def test_staleness_on_a_synchronous_mesh_backend_raises(backend):
    with pytest.raises(ValueError, match="staleness"):
        engine.make_bundle(CFG, backend, device="cpu", mesh=_fake_mesh(),
                           staleness=1)


def test_a_mesh_of_another_grid_raises():
    other = port_configs.SoddaConfig(P=2, Q=2, n=80, m=16, L=6)
    with pytest.raises(ValueError, match="does not match"):
        engine.make_bundle(CFG, "shard_map", device="cpu",
                           mesh=_fake_mesh(other))


def test_a_mesh_backend_without_a_process_group_raises():
    with pytest.raises(ValueError, match="multihost.initialize"):
        engine.make_bundle(CFG, "shard_map", device="cpu")


def test_the_streaming_plane_on_a_mesh_raises():
    """What a streaming plane on a mesh still refuses: a mesh of another
    grid (its tiles are functions of the grid), a negative epoch and data
    on another device."""
    cfg = port_configs.SoddaConfig(P=2, Q=2, n=80, m=16, L=6)
    stream = make_plane("streaming", 0, cfg.N, cfg.M, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="cannot serve"):
        stream.materialize_for("shard_map", mesh=_fake_mesh(cfg))
    stream = make_plane("streaming", 0, cfg.N, cfg.M, cfg.P, cfg.Q,
                        device="cpu")
    with pytest.raises(ValueError, match="epoch must be >= 0"):
        stream.materialize_for("shard_map", mesh=_fake_mesh(cfg), epoch=-1)
    with pytest.raises(ValueError, match="lies on cpu"):
        stream.materialize_for("shard_map", mesh=_fake_mesh(cfg),
                               device=torch.device("meta"))


@pytest.mark.parametrize("coord", [(0, 0), (1, 1)])
@pytest.mark.parametrize("epoch", [None, 0, 2])
def test_the_streaming_plane_places_a_rank_tile_on_a_mesh(coord, epoch):
    """A rank's placement of window e is the (p, q) slice of the
    single-device window e, bitwise, drawn alone and past the tile cache."""
    cfg = port_configs.SoddaConfig(P=2, Q=2, n=80, m=16, L=6)
    stream = make_plane("streaming", 0, cfg.N, cfg.M, cfg.P, cfg.Q,
                        device="cpu")
    mesh = types.SimpleNamespace(shape=(cfg.P, cfg.Q),
                                 device=torch.device("cpu"),
                                 get_coordinate=lambda: coord)
    X, y = stream.materialize_for("shard_map", mesh=mesh, epoch=epoch)
    Xw, yw = stream.at_epoch(epoch or 0).materialize()
    (p, q), n, m = coord, cfg.n, cfg.m
    assert torch.equal(X, Xw[p * n:(p + 1) * n, q * m:(q + 1) * m])
    assert torch.equal(y, yw[p * n:(p + 1) * n])
    assert stream.cache_stats == {"hits": 0, "misses": 0, "resident": 0}


def test_a_tiled_plane_of_another_grid_raises_on_a_mesh():
    cfg = port_configs.SoddaConfig(P=2, Q=2, n=80, m=16, L=6)
    tiled = make_plane("tiled", 0, cfg.N, cfg.M, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="cannot serve"):
        tiled.materialize_for("shard_map", mesh=_fake_mesh(cfg))


def test_elastic_calls_with_a_mesh_raise(tmp_path):
    """The errors an elastic mesh rescale still raises, before any group
    is touched: an m_tilde that would not be whole, a boundary off the
    segment cadence, a mesh of another grid (or on a single-device
    backend), and a regrown rank outside the regrown rows."""
    cfg = port_configs.SoddaConfig(P=2, Q=2, n=80, m=16, L=6)
    plane = make_plane("tiled", 0, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")
    state = sodda.init_state(0, cfg.M, "cpu")
    d = str(tmp_path)
    calls = [
        ("not be integral",
         lambda: engine.rescale_bundle(cfg, "shard_map", 3, device="cpu")),
        ("not be integral",
         lambda: engine.rescale_bundle(cfg, "async-mesh", 3, device="cpu")),
        ("segment boundary",
         lambda: run_elastic(0, plane, cfg, 4, "shard_map", checkpoint_dir=d,
                             segment_iters=2, lose_partition_at=3,
                             device="cpu")),
        ("segment boundary",
         lambda: driver.migrate_resumable(0, plane, cfg, 1, state,
                                          "async-mesh", checkpoint_dir=d,
                                          segment_iters=2, device="cpu")),
        ("does not match",
         lambda: engine.rescale_bundle(cfg, "shard_map", 1, device="cpu",
                                       mesh=_fake_mesh(cfg))),
        ("takes no mesh",
         lambda: engine.rescale_bundle(cfg, "cuda", 1, device="cpu",
                                       mesh=_fake_mesh(cfg))),
        ("regrown rows",
         lambda: run_elastic_regrown(0, plane, cfg, 6, "shard_map",
                                     checkpoint_dir=d, segment_iters=2,
                                     lose_partition_at=2, regrow_at=4,
                                     rank=0, generation=2, device="cpu")),
    ]
    for match, call in calls:
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.gpu
def test_kernel_mesh_on_the_card_matches_the_cuda_backend():
    """A 2 x 2 ``shard_map+cuda`` run over gloo on cuda:0 (four ranks on one
    card): one kernel launch a rank an iteration, every rank's w the same,
    F32_REDUCTION of the single-device ``cuda`` run on the same tiled data
    and draws, and ``async-mesh`` at staleness 0 bitwise it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_mesh.py)")
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import sodda_inner as kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    kbuild.build(kernel_build.SOURCE)  # once, before four ranks load it
    cfg = port_configs.SoddaConfig(P=2, Q=2, n=400, m=120, L=16, lr0=0.05)
    spec = ("tiled", 0, cfg.N, cfg.M, cfg.P, cfg.Q)
    runs = [dict(backend=b, iters=6, record_every=2, seed=SEED, options=o)
            for b, o in (("shard_map+cuda", {}),
                         ("async-mesh", {"staleness": 0}))]
    launch = mp.launch_coordinated(mp.rank_runs, 4, (cfg, spec, runs, "cuda:0"),
                                   backend="gloo", timeout=300)
    res = launch.results
    plane = make_plane("tiled", 0, cfg.N, cfg.M, cfg.P, cfg.Q, device="cuda")
    state, hist = driver.run(SEED, plane, cfg, 6, "cuda", record_every=2)
    for r in range(4):
        assert res[r][0]["launches"] == 6 and res[r][1]["launches"] == 6
        np.testing.assert_array_equal(res[r][0]["w"], res[0][0]["w"])
        np.testing.assert_array_equal(res[r][1]["w"], res[0][0]["w"])
    assert_trajectories_close([state.w.cpu().numpy()], [res[0][0]["w"]],
                              F32_REDUCTION, "shard_map+cuda vs cuda")
    for (t, f_ref), (_, f) in zip(hist, res[0][0]["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"t={t}")
