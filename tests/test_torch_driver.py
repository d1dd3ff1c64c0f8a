"""The port's engine and run driver against ``repro.core.driver.run``.

Runs on the CPU (``device="cpu"``) with ``sampler`` replaying the samples
the JAX reference draws, so both packages see the same data and the same
randomness. Histories and final iterates are held to F32_REDUCTION (same
math, another reduction order). The port's ``cuda`` backend takes the
plain inner loop for CPU tensors; it is compared with the reference's
``pallas`` backend in Pallas interpret mode, which compiles anew for
every configuration, so those cells are kept to three.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import driver as jax_driver
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.testing import make_problem, medium_fixture_config, small_fixture_config
from repro.testing.tolerances import (BITWISE, F32_REDUCTION,
                                      assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import driver, engine, partition

KEY = jax.random.PRNGKey(0)
ITERS, RECORD_EVERY = 5, 2


def _port_cfg(cfg):
    return port_configs.SoddaConfig(**dataclasses.asdict(cfg))


def _replay(cfg):
    """sampler(t): the sample the reference draws at iteration t."""
    b, c, d = jax_sodda._counts(cfg)

    def sampler(t):
        s = jax_partition.sample_iteration(KEY, jnp.int32(t), cfg.P, cfg.Q,
                                           cfg.n, cfg.M, cfg.L, b, c, d)
        return partition.sample_from_numpy(*(np.asarray(f) for f in s),
                                           device="cpu")

    return sampler


def _assert_runs_agree(cfg, jax_backend, port_backend):
    X, y = make_problem(cfg)
    ref_state, ref_hist = jax_driver.run(KEY, (X, y), cfg, ITERS, jax_backend,
                                         record_every=RECORD_EVERY)
    state, hist = driver.run(
        0, (torch.tensor(np.asarray(X)), torch.tensor(np.asarray(y))),
        _port_cfg(cfg), ITERS, port_backend, record_every=RECORD_EVERY,
        device="cpu", sampler=_replay(cfg))
    assert [t for t, _ in hist] == [t for t, _ in ref_hist]
    for (t, f_ref), (_, f) in zip(ref_hist, hist):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"t={t}")
    assert_trajectories_close([np.asarray(ref_state.w)], [state.w.numpy()],
                              F32_REDUCTION, f"{cfg.name} final w")
    assert state.t == int(ref_state.t) == ITERS + 1


@pytest.mark.parametrize("iters,record_every",
                         [(5, 2), (4, 2), (1, 1), (0, 3), (7, 10), (20, 5)])
def test_record_ticks_and_chunks_match_reference(iters, record_every):
    assert driver.record_ticks(iters, record_every) == \
        jax_driver.record_ticks(iters, record_every)
    assert driver._chunk_lengths(iters, record_every) == \
        jax_driver._chunk_lengths(iters, record_every)


@pytest.mark.parametrize("iters,record_every", [(-1, 1), (3, 0)])
def test_record_ticks_refuses_like_reference(iters, record_every):
    with pytest.raises(ValueError):
        jax_driver.record_ticks(iters, record_every)
    with pytest.raises(ValueError):
        driver.record_ticks(iters, record_every)


@pytest.mark.parametrize("loss", ["hinge", "logistic", "squared"])
def test_reference_backend_matches_reference_small(loss):
    _assert_runs_agree(small_fixture_config(loss), "reference", "reference")


def test_reference_backend_matches_reference_medium():
    _assert_runs_agree(medium_fixture_config("logistic"), "reference",
                       "reference")


@pytest.mark.parametrize("loss,schedule", [("hinge", "diminishing"),
                                           ("logistic", "constant"),
                                           ("squared", "diminishing")])
def test_cuda_backend_matches_pallas_backend(loss, schedule):
    _assert_runs_agree(small_fixture_config(loss, schedule), "pallas", "cuda")


def test_own_sampling_descends_and_is_deterministic():
    cfg = _port_cfg(small_fixture_config("hinge"))
    X, y = make_problem(cfg)
    data = (torch.tensor(np.asarray(X)), torch.tensor(np.asarray(y)))
    runs = [driver.run(3, data, cfg, 20, "cuda", record_every=5,
                       device="cpu") for _ in range(2)]
    (s1, h1), (s2, h2) = runs
    assert_trajectories_close([s1.w.numpy()], [s2.w.numpy()], BITWISE)
    assert h1 == h2
    fs = [f for _, f in h1]
    assert all(np.isfinite(fs)) and fs[-1] < fs[0], h1


def test_zero_iterations_record_the_initial_objective():
    cfg = _port_cfg(small_fixture_config("logistic"))
    X, y = make_problem(cfg)
    state, hist = driver.run(0, (torch.tensor(np.asarray(X)),
                                 torch.tensor(np.asarray(y))), cfg, 0,
                             device="cpu")
    assert state.t == 1 and [t for t, _ in hist] == [0]
    assert hist[0][1] == pytest.approx(np.log(2.0), rel=1e-6)


def test_run_refuses_data_of_the_wrong_shape():
    cfg = _port_cfg(small_fixture_config())
    with pytest.raises(ValueError, match="do not match"):
        driver.run(0, (torch.zeros(cfg.N, cfg.M + 1), torch.zeros(cfg.N)),
                   cfg, 1, device="cpu")


OPTIONS = {
    "mesh": dict(mesh=object()),
    "compress_mu": dict(compress_mu=True),
    "compress_z": dict(compress_z=True),
    "gather_deltas": dict(gather_deltas=False),
    "staleness": dict(staleness=1),
    "block_l": dict(block_l=8),
}


@pytest.mark.parametrize("backend", engine.BACKENDS)
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_engine_refuses_options_it_cannot_affect(backend, option):
    cfg = _port_cfg(small_fixture_config())
    with pytest.raises(ValueError, match=backend):
        engine.make_step(cfg, backend, device="cpu", **OPTIONS[option])


@pytest.mark.parametrize("backend", engine.NOT_PORTED)
def test_engine_names_backends_not_ported_yet(backend):
    cfg = _port_cfg(small_fixture_config())
    with pytest.raises(ValueError, match="not ported yet"):
        engine.make_step(cfg, backend, device="cpu")


def test_engine_refuses_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        engine.make_step(_port_cfg(small_fixture_config()), "tpu",
                         device="cpu")


def test_engine_backends():
    assert engine.available_backends() == (
        "async", "async-mesh", "cuda", "radisa-avg", "reference",
        "shard_map", "shard_map+cuda")
    assert engine.BACKENDS == ("reference", "cuda")
    assert engine.BASELINE_BACKENDS == ("radisa-avg",)
    assert engine.ASYNC_BACKENDS == ("async", "async-mesh")
    assert engine.MESH_BACKENDS == ("shard_map", "shard_map+cuda",
                                    "async-mesh")


def test_step_refuses_data_on_another_device():
    cfg = _port_cfg(small_fixture_config())
    step = engine.make_step(cfg, "reference", device="cpu")
    X = torch.zeros(cfg.N, cfg.M, device="meta")
    with pytest.raises(ValueError, match="X is on meta"):
        step(engine.init_state(0, cfg.M, "cpu"), X, torch.zeros(cfg.N))


@pytest.mark.parametrize("entry", ["run", "make_step"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = _port_cfg(small_fixture_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "run":
            driver.run(0, (torch.zeros(cfg.N, cfg.M), torch.zeros(cfg.N)),
                       cfg, 1)
        else:
            engine.make_step(cfg, "cuda")
