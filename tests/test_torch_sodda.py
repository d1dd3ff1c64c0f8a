"""The port's SODDA step against ``repro.core.sodda``, fed the same data and
the same JAX-drawn sample, over the 3 losses x 2 learning-rate schedules of
``small_fixture_config`` (the conformance matrix of the reference).

Tolerances: gamma_t, computed on the host in float32, is held BITWISE to the
reference's on-device value; the snapshot gradient, the consume half and
whole steps go through matrix-vector products and dot products in another
reduction order and are held to F32_REDUCTION.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.testing import make_problem, medium_fixture_config, small_fixture_config
from repro.testing.tolerances import F32_REDUCTION, assert_trajectories_close
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import engine, partition, sodda

KEY = jax.random.PRNGKey(0)
LOSSES = ["hinge", "logistic", "squared"]
SCHEDULES = ["diminishing", "constant"]


def _port_cfg(cfg):
    return port_configs.SoddaConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _case(loss, schedule):
    cfg = small_fixture_config(loss, schedule)
    X, y = make_problem(cfg)
    return cfg, np.array(X), np.array(y)


def _jax_sample(cfg, t):
    b, c, d = jax_sodda._counts(cfg)
    return jax_partition.sample_iteration(KEY, jnp.int32(t), cfg.P, cfg.Q,
                                          cfg.n, cfg.M, cfg.L, b, c, d)


def _port_sample(jax_sample):
    return partition.sample_from_numpy(*(np.asarray(f) for f in jax_sample),
                                       device="cpu")


def _iterate(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=cfg.M) * 0.1).astype(np.float32)


GAMMA_CONFIGS = {
    "small-diminishing": small_fixture_config("hinge", "diminishing"),
    "small-constant": small_fixture_config("hinge", "constant"),
    "paper-lr0-1": port_configs.SMALL,
    "table1-lr0-0.01": port_configs.TABLE1_250K_18K,
}


@pytest.mark.parametrize("name", sorted(GAMMA_CONFIGS))
def test_gamma_is_bitwise_the_reference(name):
    cfg = GAMMA_CONFIGS[name]
    ref_cfg = jax_sodda.SoddaConfig(**dataclasses.asdict(cfg))
    jitted = jax.jit(lambda t: jax_sodda._gamma(ref_cfg, t))
    for t in range(1, 65):
        got = np.asarray(sodda._gamma(_port_cfg(cfg), t), np.float32)
        for want in (jitted(jnp.int32(t)), jax_sodda._gamma(ref_cfg,
                                                           jnp.int32(t))):
            want = np.asarray(want, np.float32)
            assert got.view(np.uint32) == want.view(np.uint32), (t, got, want)


@pytest.mark.parametrize("cfg", [small_fixture_config(),
                                 medium_fixture_config(),
                                 port_configs.TABLE1_250K_18K],
                         ids=["small", "medium", "table1"])
def test_counts_and_flops_match(cfg):
    ref_cfg = jax_sodda.SoddaConfig(**dataclasses.asdict(cfg))
    assert sodda._counts(_port_cfg(cfg)) == jax_sodda._counts(ref_cfg)
    for exact in (False, True):
        assert sodda.iteration_flops(_port_cfg(cfg), exact) == \
            jax_sodda.iteration_flops(ref_cfg, exact)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_snapshot_gradient(loss, schedule):
    cfg, X, y = _case(loss, schedule)
    w = _iterate(cfg, 1)
    smp = _jax_sample(cfg, 3)
    d_count = cfg.P * jax_sodda._counts(cfg)[2]
    want = jax_sodda.snapshot_gradient(loss, jnp.asarray(X),
                                        jnp.asarray(y), w, smp, d_count)
    got = sodda.snapshot_gradient(loss, torch.tensor(X),
                                  torch.tensor(y), torch.tensor(w),
                                  _port_sample(smp), d_count)
    assert_trajectories_close([np.asarray(want)], [got.numpy()],
                              F32_REDUCTION, f"{loss}/{schedule}")


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel-wrapper"])
def test_consume_update(loss, schedule, use_kernel):
    cfg, X, y = _case(loss, schedule)
    w = _iterate(cfg, 2)
    smp = _jax_sample(cfg, 4)
    rng = np.random.default_rng(3)
    mu = (rng.normal(size=cfg.M) * 0.01).astype(np.float32)
    gamma = jax_sodda._gamma(cfg, jnp.int32(4))
    want = jax_sodda.consume_update(*map(jnp.asarray, (X, y, w, mu)), smp,
                                     gamma, cfg)
    got = sodda.consume_update(
        torch.tensor(X), torch.tensor(y), torch.tensor(w),
        torch.tensor(mu), _port_sample(smp),
        float(sodda._gamma(_port_cfg(cfg), 4)), _port_cfg(cfg), use_kernel)
    assert_trajectories_close([np.asarray(want)], [got.numpy()],
                              F32_REDUCTION, f"{loss}/{schedule}")


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_sodda_step_trajectory(loss, schedule, backend):
    """Three steps from w = 0 on both port backends (``cuda`` takes the
    plain inner loop for CPU tensors) against the reference's jitted
    ``sodda_step``, each step fed the reference's own sample."""
    cfg, X, y = _case(loss, schedule)
    step = engine.make_step(_port_cfg(cfg), backend, device="cpu")
    ref_state = jax_sodda.init_state(KEY, cfg.M)
    state = sodda.init_state(0, cfg.M, "cpu")
    Xt, yt = torch.tensor(X), torch.tensor(y)
    ref_ws, ws = [], []
    for t in range(1, 4):
        smp = _jax_sample(cfg, t)
        ref_state = jax_sodda.sodda_step(ref_state, X, y, cfg)
        state = step(state, Xt, yt, _port_sample(smp))
        assert state.t == int(ref_state.t) == t + 1
        ref_ws.append(np.asarray(ref_state.w))
        ws.append(state.w.numpy())
    assert_trajectories_close(ref_ws, ws, F32_REDUCTION,
                              f"{backend} {loss}/{schedule}")


def test_state_from_numpy_carries_a_reference_state():
    ref_state = jax_sodda.SoddaState(w=jnp.arange(6, dtype=jnp.float32),
                                     t=jnp.int32(5), key=KEY)
    state = sodda.state_from_numpy(np.asarray(ref_state.w), ref_state.t,
                                   device="cpu")
    np.testing.assert_array_equal(state.w.numpy(), np.asarray(ref_state.w))
    assert state.t == 5 and isinstance(state.t, int)
    assert state.w.dtype == torch.float32


def test_own_draw_is_deterministic_per_seed():
    cfg, X, y = _case("hinge", "diminishing")
    pcfg = _port_cfg(cfg)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    a = sodda.sodda_step(sodda.init_state(7, cfg.M, "cpu"), Xt, yt, pcfg)
    b = sodda.sodda_step(sodda.init_state(7, cfg.M, "cpu"), Xt, yt, pcfg)
    c = sodda.sodda_step(sodda.init_state(8, cfg.M, "cpu"), Xt, yt, pcfg)
    assert torch.equal(a.w, b.w) and not torch.equal(a.w, c.w)
