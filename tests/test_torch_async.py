"""The port's stale-by-one ``async`` backend against ``repro.core.sodda``'s
``sodda_step_async`` and the reference's ``async`` engine backend.

At ``staleness=0`` the async step is the synchronous step's arithmetic, so
it is held BITWISE to the port's ``reference`` backend. Against the JAX
package, with the reference's samples replayed (the warm-up's included),
steps and trajectories are held to F32_REDUCTION at both stalenesses; with
the port's own draws, the final objective of a stale-by-one run is held to
STALENESS of the synchronous one, as ``tests/test_conformance.py`` holds
the reference.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import driver as jax_driver
from repro.core import partition as jax_partition
from repro.core import sodda as jax_sodda
from repro.testing import make_problem, small_fixture_config
from repro.testing.tolerances import (BITWISE, F32_REDUCTION, STALENESS,
                                      assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import driver, engine, partition, sodda

KEY = jax.random.PRNGKey(1)
LOSSES = ["hinge", "logistic", "squared"]
SCHEDULES = ["diminishing", "constant"]
ITERS, RECORD_EVERY = 6, 2
ASYNC_ITERS = 30  # tests/test_conformance.py: room to converge back


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


def _replay(cfg):
    return lambda t: partition.sample_from_numpy(
        *(np.asarray(f) for f in _jax_sample(cfg, t)), device="cpu")


def _data(X, y):
    return torch.tensor(X), torch.tensor(y)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_staleness_zero_is_bitwise_the_reference_backend(loss, schedule):
    cfg, X, y = _case(loss, schedule)
    pcfg, data = _port_cfg(cfg), _data(X, y)
    sync = engine.make_bundle(pcfg, "reference", device="cpu")
    stale0 = engine.make_bundle(pcfg, "async", device="cpu", staleness=0)
    state = engine.init_state(5, pcfg.M, "cpu")
    ref_ws, ws = [state.w], []
    carry = stale0.init_carry(state, *data)
    ws.append(carry.w)
    for _ in range(ITERS):
        state = sync.step(state, *data)
        carry = stale0.step(carry, *data)
        ref_ws.append(state.w)
        ws.append(carry.w)
    assert_trajectories_close([w.numpy() for w in ref_ws],
                              [w.numpy() for w in ws], BITWISE,
                              f"async/staleness=0 {loss}/{schedule}")
    s_ref, h_ref = driver.run(5, data, pcfg, ITERS, "reference",
                              record_every=RECORD_EVERY, device="cpu")
    s, h = driver.run(5, data, pcfg, ITERS, "async", staleness=0,
                      record_every=RECORD_EVERY, device="cpu")
    assert h == h_ref and torch.equal(s.w, s_ref.w)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("staleness", [0, 1])
def test_trajectory_matches_reference_async(loss, schedule, staleness):
    cfg, X, y = _case(loss, schedule)
    ref_state, ref_hist = jax_driver.run(
        KEY, (jnp.asarray(X), jnp.asarray(y)), cfg, ITERS, "async",
        record_every=RECORD_EVERY, staleness=staleness)
    state, hist = driver.run(0, _data(X, y), _port_cfg(cfg), ITERS, "async",
                             record_every=RECORD_EVERY, device="cpu",
                             sampler=_replay(cfg), staleness=staleness)
    ctx = f"async/staleness={staleness} {loss}/{schedule}"
    assert [t for t, _ in hist] == [t for t, _ in ref_hist]
    for (t, f_ref), (_, f) in zip(ref_hist, hist):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"{ctx} t={t}")
    assert_trajectories_close([np.asarray(ref_state.w)], [state.w.numpy()],
                              F32_REDUCTION, ctx)
    assert state.t == int(ref_state.t) == ITERS + 1


@pytest.mark.parametrize("staleness", [0, 1])
def test_step_from_a_reference_carry(staleness):
    """A reference carry (w, t, mu) crosses over with
    async_state_from_numpy, and one step on both sides agrees."""
    cfg, X, y = _case("logistic", "diminishing")
    rng = np.random.default_rng(7)
    w = (rng.normal(size=cfg.M) * 0.1).astype(np.float32)
    carry = jax_sodda.init_async_state(
        jax_sodda.SoddaState(w=jnp.asarray(w), t=jnp.int32(3), key=KEY),
        jnp.asarray(X), jnp.asarray(y), cfg)
    want = jax_sodda.sodda_step_async(carry, jnp.asarray(X), jnp.asarray(y),
                                      cfg, staleness=staleness)
    got = sodda.sodda_step_async(
        sodda.async_state_from_numpy(carry.w, carry.t, carry.mu,
                                     device="cpu"),
        *_data(X, y), _port_cfg(cfg), staleness=staleness,
        sample=_replay(cfg)(3))
    assert got.t == int(want.t) == 4
    assert_trajectories_close([np.asarray(want.w), np.asarray(want.mu)],
                              [got.w.numpy(), got.mu.numpy()],
                              F32_REDUCTION, f"staleness={staleness}")


def test_warm_up_issues_the_first_exchange():
    """init_async_state's mu is the snapshot the sync step at t would
    compute: the reference's, under the reference's sample."""
    cfg, X, y = _case("hinge", "diminishing")
    state = jax_sodda.init_state(KEY, cfg.M)
    want = jax_sodda.init_async_state(state, jnp.asarray(X), jnp.asarray(y),
                                      cfg)
    got = sodda.init_async_state(engine.init_state(0, cfg.M, "cpu"),
                                 *_data(X, y), _port_cfg(cfg),
                                 sample=_replay(cfg)(1))
    assert got.t == 1
    assert_trajectories_close([np.asarray(want.mu)], [got.mu.numpy()],
                              F32_REDUCTION)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_converges_to_the_reference_backends_optimum(loss, schedule):
    cfg, X, y = _case(loss, schedule)
    pcfg, data = _port_cfg(cfg), _data(X, y)
    _, h_ref = driver.run(1, data, pcfg, ASYNC_ITERS, "reference",
                          record_every=ASYNC_ITERS, device="cpu")
    _, h_async = driver.run(1, data, pcfg, ASYNC_ITERS, "async",
                            record_every=ASYNC_ITERS, device="cpu")
    ctx = f"async/{loss}/{schedule}"
    assert_objectives_close(h_ref[-1][1], h_async[-1][1], STALENESS, ctx)
    assert h_async[-1][1] < h_async[0][1], (ctx, h_async)


def test_finalize_strips_the_exchange_buffer():
    cfg, X, y = _case("hinge", "diminishing")
    pcfg, data = _port_cfg(cfg), _data(X, y)
    bundle = engine.make_bundle(pcfg, "async", device="cpu")
    carry = bundle.init_carry(engine.init_state(2, pcfg.M, "cpu"), *data)
    assert isinstance(carry, sodda.AsyncSoddaState)
    for _ in range(3):
        carry = bundle.step(carry, *data)
    final = bundle.finalize(carry)
    assert isinstance(final, sodda.SoddaState) and not hasattr(final, "mu")
    assert final.t == 4 and torch.equal(final.w, carry.w)
    state, _ = driver.run(2, data, pcfg, 3, "async", device="cpu")
    assert isinstance(state, sodda.SoddaState) and state.t == 4


REFUSALS = {
    "async-staleness-2": ("async", dict(staleness=2), "staleness must be 0"),
    "reference-staleness": ("reference", dict(staleness=1), "synchronous"),
    "cuda-staleness": ("cuda", dict(staleness=0), "synchronous"),
    "radisa-avg-staleness": ("radisa-avg", dict(staleness=1), "synchronous"),
    "async-compress": ("async", dict(compress_mu=True), "no collectives"),
    "async-mesh": ("async", dict(mesh=object()), "takes no mesh"),
    "async-gather": ("async", dict(gather_deltas=False), "delta exchange"),
    "async-block_l": ("async", dict(block_l=8), "block_l"),
    "radisa-avg-block_l": ("radisa-avg", dict(block_l=8), "block_l"),
    "radisa-avg-compress": ("radisa-avg", dict(compress_z=True),
                            "no collectives"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_backend_option_validation(case):
    backend, options, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        engine.make_bundle(_port_cfg(small_fixture_config()), backend,
                           device="cpu", **options)


@pytest.mark.parametrize("staleness", [None, 0, 1])
def test_resolve_staleness(staleness):
    opts = engine.EngineOptions(staleness=staleness)
    assert opts.resolve_staleness() == (1 if staleness is None else staleness)
