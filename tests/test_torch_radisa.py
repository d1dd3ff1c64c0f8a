"""The port's RADiSA and RADiSA-avg baselines against ``repro.core.radisa``.

Both packages see the same data, passed as numpy arrays, and the same
draws: the reference's row draw J = randint(fold_in(key, t), (P, Q, L),
0, n) is replayed into the port through ``radisa_avg_step(J=...)`` and
``driver.run(sampler=...)``. Steps and histories go through GEMVs, dot
products and a mean over P in another reduction order, so they are held to
F32_REDUCTION; what is the same arithmetic by construction is held BITWISE.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sodda_svm import SoddaConfig as RefConfig
from repro.core import driver as jax_driver
from repro.core import partition as jax_partition
from repro.core import radisa as jax_radisa
from repro.core import sodda as jax_sodda
from repro.data.synthetic import make_svm_data as ref_make_svm_data
from repro.testing import make_problem, medium_fixture_config, small_fixture_config
from repro.testing.tolerances import (BITWISE, F32_REDUCTION,
                                      assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import driver, partition, radisa, sodda
from repro_torch.data.plane import TiledDataPlane

KEY = jax.random.PRNGKey(0)
LOSSES = ["hinge", "logistic", "squared"]
SCHEDULES = ["diminishing", "constant"]
# tests/test_core_sodda.py's configuration of the paper-claim test
PAPER_CFG = RefConfig(P=4, Q=3, n=300, m=48, L=16, lr0=0.05)


def _port_cfg(cfg):
    return port_configs.SoddaConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _case(loss, schedule):
    cfg = small_fixture_config(loss, schedule)
    X, y = make_problem(cfg)
    return cfg, np.array(X), np.array(y)


def _jax_J(cfg, t, key=KEY):
    """The row draw the reference's radisa_avg_step takes at iteration t."""
    return np.asarray(jax.random.randint(jax.random.fold_in(key, t),
                                         (cfg.P, cfg.Q, cfg.L), 0, cfg.n))


def _replay_J(cfg, key=KEY):
    return lambda t: torch.tensor(_jax_J(cfg, t, key), dtype=torch.int64)


def _replay_sample(cfg, key=KEY):
    b, c, d = jax_sodda._counts(cfg)

    def sampler(t):
        s = jax_partition.sample_iteration(key, jnp.int32(t), cfg.P, cfg.Q,
                                           cfg.n, cfg.M, cfg.L, b, c, d)
        return partition.sample_from_numpy(*(np.asarray(f) for f in s),
                                           device="cpu")

    return sampler


def _iterate(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=cfg.M) * 0.1).astype(np.float32)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel-wrapper"])
def test_radisa_avg_step_matches_reference(loss, schedule, use_kernel):
    cfg, X, y = _case(loss, schedule)
    w = _iterate(cfg, 4)
    for t in (1, 3):
        want = jax_radisa.radisa_avg_step(
            jax_sodda.SoddaState(w=jnp.asarray(w), t=jnp.int32(t), key=KEY),
            jnp.asarray(X), jnp.asarray(y), cfg)
        got = radisa.radisa_avg_step(
            sodda.state_from_numpy(w, t, device="cpu"), torch.tensor(X),
            torch.tensor(y), _port_cfg(cfg), use_kernel=use_kernel,
            J=torch.tensor(_jax_J(cfg, t)))
        assert got.t == int(want.t) == t + 1
        assert_trajectories_close([np.asarray(want.w)], [got.w.numpy()],
                                  F32_REDUCTION, f"{loss}/{schedule} t={t}")


@pytest.mark.parametrize("loss", LOSSES)
def test_run_radisa_avg_matches_reference_driver(loss):
    cfg, X, y = _case(loss, "diminishing")
    ref_state, ref_hist = jax_driver.run(KEY, (jnp.asarray(X),
                                               jnp.asarray(y)),
                                         cfg, 5, "radisa-avg",
                                         record_every=2)
    state, hist = radisa.run_radisa_avg(
        0, torch.tensor(X), torch.tensor(y), _port_cfg(cfg), 5,
        record_every=2, device="cpu", sampler=_replay_J(cfg))
    assert [t for t, _ in hist] == [t for t, _ in ref_hist]
    for (t, f_ref), (_, f) in zip(ref_hist, hist):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"{loss} t={t}")
    assert_trajectories_close([np.asarray(ref_state.w)], [state.w.numpy()],
                              F32_REDUCTION, f"{loss} final w")
    assert state.t == int(ref_state.t) == 6


def test_radisa_config_matches_reference():
    cfg = small_fixture_config()
    assert dataclasses.asdict(radisa.radisa_config(_port_cfg(cfg))) == \
        dataclasses.asdict(jax_radisa.radisa_config(cfg))


@pytest.mark.parametrize("loss", LOSSES)
def test_radisa_step_is_sodda_step_at_full_fractions(loss):
    """RADiSA is SODDA at b = c = d = 1 (paper Corollary 1): bitwise the
    port's sodda_step on the same sample, and F32_REDUCTION against the
    reference's radisa_step on its own sample."""
    cfg, X, y = _case(loss, "diminishing")
    full = jax_radisa.radisa_config(cfg)
    w = _iterate(cfg, 5)
    sample = _replay_sample(full)(1)
    state = sodda.state_from_numpy(w, 1, device="cpu")
    Xt, yt = torch.tensor(X), torch.tensor(y)
    got = radisa.radisa_step(state, Xt, yt, _port_cfg(cfg), sample=sample)
    same = sodda.sodda_step(state, Xt, yt, _port_cfg(full), sample=sample)
    assert_trajectories_close([same.w.numpy()], [got.w.numpy()], BITWISE)
    want = jax_radisa.radisa_step(
        jax_sodda.SoddaState(w=jnp.asarray(w), t=jnp.int32(1), key=KEY),
        jnp.asarray(X), jnp.asarray(y), cfg)
    assert_trajectories_close([np.asarray(want.w)], [got.w.numpy()],
                              F32_REDUCTION, loss)
    np.testing.assert_array_equal(sample.mask_b.numpy(), 1.0)
    np.testing.assert_array_equal(sample.mask_d.numpy(), 1.0)


@pytest.mark.parametrize("cfg", [small_fixture_config(),
                                 medium_fixture_config(), PAPER_CFG,
                                 port_configs.SMALL, port_configs.LARGE,
                                 port_configs.TABLE1_250K_18K],
                         ids=["small", "medium", "paper-test", "SMALL",
                              "LARGE", "table1"])
def test_radisa_avg_iteration_flops_match(cfg):
    ref_cfg = RefConfig(**dataclasses.asdict(cfg))
    assert radisa.radisa_avg_iteration_flops(_port_cfg(cfg)) == \
        jax_radisa.radisa_avg_iteration_flops(ref_cfg)


def test_table1_cost_ratio():
    """At Table-1 a RADiSA-avg iteration costs ~1.43 SODDA iterations in
    gradient coordinates."""
    cfg = port_configs.TABLE1_250K_18K
    ratio = radisa.radisa_avg_iteration_flops(cfg) / sodda.iteration_flops(cfg)
    assert 1.40 < ratio < 1.45, ratio


@pytest.mark.parametrize("backend_data", ["tensors", "tiled-plane"])
def test_runs_descend_with_the_ports_own_draws(backend_data):
    cfg = _port_cfg(PAPER_CFG)
    if backend_data == "tensors":
        X, y, _ = ref_make_svm_data(jax.random.PRNGKey(0), cfg.N, cfg.M)
        data = (torch.tensor(np.asarray(X)), torch.tensor(np.asarray(y)))
    else:
        data = TiledDataPlane(0, cfg.N, cfg.M, cfg.P, cfg.Q,
                              device="cpu").materialize()
    runs = [radisa.run_radisa_avg(8, *data, cfg, 15, record_every=15,
                                  device="cpu") for _ in range(2)]
    (s1, h1), (s2, h2) = runs
    assert h1 == h2 and torch.equal(s1.w, s2.w)  # a pure function of seed
    assert h1[-1][1] < h1[0][1] * 0.7, h1


def test_paper_claim_sodda_beats_radisa_avg_early_per_flop():
    """Paper §5, as tests/test_core_sodda.py states it: at an equal early
    budget of gradient coordinates SODDA's objective is below 1.05x
    RADiSA-avg's, on the reference's data and the reference's draws."""
    cfg = _port_cfg(PAPER_CFG)
    X, y, _ = ref_make_svm_data(jax.random.PRNGKey(0), cfg.N, cfg.M)
    data = (torch.tensor(np.asarray(X)), torch.tensor(np.asarray(y)))
    budget = 12 * sodda.iteration_flops(cfg)
    it_s = int(budget / sodda.iteration_flops(cfg))
    it_r = max(1, int(budget / radisa.radisa_avg_iteration_flops(cfg)))
    key = jax.random.PRNGKey(9)
    _, hs = driver.run(0, data, cfg, it_s, "reference", record_every=it_s,
                       device="cpu", sampler=_replay_sample(PAPER_CFG, key))
    _, hr = radisa.run_radisa_avg(0, *data, cfg, it_r, record_every=it_r,
                                  device="cpu",
                                  sampler=_replay_J(PAPER_CFG, key))
    assert hs[-1][1] < hr[-1][1] * 1.05, (hs[-1], hr[-1])


def test_gather_reads_whole_feature_blocks():
    """Worker (p, q)'s chain reads rows p*n + J[p, q] and the m columns of
    feature block q: one step with gamma_t's plain loop by hand."""
    cfg, X, y = _case("squared", "constant")
    pcfg = _port_cfg(cfg)
    w = _iterate(cfg, 6)
    J = torch.tensor(_jax_J(cfg, 2))
    Xt, yt, wt = torch.tensor(X), torch.tensor(y), torch.tensor(w)
    got = radisa.radisa_avg_step(sodda.state_from_numpy(w, 2, device="cpu"),
                                 Xt, yt, pcfg, J=J)
    from repro_torch.core import losses
    mu = losses.full_gradient(cfg.loss, Xt, yt, wt)
    gamma = float(sodda._gamma(pcfg, 2))
    n, m = cfg.n, cfg.m
    wL = torch.stack([torch.cat([
        sodda.inner_loop(cfg.loss, wt[q * m:(q + 1) * m],
                         Xt[p * n + J[p, q], q * m:(q + 1) * m],
                         yt[p * n + J[p, q]], mu[q * m:(q + 1) * m], gamma)
        for q in range(cfg.Q)]) for p in range(cfg.P)])
    assert_trajectories_close([wL.mean(dim=0).numpy()], [got.w.numpy()],
                              F32_REDUCTION)
