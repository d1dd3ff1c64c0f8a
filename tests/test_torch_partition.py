"""Port sampling and partition helpers against ``repro.core.partition``.

The port draws from a torch generator, so its samples are held to the
reference's *invariants* (``repro.testing.invariants``), not its bits; the
replay seam (``sample_from_numpy``) and the index helpers are held BITWISE.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as ref
from repro.core import sodda as ref_sodda
from repro.testing import medium_fixture_config, small_fixture_config
from repro.testing.invariants import (assert_samples_equal,
                                      check_iteration_sample)
from repro_torch.configs.sodda_svm import TABLE1_250K_18K
from repro_torch.core import partition as port
from repro_torch.core import sodda as port_sodda

CONFIGS = {
    "small": small_fixture_config("hinge"),
    "medium": medium_fixture_config("hinge"),
    # Table-1's grid, fractions and L at a reduced n and m
    "table1-grid": dataclasses.replace(TABLE1_250K_18K, n=2000, m=600),
}


def _draw(cfg, seed, t):
    b, c, d = port_sodda._counts(cfg)
    return port.sample_iteration(seed, t, cfg.P, cfg.Q, cfg.n, cfg.M, cfg.L,
                                 b, c, d, device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("t", [1, 2, 17])
def test_sample_passes_reference_invariants(name, t):
    cfg = CONFIGS[name]
    b, c, d = ref_sodda._counts(cfg)
    check_iteration_sample(_draw(cfg, 3, t), cfg.P, cfg.Q, cfg.n, cfg.M,
                           cfg.L, b, c, d)


def test_sample_is_a_pure_function_of_seed_and_t():
    cfg = CONFIGS["medium"]
    a, b = _draw(cfg, 5, 4), _draw(cfg, 5, 4)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name
    for other in (_draw(cfg, 5, 5), _draw(cfg, 6, 4)):
        assert not torch.equal(a.mask_b, other.mask_b)
        assert not torch.equal(a.J, other.J)


def test_sample_dtypes():
    s = _draw(CONFIGS["small"], 0, 1)
    assert [f.dtype for f in s] == [torch.float32] * 3 + [torch.int64] * 2


def test_permutations_cover_all_orders():
    """pi_q is drawn uniformly: over many iterations every order of P=3
    shows up, in roughly equal shares (each of 6 orders, 600 draws)."""
    cfg = dataclasses.replace(CONFIGS["small"], P=3, m=24)
    counts = {}
    for t in range(1, 301):
        for row in _draw(cfg, 0, t).pi.tolist():
            counts[tuple(row)] = counts.get(tuple(row), 0) + 1
    assert len(counts) == 6, counts
    assert min(counts.values()) > 60, counts  # expectation 100 each


def test_mask_inclusion_is_uniform():
    """Every feature enters B^t with probability b/M (binomial bounds)."""
    cfg = CONFIGS["small"]
    b, c, _ = port_sodda._counts(cfg)
    draws = 400
    freq = sum(_draw(cfg, 1, t).mask_b for t in range(1, draws + 1)) / draws
    p = b / cfg.M
    sigma = (p * (1 - p) / draws) ** 0.5
    assert float((freq - p).abs().max()) < 5 * sigma


def test_exact_count_mask_is_exact_under_ties():
    u = torch.zeros(2, 10)
    m = port._exact_count_mask(u, 4)
    assert m.sum(dim=1).tolist() == [4.0, 4.0]
    assert torch.equal(port._exact_count_mask(u, 10), torch.ones(2, 10))


def test_exact_count_mask_nested():
    u = torch.rand(100, generator=torch.Generator().manual_seed(0))
    mb, mc = port._exact_count_mask(u, 60), port._exact_count_mask(u, 30)
    assert bool((mc <= mb).all())
    assert torch.equal(port._exact_count_mask(u, 60),
                       (u <= torch.sort(u).values[59]).float())


@pytest.mark.parametrize("t", [1, 9])
def test_sample_from_numpy_round_trips_a_jax_sample(t):
    cfg = CONFIGS["medium"]
    b, c, d = ref_sodda._counts(cfg)
    want = ref.sample_iteration(jax.random.PRNGKey(2), jnp.int32(t), cfg.P,
                                cfg.Q, cfg.n, cfg.M, cfg.L, b, c, d)
    got = port.sample_from_numpy(*(np.asarray(f) for f in want), device="cpu")
    assert_samples_equal(want, tuple(f.numpy() for f in got))
    check_iteration_sample(got, cfg.P, cfg.Q, cfg.n, cfg.M, cfg.L, b, c, d)


def test_blocks_view_matches_reference_without_copying():
    P, Q, n, m = 3, 2, 5, 12
    X = np.arange(P * n * Q * m, dtype=np.float32).reshape(P * n, Q * m)
    Xt = torch.from_numpy(X.copy())
    view = port.blocks_view(Xt, P, Q)
    np.testing.assert_array_equal(view.numpy(),
                                  np.asarray(ref.blocks_view(X, P, Q)))
    assert view.data_ptr() == Xt.data_ptr()


def test_block_col_start_matches_reference():
    for q, k in [(0, 0), (1, 3), (2, 4)]:
        assert port.block_col_start(q, k, 6000, 1200) == \
            ref.block_col_start(q, k, 6000, 1200)
