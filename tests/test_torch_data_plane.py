"""The port's data planes and tile generators (``repro_torch.data``), and
``driver.run`` over them.

The port draws its own bits (torch generators, not ``jax.random``), so the
checks against the JAX package are on what both share: the registry, the
coercion and refusal rules, the analytic scale, and the generation scheme's
invariants. Within the port every plane of one seed must give bitwise the
same data and the same runs, as ``tests/test_data_plane.py`` and
``tests/test_conformance.py`` hold the reference's planes.
"""
import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.data import plane as ref_plane
from repro.data import synthetic as ref_synthetic
from repro.testing import small_fixture_config
from repro_torch.configs import sodda_svm as port_configs
from repro_torch.core import driver, engine, losses
from repro_torch.core.partition import seeded_generator
from repro_torch.data import synthetic
from repro_torch.data.plane import (NOT_PORTED, DataPlane, DenseDataPlane,
                                    StreamingDataPlane, TiledDataPlane,
                                    as_data_plane, available_planes,
                                    make_plane)


def _cfg(**kw):
    import dataclasses
    return port_configs.SoddaConfig(
        **dict(dataclasses.asdict(small_fixture_config()), **kw))


# ---------------------------------------------------------------------------
# Registry and coercion
# ---------------------------------------------------------------------------
def test_registry_exposes_dense_and_tiled():
    assert available_planes() == ("dense", "streaming", "tiled")
    assert DenseDataPlane.plane_name == "dense"
    assert TiledDataPlane.plane_name == "tiled"
    assert StreamingDataPlane.plane_name == "streaming"
    assert NOT_PORTED == ()
    assert set(available_planes()) == set(ref_plane.available_planes())


def test_make_plane_unknown_kind():
    with pytest.raises(ValueError, match="unknown data plane"):
        make_plane("sparse", 0, 8, 8, 2, 2, device="cpu")


def test_make_plane_names_planes_not_ported_yet():
    """The streaming plane, the last one the port lacked, is built by name
    now."""
    plane = make_plane("streaming", 0, 8, 8, 2, 2, device="cpu")
    assert isinstance(plane, StreamingDataPlane)
    assert plane.is_streaming and plane.epoch == 0


@pytest.mark.parametrize("kind,cls", [("dense", DenseDataPlane),
                                      ("tiled", TiledDataPlane)])
def test_make_plane_builds_each_kind(kind, cls):
    plane = make_plane(kind, 3, 12, 8, 3, 2, device="cpu")
    assert isinstance(plane, cls)
    assert (plane.N, plane.M, plane.P, plane.Q, plane.n, plane.m) == \
        (12, 8, 3, 2, 4, 4)
    assert plane.device == torch.device("cpu")


def test_as_data_plane_coercion():
    X, y = torch.zeros(6, 4), torch.ones(6)
    plane = as_data_plane((X, y))
    assert isinstance(plane, DenseDataPlane)
    assert (plane.N, plane.M, plane.P, plane.Q) == (6, 4, 1, 1)
    assert as_data_plane(plane) is plane
    assert as_data_plane([X, y]).materialize()[0] is X
    with pytest.raises(TypeError, match="DataPlane or an"):
        as_data_plane(X)
    with pytest.raises(ValueError, match=r"need X \(N, M\)"):
        as_data_plane((X, torch.ones(3)))
    with pytest.raises(ValueError, match="y is on meta"):
        as_data_plane((X, torch.ones(6, device="meta")))


def test_plane_grid_must_divide_shape():
    with pytest.raises(ValueError, match="must divide"):
        TiledDataPlane(0, 10, 8, 3, 2, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        DenseDataPlane(torch.zeros(10, 8), torch.zeros(10), grid=(2, 3))
    with pytest.raises(ValueError, match="must divide"):
        DenseDataPlane.from_seed(0, 10, 8, 2, 3, device="cpu")


def test_tile_index_bounds():
    plane = TiledDataPlane(0, 8, 8, 2, 2, device="cpu")
    with pytest.raises(IndexError):
        plane.x_tile(2, 0)
    with pytest.raises(IndexError):
        plane.y_block(-1)


def test_footprints():
    plane = TiledDataPlane(0, 12, 8, 3, 2, device="cpu")
    assert plane.dense_nbytes == 4 * (12 * 8 + 12)
    assert plane.tile_nbytes == 4 * 4 * 4
    table1 = port_configs.TABLE1_250K_18K
    big = TiledDataPlane(0, table1.N, table1.M, table1.P, table1.Q,
                         device="cpu")
    # a Table-1 tile is 1.2 GB, 1/15 of X: the one temporary beside X
    assert big.tile_nbytes == 1_200_000_000
    assert big.tile_nbytes / (big.dense_nbytes - 4 * table1.N) == 1 / 15


def test_placement_rules():
    plane = TiledDataPlane(1, 8, 6, 2, 3, device="cpu")
    assert plane.at_epoch(0) is plane
    with pytest.raises(ValueError, match="static"):
        plane.at_epoch(1)
    with pytest.raises(ValueError, match="take no mesh"):
        plane.materialize_for("reference", mesh=object())
    with pytest.raises(ValueError, match="but this run is on meta"):
        plane.materialize_for("reference", device="meta")
    X, y = plane.materialize_for("cuda", epoch=0)
    Xd, yd = plane.materialize_for("reference", device="cpu")
    assert torch.equal(X, Xd) and torch.equal(y, yd)


# ---------------------------------------------------------------------------
# dense <-> tiled parity and the generation scheme's invariants
# ---------------------------------------------------------------------------
def _assert_tiled_is_dense(seed, N, M, P, Q):
    tiled = TiledDataPlane(seed, N, M, P, Q, device="cpu")
    dense = DenseDataPlane.from_seed(seed, N, M, P, Q, device="cpu")
    Xd, yd = dense.materialize()
    assert Xd.is_contiguous() and tuple(Xd.shape) == (N, M)
    n, m = tiled.n, tiled.m
    for p in range(P):
        assert torch.equal(tiled.y_block(p), dense.y_block(p))
        assert torch.equal(tiled.y_block(p), yd[p * n:(p + 1) * n])
        for q in range(Q):
            tile = tiled.x_tile(p, q)
            assert torch.equal(tile, dense.x_tile(p, q))
            assert torch.equal(tile, Xd[p * n:(p + 1) * n, q * m:(q + 1) * m])
    Xt, yt = tiled.materialize()
    assert torch.equal(Xd, Xt) and torch.equal(yd, yt)


@pytest.mark.parametrize("N,M,P,Q", [(8, 6, 1, 1), (12, 8, 3, 2),
                                     (160, 32, 2, 2), (30, 9, 5, 3)])
def test_tiled_tiles_bitwise_equal_dense_slices(N, M, P, Q):
    _assert_tiled_is_dense(7, N, M, P, Q)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 4), st.integers(1, 4), st.integers(1, 12),
       st.integers(1, 8), st.integers(0, 2 ** 31 - 1))
def test_tiled_is_dense_over_arbitrary_grids(P, Q, n, m, seed):
    _assert_tiled_is_dense(seed, P * n, Q * m, P, Q)


def test_tile_generation_is_grid_local():
    """Tile (p, q) depends on (seed, p, q) and its own shape alone."""
    a = synthetic.svm_tile_x(3, 1, 2, 8, 4, device="cpu")
    b = TiledDataPlane(3, 16, 12, 2, 3, device="cpu").x_tile(1, 2)
    c = TiledDataPlane(3, 32, 16, 4, 4, device="cpu").x_tile(1, 2)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, synthetic.svm_tile_x(3, 2, 1, 8, 4,
                                                   device="cpu"))
    assert not torch.equal(a, synthetic.svm_tile_x(4, 1, 2, 8, 4,
                                                   device="cpu"))


def test_unit_variance_scale_is_the_references():
    assert synthetic.SVM_UNIT_VARIANCE_SCALE == \
        ref_synthetic.SVM_UNIT_VARIANCE_SCALE
    assert synthetic.SVM_UNIT_VARIANCE_SCALE.dtype == np.float32


def test_analytic_standardization():
    """Tiles are the raw U[-1, 1] draw times exactly sqrt(3) in f32; the
    column std of a large tile approaches 1, as the reference's does."""
    raw = synthetic.svm_tile_x(11, 0, 0, 4096, 8, standardize=False,
                               device="cpu")
    std = synthetic.svm_tile_x(11, 0, 0, 4096, 8, device="cpu")
    want = raw.numpy() * synthetic.SVM_UNIT_VARIANCE_SCALE
    assert want.dtype == np.float32
    np.testing.assert_array_equal(std.numpy(), want)
    assert float(raw.abs().max()) <= 1.0
    np.testing.assert_allclose(std.std(dim=0, correction=0).numpy(), 1.0,
                               atol=0.05)
    ref = ref_synthetic.svm_tile_x(jax.random.PRNGKey(11), 0, 0, 4096, 8)
    np.testing.assert_allclose(np.asarray(ref).std(axis=0), 1.0, atol=0.05)


def test_labels_come_from_raw_tiles_in_ascending_q():
    """y_block(p) = flip(sign(sum_q raw_tile(p, q) @ z_q)), accumulated in
    ascending q, with the flips of partition p's own stream."""
    seed, n, Q, m, p = 5, 64, 3, 8, 1
    zdot = torch.zeros(n)
    for q in range(Q):
        zdot = zdot + synthetic.svm_tile_x(seed, p, q, n, m,
                                           standardize=False, device="cpu") \
            @ synthetic.svm_feature_block_z(seed, q, m, device="cpu")
    sign = torch.where(torch.sign(zdot) == 0, 1.0, torch.sign(zdot))
    gen = seeded_generator("cpu", seed, synthetic._FLIP_STREAM, p)
    flips = torch.rand(n, generator=gen) < 0.01
    want = torch.where(flips, -sign, sign)
    assert torch.equal(synthetic.svm_label_block(seed, p, n, Q, m,
                                                 device="cpu"), want)


def test_labels_are_signs_with_the_flip_rate():
    N, M = 20_000, 16
    plane = TiledDataPlane(2, N, M, 4, 2, device="cpu")
    X, y = plane.materialize()
    assert set(y.unique().tolist()) <= {-1.0, 1.0}
    z = torch.cat([synthetic.svm_feature_block_z(2, q, 8, device="cpu")
                   for q in range(2)])
    flipped = float((torch.sign(X @ z) != y).float().mean())
    assert 0.005 < flipped < 0.015, flipped  # flip_prob = 0.01
    no_flips = TiledDataPlane(2, N, M, 4, 2, flip_prob=0.0, device="cpu")
    assert torch.equal(torch.sign(X @ z), no_flips.materialize()[1])


def test_tile_functions_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.svm_tile_x(0, 0, 0, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TiledDataPlane(0, 4, 4, 1, 1)


# ---------------------------------------------------------------------------
# driver.run over the planes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["reference", "cuda", "radisa-avg",
                                     "async"])
def test_driver_is_bitwise_across_planes_and_tuples(backend):
    assert backend in engine.available_backends()
    cfg = _cfg()
    tiled = make_plane("tiled", 4, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")
    dense = make_plane("dense", 4, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")
    X, y = dense.materialize()
    runs = [driver.run(6, data, cfg, 5, backend, record_every=2,
                       device="cpu")
            for data in (tiled, dense, (X, y), DenseDataPlane(X, y))]
    s0, h0 = runs[0]
    for s, h in runs[1:]:
        assert h == h0 and torch.equal(s.w, s0.w)
    assert h0[-1][1] < h0[0][1], h0


def test_driver_rejects_mismatched_plane():
    cfg = _cfg()
    plane = make_plane("tiled", 3, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")
    bigger = _cfg(n=cfg.n * 2)
    with pytest.raises(ValueError, match="do not match"):
        driver.run(0, plane, bigger, 1, device="cpu")


def test_driver_refuses_a_plane_on_another_device():
    cfg = _cfg()
    plane = make_plane("tiled", 3, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")
    with pytest.raises(ValueError, match="but this run is on meta"):
        driver.run(0, plane, cfg, 1, device="meta")


def test_engine_objective_and_run():
    cfg = _cfg(loss="logistic")
    plane = make_plane("tiled", 8, cfg.N, cfg.M, cfg.P, cfg.Q, device="cpu")
    X, y = plane.materialize()
    w = torch.linspace(-0.1, 0.1, cfg.M)
    closed = engine.make_objective(cfg, "async", data=plane, device="cpu")
    assert torch.equal(closed(w), losses.objective("logistic", X, y, w))
    assert torch.equal(engine.make_objective(cfg, "reference")(X, y, w),
                       closed(w))
    with pytest.raises(ValueError, match="takes no mesh"):
        engine.make_objective(cfg, "reference", mesh=object())
    with pytest.raises(ValueError, match="not ported yet"):
        engine.make_objective(cfg, "shard_map")
    with pytest.raises(ValueError, match="unknown backend"):
        engine.make_objective(cfg, "tpu")
    s1, h1 = engine.run(2, plane, cfg, 3, "radisa-avg", device="cpu")
    s2, h2 = driver.run(2, (X, y), cfg, 3, "radisa-avg", device="cpu")
    assert h1 == h2 and torch.equal(s1.w, s2.w)


def test_plane_is_an_abstract_base():
    with pytest.raises(TypeError):
        DataPlane()
