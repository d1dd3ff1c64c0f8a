"""The mesh's summation order, reproduced on one device (ROADMAP C1).

A gloo all-reduce does not add the ranks' tensors in rank order: its ring
sums each segment of the elements starting from another rank
(``testing.mesh_order.ring_sum``). With the hinge loss a last-bit difference
in z moves rows across the kink, so a mesh run parts from a single-device
run summed in any other order. ``snapshot_gradient_in_mesh_order`` is the
single-device plain version of the mesh's issue half in the mesh's order;
run through it, the single-device ``reference`` backend must give the
mesh's iterate bitwise. Here on 10 CPU ranks over gloo (P = 5, Q = 2;
n = 101 makes the ring's segments ragged), and on the card in
``chip_smoke.py`` at Table-1.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import driver, sodda
from repro_torch.data.synthetic import make_svm_data
from repro_torch.testing import multiprocess as mp
from repro_torch.testing.mesh_order import (ring_sum, snapshot_as,
                                            snapshot_gradient_in_mesh_order)
from repro_torch.testing.tolerances import (F32_REDUCTION,
                                            assert_objectives_close)

CFG = SoddaConfig(P=5, Q=2, n=101, m=30, L=8, lr0=0.05)  # hinge
SEED, ITERS = 3, 8


@pytest.fixture(scope="module")
def data():
    X, y, _ = make_svm_data(torch.Generator().manual_seed(0), CFG.N, CFG.M,
                            device="cpu")
    return X.numpy(), y.numpy()


@pytest.fixture(scope="module")
def mesh_run(data):
    runs = [dict(backend="shard_map", iters=ITERS, record_every=1,
                 seed=SEED)]
    launch = mp.launch_coordinated(
        mp.rank_runs, CFG.P * CFG.Q, (CFG, ("dense", *data), runs, "cpu"),
        backend="gloo", timeout=240)
    assert launch.exit_codes == {}
    return launch.results[0][0]


def _single(data, snapshot):
    X, y = (torch.from_numpy(a) for a in data)
    with snapshot_as(snapshot):
        return driver.run(SEED, (X, y), CFG, ITERS, "reference",
                          record_every=1, device="cpu")


@pytest.mark.parametrize("W", [1, 2, 3, 5])
def test_ring_sum_sums_each_segment_from_the_rank_before_it(W):
    """Segment s of 2 ceil(n / 2W) elements ends with rank s's term: where
    the other ranks hold +-1e8 and rank s holds 1, only that order gives 1
    (rank order gives 0 wherever rank s is not last)."""
    n = 4 * W - 1
    seg = 2 * -(-n // (2 * W))
    parts = torch.zeros(W, n)
    for e in range(n):
        s = e // seg
        others = [r for r in range(W) if r != s]
        parts[s, e] = 1.0
        for j, r in enumerate(others):
            parts[r, e] = 1e8 if j % 2 == 0 else -1e8
        if len(others) % 2:  # an odd count of big terms: cancel the last
            parts[others[-1], e] = 0.0
    got = ring_sum(list(parts))
    assert torch.equal(got, torch.ones(n))
    assert ring_sum([parts[0].view(1, n)]).shape == (1, n)
    if W > 2:  # two terms add alike in either order
        ascending = parts[0].clone()
        for r in range(1, W):
            ascending = ascending + parts[r]
        assert not torch.equal(ascending, got)


def test_snapshot_as_swaps_the_snapshot_gradient_inside_the_block_only():
    orig = sodda.snapshot_gradient

    def marker(*args):
        raise AssertionError("not called here")

    with pytest.raises(RuntimeError):
        with snapshot_as(marker):
            assert sodda.snapshot_gradient is marker
            raise RuntimeError
    assert sodda.snapshot_gradient is orig


def test_mesh_order_snapshot_is_the_snapshot_gradient(data):
    """The same function as sodda.snapshot_gradient, summed otherwise."""
    X, y = (torch.from_numpy(a) for a in data)
    b, c, d = sodda._counts(CFG)
    from repro_torch.core.partition import sample_iteration
    smp = sample_iteration(SEED, 1, CFG.P, CFG.Q, CFG.n, CFG.M, CFG.L, b, c,
                           d, "cpu")
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=CFG.M).astype(np.float32)) * 0.1
    args = (CFG.loss, X, y, w, smp, CFG.P * d)
    got = snapshot_gradient_in_mesh_order(CFG.n, CFG.m)(*args)
    torch.testing.assert_close(got, sodda.snapshot_gradient(*args),
                               rtol=1e-5, atol=1e-7)


def test_the_mesh_is_bitwise_the_single_device_run_in_mesh_order(data,
                                                                mesh_run):
    state, hist = _single(
        data, snapshot_gradient_in_mesh_order(CFG.n, CFG.m))
    np.testing.assert_array_equal(mesh_run["w"], state.w.numpy())
    plain, _ = _single(data, sodda.snapshot_gradient)  # summed in rank order
    assert not np.array_equal(mesh_run["w"], plain.w.numpy())
    assert [t for t, _ in hist] == [t for t, _ in mesh_run["history"]]
    for (t, f_ref), (_, f) in zip(hist, mesh_run["history"]):
        assert_objectives_close(f_ref, f, F32_REDUCTION, f"t={t}")
