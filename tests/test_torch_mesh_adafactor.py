"""Adafactor over a (data x model) mesh of ranks, with and without
ZeRO-1, on 4 spawned CPU ranks over gloo, against the port's one-device
update.

One spawn runs every rank job the tests read (``testing.multiprocess.
rank_lm``'s 'update' and 'collectives'), at reduced arctic-480b (16 q
heads of 16 over 2 kv heads): its dense leaves (split over 'model' or
replicated) and its expert leaves (split over both axes, in both MoE
layouts) take two updates from the same parameters and the same whole
gradients (as if summed over 'data').

Policies:

* each moment a rank holds has exactly the shape of its shard under
  ``shardings_for``'s state specs (ZeRO-1's, or the parameters' without
  it): under ZeRO-1 the expert leaf's row moment is split over 'data' on
  a dim its column moment leaves whole;
* the parameters and the moments gathered whole after each update within
  F32_REDUCTION (``w_rel`` x max(max |ref|, 1), per leaf) of the
  one-device update; a control that takes each moment's mean over a split
  dim on the rank's shard alone falls outside that rule;
* sgd, momentum and adamw under ZeRO-1 BITWISE an unsharded update;
* ``Mesh.reduce_scatter_cat`` and ``all_gather_cat`` of a non-contiguous
  view (the moved dims of a gathered expert weight's gradient) equal to
  the sum and the concatenation of the ranks' tensors.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding_rules import MOE_LAYOUTS
from repro_torch.launch import train as port_train
from repro_torch.models import Model
from repro_torch.models.params import from_numpy, tree_leaves
from repro_torch.optim import optimizers
from repro_torch.testing import multiprocess as mp
from repro_torch.testing.tolerances import F32_REDUCTION

UNPADDED = dict(num_heads=16, num_kv_heads=2, head_dim=16)
LR = 1e-2
BATCH = {"tokens": np.zeros((4, 16), np.int64)}  # the cell's shape only
CASES = [("gather", (2, 2), True), ("gather", (2, 2), False),
         ("token_tp", (2, 2), True), ("token_tp", (2, 2), False),
         ("gather", (4, 1), True), ("token_tp", (1, 4), True)]
ZERO1_OPTS = ("sgd", "momentum", "adamw")


def _cfg():
    return dataclasses.replace(reduced_config(get_config("arctic-480b")),
                               **UNPADDED)


def _job(layout, grid, zero1, grads, optimizer="adafactor", **kw):
    return dict(kind="update", grid=grid, layout=layout, grads=grads,
                batch_shape=BATCH, settings=dict(
                    optimizer=optimizer, lr=LR, zero1=zero1,
                    moe_layout=layout), **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    whole = optimizers.tree_map(lambda t: t.numpy(), model.init(3))
    rng = np.random.default_rng(5)
    grads = [optimizers.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), whole)
        for _ in range(2)]
    jobs = [_job(lay, grid, z, grads) for lay, grid, z in CASES]
    jobs.append(_job("gather", (2, 2), True, grads, local_means=True))
    jobs += [_job("gather", (2, 2), True, grads, optimizer=o)
             for o in ZERO1_OPTS]
    jobs += [dict(kind="collectives", grid=g) for g in ((2, 2), (4, 1))]
    launch = mp.launch_coordinated(mp.rank_lm, 4, (cfg, whole, jobs, "cpu"),
                                   backend="gloo", timeout=300)
    assert launch.exit_codes == {}, launch.errors
    return dict(cfg=cfg, whole=whole, grads=grads, jobs=jobs,
                ranks=launch.results)


def _results(setup, **match):
    for k, job in enumerate(setup["jobs"]):
        if all(job.get(f, job.get("settings", {}).get(f)) == v
               for f, v in match.items()):
            return [r[k] for r in setup["ranks"]]
    raise KeyError(match)


def _one_device(setup, optimizer):
    """The port's one-device update of the whole parameters from the
    whole gradients: (params, state) after each of the two updates."""
    opt = port_train.make_optimizer(port_train.TrainSettings(
        optimizer=optimizer, lr=LR))
    params = from_numpy(setup["whole"], device="cpu")
    state = opt.init(params)
    out = []
    for step, g in enumerate(setup["grads"]):
        with torch.no_grad():
            params, state = opt.update(from_numpy(g, device="cpu"), state,
                                       params, step)
        out.append((optimizers.tree_map(lambda t: t.numpy().copy(), params),
                    optimizers.tree_map(lambda t: t.numpy().copy(), state)))
    return out


def _misses(got, want):
    """Leaves (by index) outside F32_REDUCTION of the one-device ones."""
    return [i for i, (a, b) in enumerate(zip(tree_leaves(got),
                                             tree_leaves(want)))
            if np.abs(a - b).max() > F32_REDUCTION.w_rel * max(
                np.abs(b).max(), 1.0)]


def _state_specs(cfg, layout, grid, zero1):
    model = Model(cfg, device="cpu", mesh=dict(zip(("data", "model"), grid)),
                  rules_overrides=MOE_LAYOUTS[layout])
    settings = port_train.TrainSettings(optimizer="adafactor", zero1=zero1)
    return port_train.shardings_for(model, ShapeConfig(
        "t", "train", 16, 4), settings)[1]


@pytest.mark.parametrize("layout,grid,zero1", CASES)
def test_each_rank_holds_its_shard_of_the_moments(setup, layout, grid,
                                                  zero1):
    sizes = dict(zip(("data", "model"), grid))
    specs = _state_specs(setup["cfg"], layout, grid, zero1)
    want = _one_device(setup, "adafactor")[0][1]
    for r in _results(setup, layout=layout, grid=grid, zero1=zero1,
                      optimizer="adafactor", local_means=None):
        for held, spec, whole in zip(tree_leaves(r["held"]),
                                     tree_leaves(specs), tree_leaves(want)):
            shard = tuple(n // (sizes[a] if a else 1) for n, a in zip(
                whole.shape, list(spec) + [None] * whole.ndim))
            assert tuple(held) == shard, (spec, tuple(held), shard)
    wg = specs["layers"]["moe"]["wg"]
    if zero1 and grid == (2, 2):
        # the table of the reference's specs for the expert leaf
        assert (wg["r"], wg["c"]) == {
            "gather": (("data", "model", None), (None, "model", "data")),
            "token_tp": ((None, "data", None), (None, "data", "model")),
        }[layout]


@pytest.mark.parametrize("layout,grid,zero1", CASES)
def test_mesh_adafactor_is_the_one_device_update(setup, layout, grid,
                                                 zero1):
    want = _one_device(setup, "adafactor")
    res = _results(setup, layout=layout, grid=grid, zero1=zero1,
                   optimizer="adafactor", local_means=None)
    for r in res:
        for step, (wp, ws) in enumerate(want):
            assert not _misses(r["params"][step], wp), step
            assert not _misses(r["state"][step], ws), step


def test_local_means_control_misses(setup):
    want = _one_device(setup, "adafactor")
    got = _results(setup, local_means=True)[0]
    # the expert leaves' row moments (a mean over 'data'-split columns)
    assert _misses(got["state"][0], want[0][1])
    assert _misses(got["params"][1], want[1][0])


@pytest.mark.parametrize("optimizer", ZERO1_OPTS)
def test_zero1_of_the_elementwise_optimizers_stays_bitwise(setup,
                                                           optimizer):
    want = _one_device(setup, optimizer)
    for r in _results(setup, optimizer=optimizer):
        for step, (wp, ws) in enumerate(want):
            for a, b in zip(tree_leaves(r["params"][step]), tree_leaves(wp)):
                assert np.array_equal(a, b), step
            for a, b in zip(tree_leaves(r["state"][step]), tree_leaves(ws)):
                assert np.array_equal(a, b), step


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)])
def test_reduce_scatter_of_a_non_contiguous_view(setup, grid):
    res = _results(setup, kind="collectives", grid=grid)
    n, Q = grid
    base = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    views = [np.moveaxis(base * (rank + 1), 2, 0) for rank in range(4)]
    for rank, r in enumerate(res):
        p, q = divmod(rank, Q)
        group = [views[i * Q + q] for i in range(n)]
        want = sum(group).reshape(n, -1, 4, 6)[p]
        assert np.array_equal(r["scattered"], want)
        assert np.array_equal(r["gathered"], np.concatenate(group))
