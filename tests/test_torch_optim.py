"""The port's optimizers and SODDA-SVRG against the reference's, on the CPU.

Each optimizer takes the same numpy parameters and gradients in both
packages for 3 updates (a 2-D leaf, a 1-D leaf, a stacked (L, n, m)
leaf): the parameters and the state are held at STEP_TOL relative to each
leaf's largest entry (both compute in f32 in the same order; XLA may fuse
a product into a fused multiply-add, which moves the last bit). The state
shapes are the reference's, adafactor's factored moments included, and
``state_dtype`` is honoured. Then the reference's own convergence cases
(``tests/test_optim.py:28-104``) run on the port: every optimizer on the
quadratic, SODDA-SVRG against SGD on the noisy quadratic, the c-fraction
mask of the snapshot gradient. SODDA-SVRG's refresh cadence, its mu with
the reference's masks replayed, and its block-cyclic update with the
reference's blocks replayed are held BITWISE (g / c and the masked
update are the same f32 operations).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.models.params import tree_leaves
from repro_torch.optim import (OPTIMIZERS, Optimizer, SoddaSVRGConfig,
                               make_sodda_svrg)
from repro_torch.optim.sodda_optimizer import KEY

STEP_TOL = 1e-6


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.optim import OPTIMIZERS as JAX_OPTIMIZERS
    from repro.optim import SoddaSVRGConfig as JaxSvrgConfig
    from repro.optim import make_sodda_svrg as jax_make_sodda_svrg
    return types.SimpleNamespace(jax=jax, jnp=jnp, OPTIMIZERS=JAX_OPTIMIZERS,
                                 SvrgConfig=JaxSvrgConfig,
                                 make_sodda_svrg=jax_make_sodda_svrg)


def _tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"bias": rng.normal(size=(5,)).astype(np.float32),
                  "stack": rng.normal(size=(3, 4, 6)).astype(np.float32)}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol=STEP_TOL):
    got = [np.asarray(g.float() if isinstance(g, torch.Tensor) else g,
                      dtype=np.float32) for g in got]
    want = [np.asarray(w, dtype=np.float32) for w in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), \
            (np.abs(g - w).max(), np.abs(w).max())


KWARGS = {"sgd": [{}], "momentum": [{}, {"state_dtype": "bfloat16"}],
          "adamw": [{}, {"weight_decay": 0.1},
                    {"state_dtype": "bfloat16"}],
          "adafactor": [{}]}
CASES = [(name, kw) for name, kws in KWARGS.items() for kw in kws]


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}"
                              for n, k in CASES])
def test_each_optimizer_matches_reference(J, name, kwargs):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jkw = {k: (getattr(J.jnp, v) if k == "state_dtype" else v)
           for k, v in kwargs.items()}
    pkw = {k: (getattr(torch, v) if k == "state_dtype" else v)
           for k, v in kwargs.items()}
    lr = 0.05
    jopt, popt = J.OPTIMIZERS[name](lr, **jkw), OPTIMIZERS[name](lr, **pkw)
    assert isinstance(popt, Optimizer)
    jp = J.jax.tree.map(J.jnp.asarray, params)
    pp = _torch(params)
    js, ps = jopt.init(jp), popt.init(pp)
    jleaves, pleaves = J.jax.tree.leaves(js), tree_leaves(ps) if ps else []
    assert [tuple(x.shape) for x in pleaves] == [x.shape for x in jleaves]
    assert [str(x.dtype).replace("torch.", "") for x in pleaves] == \
        [str(x.dtype) for x in jleaves]
    for step, g in enumerate(grads):
        jp, js = jopt.update(J.jax.tree.map(J.jnp.asarray, g), js, jp,
                             J.jnp.int32(step))
        pp, ps = popt.update(_torch(g), ps, pp, step)
        _close(tree_leaves(pp), J.jax.tree.leaves(jp))
        if ps:
            _close(tree_leaves(ps), [np.asarray(x, np.float32)
                                     for x in J.jax.tree.leaves(js)],
                   tol=1e-2 if kwargs.get("state_dtype") else STEP_TOL)
    assert all(p.dtype == torch.float32 for p in tree_leaves(pp))


def test_adafactor_state_is_factored():
    """The reference's case, and a stacked (L, n, m) layer tensor: one row
    and column moment a layer."""
    opt = OPTIMIZERS["adafactor"](0.1)
    params = {"w": torch.zeros(64, 32), "b": torch.zeros(32),
              "layers": torch.zeros(3, 64, 32)}
    state = opt.init(params)
    assert state["w"]["r"].shape == (64,)
    assert state["w"]["c"].shape == (32,)
    assert state["b"]["v"].shape == (32,)
    assert state["layers"]["r"].shape == (3, 64)
    assert state["layers"]["c"].shape == (3, 32)


def test_learning_rate_may_be_a_schedule(J):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng)
    sched = lambda step: 0.1 / (1.0 + step)  # noqa: E731
    for step in range(3):
        want = J.OPTIMIZERS["sgd"](sched).update(
            J.jax.tree.map(J.jnp.asarray, grads), (),
            J.jax.tree.map(J.jnp.asarray, params), step)[0]
        got = OPTIMIZERS["sgd"](sched).update(_torch(grads), (),
                                              _torch(params), step)[0]
        _close(tree_leaves(got), J.jax.tree.leaves(want))


# ---------------------------------------------------------------------------
# The reference's convergence cases (tests/test_optim.py), on the port
# ---------------------------------------------------------------------------
def quad_problem(dim=16, n=128, seed=0, noise=0.0):
    """The reference's least-squares problem, with numpy draws."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.normal(size=(n, dim)) / np.sqrt(dim)).float()
    w_star = torch.from_numpy(rng.normal(size=dim)).float()
    y = A @ w_star
    if noise:
        y = y + noise * torch.from_numpy(rng.normal(size=n)).float()

    def loss(params, idx):
        return torch.mean((A[idx] @ params["w"] - y[idx]) ** 2)

    def grad(params, idx):
        w = params["w"].detach().requires_grad_()
        return {"w": torch.autograd.grad(loss({"w": w}, idx), w)[0]}

    return loss, grad


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_converge_on_quadratic(name):
    loss, grad = quad_problem()
    opt = OPTIMIZERS[name](0.3 if name in ("sgd", "momentum") else 0.1)
    params = {"w": torch.zeros(16)}
    state = opt.init(params)
    idx = torch.arange(128)
    for step in range(300):
        params, state = opt.update(grad(params, idx), state, params, step)
    assert float(loss(params, idx)) < 1e-2, name


def _svrg_vs_sgd_once(seed):
    loss, grad = quad_problem(dim=8, n=256, seed=seed, noise=0.3)
    gen = torch.Generator().manual_seed(seed + 100)
    draws = [torch.randint(0, 256, (4,), generator=gen) for _ in range(150)]
    lr = 0.25

    params = {"w": torch.zeros(8)}
    for idx in draws:
        params = {"w": params["w"] - lr * grad(params, idx)["w"]}
    sgd = float(loss(params, torch.arange(256)))

    svrg = make_sodda_svrg(SoddaSVRGConfig(lr=lr, refresh_every=25,
                                           c_frac=1.0, d_frac=1.0))
    params = {"w": torch.zeros(8)}
    state = svrg["init"](params)
    for step, idx in enumerate(draws):
        if step % 25 == 0:
            state = svrg["refresh"](state, params,
                                    grad(params, torch.arange(256)))
        params, state = svrg["update"](params, state, grad(params, idx),
                                       grad(state["snap"], idx))
    return float(loss(params, torch.arange(256))), sgd


def test_sodda_svrg_beats_sgd_on_noisy_quadratic():
    results = [_svrg_vs_sgd_once(seed) for seed in (1, 2, 3)]
    svrg = np.mean([r[0] for r in results])
    sgd = np.mean([r[1] for r in results])
    assert svrg < sgd, (svrg, sgd, results)


def test_sodda_svrg_stochastic_snapshot_masks():
    svrg = make_sodda_svrg(SoddaSVRGConfig(c_frac=0.5))
    params = {"w": torch.ones(1000)}
    state = svrg["refresh"](svrg["init"](params), params,
                            {"w": torch.ones(1000)})
    mu = state["mu"]["w"]
    assert 0.35 < float((mu != 0).float().mean()) < 0.65
    torch.testing.assert_close(mu[mu != 0], torch.full_like(mu[mu != 0], 2.0))
    # the draws are a function of (key, step, leaf): the same again
    again = svrg["refresh"](svrg["init"](params), params,
                            {"w": torch.ones(1000)})
    assert torch.equal(again["mu"]["w"], mu)


# ---------------------------------------------------------------------------
# SODDA-SVRG against the reference, its draws replayed
# ---------------------------------------------------------------------------
def _jax_key(J, step, leaf):
    key = J.jax.random.fold_in(J.jax.random.PRNGKey(KEY), step)
    return J.jax.random.fold_in(key, leaf)


def test_refresh_cadence_matches_reference(J):
    cfg = dict(refresh_every=4)
    jsv = J.make_sodda_svrg(J.SvrgConfig(**cfg))
    psv = make_sodda_svrg(SoddaSVRGConfig(**cfg))
    params = _tree(np.random.default_rng(2))
    js = jsv["init"](J.jax.tree.map(J.jnp.asarray, params))
    ps = psv["init"](_torch(params))
    zeros = J.jax.tree.map(np.zeros_like, params)
    for _ in range(9):
        assert bool(jsv["needs_refresh"](js)) == psv["needs_refresh"](ps)
        _, js = jsv["update"](js["snap"], js, zeros, zeros)
        _, ps = psv["update"](ps["snap"], ps, _torch(zeros), _torch(zeros))
    assert int(js["step"]) == ps["step"] == 9


def test_mu_with_the_references_masks_replayed(J):
    cfg = dict(c_frac=0.7)
    rng = np.random.default_rng(3)
    params, g = _tree(rng), _tree(rng)
    jsv = J.make_sodda_svrg(J.SvrgConfig(**cfg))
    psv = make_sodda_svrg(SoddaSVRGConfig(**cfg))
    js = jsv["init"](J.jax.tree.map(J.jnp.asarray, params))
    js = dict(js, step=J.jnp.int32(5))
    js = jsv["refresh"](js, J.jax.tree.map(J.jnp.asarray, params),
                        J.jax.tree.map(J.jnp.asarray, g))
    leaves = J.jax.tree.leaves(g)
    masks = [torch.from_numpy(np.array(J.jax.random.bernoulli(
        _jax_key(J, 5, i), cfg["c_frac"], x.shape)))
        for i, x in enumerate(leaves)]
    ps = dict(psv["init"](_torch(params)), step=5)
    ps = psv["refresh"](ps, _torch(params), _torch(g), masks=masks)
    for got, want in zip(tree_leaves(ps["mu"]), J.jax.tree.leaves(js["mu"])):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tree_leaves(ps["snap"]),
                         J.jax.tree.leaves(js["snap"])):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_block_cyclic_update_with_the_references_blocks_replayed(J):
    cfg = dict(lr=0.1, block_cyclic=3)
    rng = np.random.default_rng(4)
    params, g1, g0, mu = (_tree(rng) for _ in range(4))
    jsv = J.make_sodda_svrg(J.SvrgConfig(**cfg))
    psv = make_sodda_svrg(SoddaSVRGConfig(**cfg))
    jp = J.jax.tree.map(J.jnp.asarray, params)
    js = dict(jsv["init"](jp), mu=J.jax.tree.map(J.jnp.asarray, mu),
              step=J.jnp.int32(7))
    ps = dict(psv["init"](_torch(params)), mu=_torch(mu), step=7)
    want, js = jsv["update"](jp, js, J.jax.tree.map(J.jnp.asarray, g1),
                             J.jax.tree.map(J.jnp.asarray, g0))
    blocks = [int(J.jax.random.randint(_jax_key(J, 7, i), (), 0, 3))
              for i in range(len(J.jax.tree.leaves(params)))]
    got, ps = psv["update"](_torch(params), ps, _torch(g1), _torch(g0),
                            blocks=blocks)
    for a, b in zip(tree_leaves(got), J.jax.tree.leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert ps["step"] == int(js["step"]) == 8
    # the port's own block draws update one block of each leaf
    got, _ = psv["update"](_torch(params), dict(ps, step=7), _torch(g1),
                           _torch(g0))
    for a, p in zip(tree_leaves(got), tree_leaves(_torch(params))):
        moved = (a != p).flatten()
        idx = torch.arange(moved.numel()) * 3 // moved.numel()
        assert len(set(idx[moved].tolist())) == 1
