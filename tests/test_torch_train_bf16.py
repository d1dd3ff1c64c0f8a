"""The bf16-parameter train step, held to the reference's on the CPU
(ROADMAP C9, C10).

The MoE family trains on the card in bfloat16 parameters at the
reference's production settings: adafactor, bfloat16 gradients, each
update computed in float32 and rounded back to the parameters' dtype
(``optim.optimizers``: ``pc.copy_``; the reference: ``.astype(p.dtype)``,
``src/repro/optim/optimizers.py:133``). Here reduced arctic-480b and
kimi-k2 with bfloat16 parameters take 3 steps of the port's
``make_train_step`` beside the reference's ``make_train_step``. Each step
starts both packages from the same bf16 parameters and the same adafactor
state (the reference's, carried over as numpy), so that each comparison
is one update and no drift of earlier steps adds to it. The layout has 16
q heads of 16 over 2 kv heads, so that no head is padded and the
reference's padded-head fault (ROADMAP C5) cannot part the packages.

The anchor the roadmap set: wherever a parameter's float32 update agrees
between the packages to UPDATE_TOL x the reference's largest update of
the leaf, the new bf16 parameters lie within one bf16 ulp of each other.
It does not hold by construction where a new value lies far below the
leaf's largest update: there an agreement of UPDATE_TOL x that update
spans several ulps of the new value (ROADMAP C10, not a fault of the
port). So each step holds the two parts of a bf16 update apart, on the
reference's gradients of the step:

* the float32 update: the port's optimizer on float32 copies of the
  parameters lands within UPDATE_TOL x the leaf's largest update of the
  reference's optimizer on them, on every element (the rule of
  ``tests/test_torch_train_moe.py``);
* the rounding: the port's bf16 step is its float32 update rounded to
  bf16, bitwise.

The roadmap's rule is counted on that update and on the whole step, where
each package takes its own gradients (a few bf16 ulps apart: the bf16
forward rounds in another order), and the counts are printed.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import train as port_train
from repro_torch.models import Model
from repro_torch.models import params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.optim.optimizers import tree_map

ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]
UPDATE_TOL = 2e-3
STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = 3, 4, 16, 3e-3
UNPADDED = dict(num_heads=16, num_kv_heads=2, head_dim=16)


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.data import tokens as jax_tokens
    from repro.launch import train as jax_train
    from repro.models import Model as JaxModel
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Shape=JaxShape,
        tokens=jax_tokens, train=jax_train, Model=JaxModel)


def _f32(tree, J):
    """A tree of bf16 jax arrays as float32 numpy (exact)."""
    return J.jax.tree.map(lambda a: np.asarray(a.astype(J.jnp.float32)), tree)


def _ulp(x):
    """One bf16 ulp at each |x| (float32 numpy holding bf16 values): the
    spacing of the bf16 grid at x's binade, 2^-7 x 2^floor(log2|x|), and
    the smallest normal's at 0."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def bf16_misses(old, ref, port):
    """(elements covered, elements that miss) of one leaf: covered where
    the f32 updates (new - old) agree to UPDATE_TOL x the reference's
    largest update; a miss where a covered element's new parameters lie
    more than one bf16 ulp apart."""
    up_ref, up_port = ref - old, port - old
    agree = np.abs(up_port - up_ref) <= UPDATE_TOL * np.abs(up_ref).max()
    apart = np.abs(port - ref) > _ulp(ref)
    return int(agree.sum()), int((agree & apart).sum())


def test_ulp_is_the_bf16_spacing():
    """x + ulp(x) is the next bf16 value above a positive bf16 x: it is
    representable, and x + ulp/4 and x + 3 ulp/4 round to x and to it."""
    x = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    x = (x * 100 + 1e-3).bfloat16().float().numpy()
    u = _ulp(x)

    def rounded(a):
        return torch.from_numpy(a).bfloat16().float().numpy()

    assert np.array_equal(rounded(x + u), x + u)
    assert np.array_equal(rounded(x + u / 4), x)
    assert np.array_equal(rounded(x + 3 * u / 4), x + u)


def test_misses_count_covered_elements_only():
    """The leaf's largest update is 2, so updates agreeing to 0.004 are
    covered: element 0 is covered and 3 ulps off (a miss), element 1
    covered and 1 ulp off, element 2 not covered."""
    old = np.zeros(3, np.float32)
    ref = np.array([0.01, 0.01, 2.0], np.float32)
    port = ref + np.array([3, 1, 0], np.float32) * _ulp(ref)
    port[2] = 2.5
    assert bf16_misses(old, ref, port) == (2, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_matches_reference(J, arch):
    bf16 = J.jnp.bfloat16
    jcfg = dataclasses.replace(J.reduced_config(J.get_config(arch)),
                               **UNPADDED)
    jm = J.Model(jcfg, mesh=None, param_dtype=bf16)
    # the same bf16 parameters on both sides: drawn in f32, each side
    # rounding them to bf16 (round to nearest even in both)
    tree32 = J.jax.tree.map(
        np.asarray, jm.init(J.jax.random.PRNGKey(0), J.jnp.float32))
    pm = Model(dataclasses.replace(reduced_config(get_config(arch)),
                                   **UNPADDED),
               device="cpu", param_dtype=torch.bfloat16)
    settings = dict(optimizer="adafactor", lr=TRAIN_LR,
                    grad_dtype="bfloat16")
    jstep, jopt = J.train.make_train_step(
        jm, J.Shape("t", "train", TRAIN_S, TRAIN_B),
        J.train.TrainSettings(zero1=False, **settings))
    jstep = J.jax.jit(jstep)
    jgrad = J.jax.jit(J.jax.grad(lambda p, b: jm.loss(p, b)[0]))
    jupdate = J.jax.jit(jopt.update)
    pstep, popt = port_train.make_train_step(
        pm, ShapeConfig("t", "train", TRAIN_S, TRAIN_B),
        port_train.TrainSettings(**settings))
    jp = J.jax.tree.map(lambda a: J.jnp.asarray(a).astype(bf16), tree32)
    js = jopt.init(jp)
    covered = missed = update_covered = update_missed = 0
    f32_missed = rounding_missed = 0
    for step in range(STEPS):
        batch = J.tokens.synthetic_token_batch(0, step, TRAIN_B, TRAIN_S,
                                               pm.cfg.vocab_size)
        old = _f32(jp, J)

        def port_trees():
            """The reference's parameters and state of this step."""
            pp = port_params.from_numpy(old, device="cpu",
                                        dtype=torch.bfloat16)
            ps = port_params.from_numpy(J.jax.tree.map(np.asarray, js),
                                        device="cpu")
            return pp, ps

        # the update alone, on the reference's gradients: in f32, in
        # bf16, and the reference's own
        jg = jgrad(jp, batch)
        grads = port_params.from_numpy(_f32(jg, J), device="cpu",
                                       dtype=torch.bfloat16)
        ju, _ = jupdate(jg, js, jp, J.jnp.int32(step))
        jf, _ = jupdate(jg, js, J.jax.tree.map(J.jnp.asarray, old),
                        J.jnp.int32(step))
        with torch.no_grad():
            pp, ps = port_trees()
            pb, _ = popt.update(grads, ps, pp, step)
            pp, ps = port_trees()
            pf, _ = popt.update(grads, ps, tree_map(torch.Tensor.float, pp),
                                step)
        for o, r32, r, p32, p in zip(
                J.jax.tree.leaves(old), J.jax.tree.leaves(jf),
                J.jax.tree.leaves(_f32(ju, J)), tree_leaves(pf),
                tree_leaves(pb)):
            r32, p32 = np.asarray(r32), p32.numpy()
            bound = UPDATE_TOL * np.abs(r32 - o).max()
            f32_missed += int((np.abs(p32 - r32) > bound).sum())
            rounding_missed += int(not torch.equal(
                p, torch.from_numpy(p32).bfloat16()))
            c, m = bf16_misses(o, r, p.float().numpy())
            update_covered, update_missed = (update_covered + c,
                                             update_missed + m)
        # the whole step, each package on its own gradients
        pp, ps = port_trees()
        jp, js, jmet = jstep(jp, js, batch, J.jnp.int32(step))
        pp, ps, pmet = pstep(pp, ps, {k: torch.from_numpy(np.array(v)).long()
                                      for k, v in batch.items()}, step)
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(pp))
        for o, r, p in zip(J.jax.tree.leaves(old), J.jax.tree.leaves(
                _f32(jp, J)), tree_leaves(pp)):
            c, m = bf16_misses(o, r, p.float().numpy())
            covered, missed = covered + c, missed + m
    total = STEPS * sum(a.size for a in J.jax.tree.leaves(old))
    print(f"{arch}: bf16 parameters, {STEPS} steps of {total // STEPS} "
          f"elements. On the reference's gradients: {f32_missed} f32 "
          f"updates outside {UPDATE_TOL} x the leaf's largest, "
          f"{rounding_missed} leaves not their f32 update rounded; the "
          f"roadmap's rule: {update_covered} of {total} updates agree and "
          f"{update_missed} of them lie more than one bf16 ulp apart. On "
          f"each package's own gradients: {covered} of {total} agree and "
          f"{missed} lie more than one bf16 ulp apart")
    assert f32_missed == 0, (arch, f32_missed)
    assert rounding_missed == 0, (arch, rounding_missed)
