"""Training the MoE family on the port, and the repairs that training at
full width needs, on the CPU.

``make_train_step`` is held to the reference's for reduced arctic-480b and
kimi-k2 (8 experts, top 2) with adamw and adafactor, ``accum_steps`` 1 and
2, ``grad_dtype`` float32 and bfloat16, 3 steps, as
``tests/test_torch_train.py`` holds mamba2: the loss and grad-norm metrics
to F32_REDUCTION, the parameters after each step to UPDATE_TOL x the
reference's largest update of the leaf at that step, and with bfloat16
gradients to (UPDATE_TOL + BF16_ULP) x it: the packages sum the f32
micro-batch gradients in other orders, so where a sum lies near a bf16
rounding boundary the two round it one bf16 ulp apart (BF16_ULP = 2^-7 of
the entry at most), and an update moves with its gradient. Both run at a
layout of 16 q heads (head_dim 16 over 2 kv heads), so that no head is
padded and the reference's padded-head fault cannot part the runs after
step 1.

The repairs:

* the reference's padded heads take part after a step: its zeroed wo rows
  take a gradient of the same size as the real rows'
  (``src/repro/models/attention.py:3-8`` says they take none; pinned here,
  ROADMAP C5); the port's padded heads are inert
  (``models.attention.inert_heads``): their wo rows stay exactly 0 through
  3 steps of adamw and of adafactor, and the masked forward is bitwise the
  unmasked one on the weights of ``init``;
* adafactor takes a leaf of 3 or more dims in blocks: r and c bitwise the
  whole-leaf formula's, the parameters within F32_REDUCTION of it (the
  clip's RMS is summed in another order), bitwise when one block holds the
  leaf;
* the grad norm sums a leaf in blocks (F32_REDUCTION; bitwise when one
  block holds it) and the micro-batches accumulate in place (bitwise the
  old out-of-place sum).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as port_train
from repro_torch.models import Model, attention, params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.optim import OPTIMIZERS
from repro_torch.optim import optimizers as port_optimizers
from repro_torch.optim.optimizers import tree_map
from repro_torch.testing.padded_heads import padded_rows, wo_leaves
from repro_torch.testing.tolerances import F32_REDUCTION

ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]
UPDATE_TOL = 2e-3
BF16_ULP = 2.0 ** -7
ADAMW_FLIPS = 1e-3
TRAIN_B, TRAIN_S, TRAIN_LR = 4, 16, 3e-3
# a reduced layout with nothing padded: 16 q heads of 16 over 2 kv heads
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


_PAIRS = {}


def _pair(J, arch, **layout):
    """(jax model, numpy tree, port model) of reduced `arch`, f32, built
    once a session for each (arch, layout)."""
    key = (arch, tuple(sorted(layout.items())))
    if key not in _PAIRS:
        jm = J.Model(dataclasses.replace(
            J.reduced_config(J.get_config(arch)), **layout), mesh=None,
            param_dtype=J.jnp.float32)
        tree = J.jax.tree.map(np.asarray, jm.init(J.jax.random.PRNGKey(0)))
        pm = Model(dataclasses.replace(reduced_config(get_config(arch)),
                                       **layout),
                   device="cpu", param_dtype=torch.float32)
        _PAIRS[key] = (jm, tree, pm)
    return _PAIRS[key]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long()
            for k, v in batch.items()}


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(J, arch, name, accum, grad_dtype):
    jm, tree, pm = _pair(J, arch, **UNPADDED)
    assert attention.padded_heads(pm.cfg) == pm.cfg.num_heads
    jstep, jopt = J.train.make_train_step(
        jm, J.Shape("t", "train", TRAIN_S, TRAIN_B),
        J.train.TrainSettings(optimizer=name, lr=TRAIN_LR, accum_steps=accum,
                              grad_dtype=grad_dtype, zero1=False))
    jstep = J.jax.jit(jstep)
    jp = J.jax.tree.map(J.jnp.asarray, tree)
    js = jopt.init(jp)
    pstep, popt = port_train.make_train_step(
        pm, ShapeConfig("t", "train", TRAIN_S, TRAIN_B),
        port_train.TrainSettings(optimizer=name, lr=TRAIN_LR,
                                 accum_steps=accum, grad_dtype=grad_dtype))
    pp = port_params.from_numpy(tree, device="cpu")
    ps = popt.init(pp)
    for step in range(3):
        batch = J.tokens.synthetic_token_batch(0, step, TRAIN_B, TRAIN_S,
                                               pm.cfg.vocab_size)
        jp2, js, jmet = jstep(jp, js, batch, J.jnp.int32(step))
        pp, ps, pmet = pstep(pp, ps, _torch_batch(batch), step)
        for key in ("loss", "ce", "grad_norm"):
            w = float(jmet[key])
            assert abs(float(pmet[key]) - w) <= F32_REDUCTION.obj_rel * w, \
                (step, key)
        for j0, j1, p1 in zip(J.jax.tree.leaves(jp), J.jax.tree.leaves(jp2),
                              tree_leaves(pp)):
            j0, j1, p1 = np.asarray(j0), np.asarray(j1), p1.numpy()
            bound = (UPDATE_TOL + (BF16_ULP if grad_dtype == "bfloat16"
                                   else 0.0)) * np.abs(j1 - j0).max()
            missed = float((np.abs(p1 - j1) > bound).mean())
            assert missed <= (ADAMW_FLIPS if name == "adamw" else 0.0), \
                (name, step, j1.shape, missed)
        jp = jp2


# ---------------------------------------------------------------------------
# the padded heads
# ---------------------------------------------------------------------------
def _padded_wo(cfg, tree, leaves):
    """[each wo leaf's padded-head rows] of `leaves` (torch or numpy)."""
    rows = padded_rows(cfg)
    return [np.asarray(leaves[i])[..., rows, :, :] for i in wo_leaves(tree)]


def test_reference_padded_wo_rows_take_a_gradient(J):
    """The reference's fault: on reduced arctic (4 q heads padded to 16,
    12 padded) the zeroed wo rows take a gradient as large as the real
    rows', so its first step makes the padded heads part of the model."""
    jm, tree, pm = _pair(J, "arctic-480b")
    cfg = pm.cfg
    assert attention.padded_heads(cfg) == 16 and cfg.num_heads == 4
    batch = J.tokens.synthetic_token_batch(0, 0, 2, 16, cfg.vocab_size)
    _, grads = J.jax.value_and_grad(lambda p: jm.loss(p, batch),
                                    has_aux=True)(
        J.jax.tree.map(J.jnp.asarray, tree))
    want = [np.asarray(g) for g in J.jax.tree.leaves(grads)]
    assert all(float(np.abs(w).max()) == 0.0 for w in
               _padded_wo(cfg, tree, J.jax.tree.leaves(tree)))
    padded = max(float(np.abs(w).max()) for w in _padded_wo(cfg, tree, want))
    real = max(float(np.abs(want[i][..., ~padded_rows(cfg), :, :]).max())
               for i in wo_leaves(tree))
    assert padded > 0.1 * real, (padded, real)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_padded_wo_rows_stay_zero_through_training(name):
    cfg = reduced_config(get_config("arctic-480b"))
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    step_fn, opt = port_train.make_train_step(
        model, ShapeConfig("t", "train", 16, 2),
        port_train.TrainSettings(optimizer=name, lr=1e-2))
    params = model.init(0)
    state = opt.init(params)
    pipe = TokenPipeline(seed=0, batch=2, seq_len=16,
                         vocab_size=cfg.vocab_size, device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    for step in range(3):
        params, state, metrics = step_fn(params, state, pipe.next(), step)
        leaves = tree_leaves(params)
        assert all(float(np.abs(w).max()) == 0.0
                   for w in _padded_wo(cfg, params, leaves)), step
    # the real rows moved
    for i in wo_leaves(params):
        real = ~torch.from_numpy(padded_rows(cfg))
        assert not torch.equal(leaves[i][..., real, :, :],
                               before[i][..., real, :, :])


@pytest.mark.parametrize("arch", ["arctic-480b", "gemma2-9b"])
def test_masked_forward_is_bitwise_the_unmasked_one(arch, monkeypatch):
    """On the weights of init (padded wo rows zero) the mask changes no
    bit of the prefill logits, a decode step, the loss, or any gradient
    but the padded wo rows', which it takes from nonzero to 0."""
    cfg = reduced_config(get_config(arch))
    assert attention.padded_heads(cfg) > cfg.num_heads
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    params = model.init(3)
    batch = TokenPipeline(seed=1, batch=2, seq_len=16,
                          vocab_size=cfg.vocab_size, device="cpu").next()
    wo = wo_leaves(params)
    rows = torch.from_numpy(padded_rows(cfg))

    def run():
        logits, cache = model.prefill(params, batch)
        step, _ = model.decode(params, cache,
                               batch["tokens"][:, :1],
                               torch.full((2,), 15, dtype=torch.long))
        loss, _, grads = port_train.loss_and_grads(model, params, batch)
        grads = tree_leaves(grads)
        padded = [grads[i][..., rows, :, :].clone() for i in wo]
        for i in wo:
            grads[i][..., rows, :, :] = 0
        return [logits, step, loss, *grads], padded

    masked, zero = run()
    monkeypatch.setattr(attention, "inert_heads", lambda out, cfg: out)
    unmasked, nonzero = run()
    assert all(torch.equal(a, b) for a, b in zip(masked, unmasked))
    assert all(bool((z == 0).all()) for z in zero)
    assert all(bool((n != 0).any()) for n in nonzero)


# ---------------------------------------------------------------------------
# adafactor, the grad norm and the accumulation
# ---------------------------------------------------------------------------
def _adafactor_whole_leaf(p, gr, st, lr, step, decay=0.8, eps=1e-30,
                          clip=1.0):
    """The whole-leaf formula (the reference's, as the port computed it
    before it took a leaf in blocks): (new p, r, c)."""
    f32 = torch.float32
    beta = 1.0 - (torch.tensor(int(step), dtype=f32) + 1.0) ** (-decay)
    gr = gr.to(f32)
    g2 = gr * gr + eps
    r = beta * st["r"] + (1 - beta) * g2.mean(-1)
    c = beta * st["c"] + (1 - beta) * g2.mean(-2)
    denom = (r[..., None] * c[..., None, :]) / torch.clamp_min(
        r.mean(-1, keepdim=True)[..., None], eps)
    u = gr / torch.sqrt(denom + eps)
    rms = torch.sqrt(torch.mean(u * u) + eps)
    u = u / torch.clamp_min(rms / clip, 1.0)
    return (p.to(f32) - torch.tensor(lr, dtype=f32) * u).to(p.dtype), r, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [1, 4])
def test_adafactor_in_blocks_matches_the_whole_leaf_formula(
        dtype, blocks, monkeypatch):
    """A (4, 64, 48) leaf, 3 steps, in 4 blocks of one layer each or in
    one: r and c bitwise the whole-leaf formula's every step; the
    parameters bitwise in one block, within F32_REDUCTION of the step's
    largest update in four (the clip's RMS summed block by block)."""
    shape = (4, 64, 48)
    monkeypatch.setattr(port_optimizers, "SLICE_ENTRIES",
                        shape[1] * shape[2] * (4 // blocks))
    assert len(port_optimizers.leading_blocks(torch.empty(shape))) == blocks
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(shape, generator=gen).to(dtype)
    opt = OPTIMIZERS["adafactor"](0.05)
    params = {"w": p0.clone()}
    state = opt.init(params)
    want_p = p0.clone()
    want_st = {"r": state["w"]["r"].clone(), "c": state["w"]["c"].clone()}
    for step in range(3):
        gr = torch.randn(shape, generator=gen).to(dtype)
        params, state = opt.update({"w": gr}, state, params, step)
        new_p, r, c = _adafactor_whole_leaf(want_p, gr, want_st, 0.05, step)
        assert torch.equal(state["w"]["r"], r) and \
            torch.equal(state["w"]["c"], c), step
        got = params["w"]
        if blocks == 1:
            assert torch.equal(got, new_p), step
        else:
            update = float((new_p.float() - want_p.float()).abs().max())
            gap = float((got.float() - new_p.float()).abs().max())
            # bf16: the RMS's order may move a parameter across a rounding
            # boundary: one bf16 ulp of it at most
            ulp = (float(new_p.float().abs().max()) * 2.0 ** -7
                   if dtype == torch.bfloat16 else 0.0)
            assert gap <= max(F32_REDUCTION.w_rel * update, ulp), \
                (step, gap, update)
        want_p, want_st = new_p, {"r": r, "c": c}


@pytest.mark.parametrize("blocks", [1, 3])
def test_grad_norm_in_blocks(blocks, monkeypatch):
    """square_sum: bitwise the whole-leaf sum when the leaf is one chunk
    of SLICE_ENTRIES entries, within F32_REDUCTION of it in more."""
    shape = (3, 40, 24)
    monkeypatch.setattr(port_optimizers, "SLICE_ENTRIES",
                        shape[1] * shape[2] * (3 // blocks))
    gen = torch.Generator().manual_seed(1)
    for g in (torch.randn(shape, generator=gen),
              torch.randn(shape, generator=gen).bfloat16(),
              torch.randn(50, 30, generator=gen)):
        want = torch.sum(torch.square(g.float()))
        got = port_train.square_sum(g)
        if g.numel() <= port_optimizers.SLICE_ENTRIES:
            assert torch.equal(got, want)
        else:
            assert abs(float(got - want)) <= \
                F32_REDUCTION.obj_rel * float(want)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_accumulation_in_place_is_bitwise_the_out_of_place_sum(grad_dtype):
    """accum_steps 2 on reduced arctic: the step's parameters (sgd, which
    reads the gradients alone) and its grad norm bitwise those of the old
    form, 0 + g1 + g2 in grad_dtype out of place, divided by 2."""
    cfg = reduced_config(get_config("arctic-480b"))
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    settings = port_train.TrainSettings(optimizer="sgd", lr=0.1,
                                        accum_steps=2, grad_dtype=grad_dtype)
    step_fn, opt = port_train.make_train_step(
        model, ShapeConfig("t", "train", 16, 4), settings)
    batch = TokenPipeline(seed=2, batch=4, seq_len=16,
                          vocab_size=cfg.vocab_size, device="cpu").next()
    params = model.init(0)
    gdt = getattr(torch, grad_dtype)
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt), params)
    for i in range(2):
        mb = {k: v.reshape(2, 2, *v.shape[1:])[i] for k, v in batch.items()}
        g = port_train.loss_and_grads(model, params, mb)[2]
        gsum = tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
    grads = tree_map(lambda g: g / 2, gsum)
    want_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
    want, _ = opt.update(grads, (), tree_map(torch.clone, params), 0)
    got, _, metrics = step_fn(params, (), batch, 0)
    assert torch.equal(metrics["grad_norm"], want_norm)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))


def test_updates_write_into_the_given_trees():
    """Every optimizer returns the tensors it was given, updated: no second
    tree of parameters or state is made."""
    gen = torch.Generator().manual_seed(4)
    for name in OPTIMIZERS:
        opt = OPTIMIZERS[name](0.1)
        params = {"a": torch.randn(3, 5, 4, generator=gen),
                  "b": torch.randn(6, generator=gen)}
        state = opt.init(params)
        ids = [id(t) for t in tree_leaves(params) + tree_leaves(state)]
        new_p, new_s = opt.update(
            tree_map(lambda p: torch.randn(p.shape, generator=gen), params),
            state, params, 0)
        assert [id(t) for t in tree_leaves(new_p) + tree_leaves(new_s)] == \
            ids, name

