"""SODDA-SVRG: the paper's optimizer generalised to deep networks.

Counterpart of ``repro.optim.sodda_optimizer``. The paper's three
stochastic components map onto deep-net training as:
  * D^t (observation sampling): the snapshot gradient mu is estimated on a
    d-fraction sub-batch (the caller takes it);
  * C^t (coordinate sampling): a c-fraction random coordinate mask is
    applied to mu, rescaled by 1 / c (a fresh mask each refresh);
  * pi_q (block assignment): an optional block-cyclic mask rotates which
    parameter block receives the variance-reduced update each step.

Update (the paper's step 16, over the parameter tree):
    params <- params - gamma * [ grad(params, mb) - grad(snap, mb) + mu ]

The caller supplies both gradients (``launch/train.py``); this module owns
the state machine (the refresh cadence, the masks). The masks and the block
draws are the port's own bits: each comes from a ``torch.Generator`` on the
leaf's device seeded from (key, step, leaf index) and the draw's kind
(``core.partition.seeded_generator``), where the reference folds its PRNG
key.
``refresh`` and ``update`` take the masks and blocks as optional arguments,
so a test can replay the reference's. The state is a dict of tensors and
Python ints; the updates are functional.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.partition import seeded_generator
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim.optimizers import tree_map

KEY = 17  # the reference's jax.random.PRNGKey(17)
_MASK, _BLOCK = 0, 1  # the draw's kind, in its generator's seed


@dataclasses.dataclass(frozen=True)
class SoddaSVRGConfig:
    lr: float = 0.01
    refresh_every: int = 50  # outer-iteration length (L in the paper)
    c_frac: float = 0.8  # coordinate fraction of the snapshot gradient
    d_frac: float = 0.85  # sub-batch fraction for the snapshot gradient
    block_cyclic: int = 0  # >0: rotate updates over this many param blocks


def make_sodda_svrg(cfg: SoddaSVRGConfig):
    def init(params):
        return {"snap": tree_map(torch.clone, params),
                "mu": tree_map(torch.zeros_like, params),
                "step": 0, "key": KEY}

    def needs_refresh(state):
        return state["step"] % cfg.refresh_every == 0

    def refresh(state, params, snap_grads, masks=None):
        """snap_grads: the gradient at `params` on the d-sampled sub-batch.
        `masks`: one boolean tensor a leaf in sorted key order (True keeps
        the coordinate), or None to draw them."""
        leaves = tree_leaves(snap_grads)
        if masks is None:
            masks = [torch.rand(g.shape, generator=seeded_generator(
                g.device, state["key"], state["step"], i, _MASK),
                device=g.device) < cfg.c_frac
                for i, g in enumerate(leaves)]
        mu = [torch.where(m.to(g.device), g / cfg.c_frac,
                          torch.zeros((), dtype=g.dtype, device=g.device))
              .to(g.dtype) for m, g in zip(masks, leaves)]
        return dict(state, snap=tree_map(torch.clone, params),
                    mu=tree_unflatten(snap_grads, mu))

    def update(params, state, grads_at_params, grads_at_snap, blocks=None):
        """`blocks`: with ``cfg.block_cyclic`` > 0, one int a leaf in sorted
        key order (the block that leaf updates this step), or None to draw
        them."""
        gamma = torch.tensor(cfg.lr, dtype=torch.float32)
        step = state["step"]
        f32 = torch.float32

        def one(i, p, g1, g0, mu):
            corr = g1.to(f32) - g0.to(f32) + mu.to(f32)
            if cfg.block_cyclic > 0:
                if blocks is None:  # a device tensor: no host sync
                    gen = seeded_generator(p.device, state["key"], step,
                                           i, _BLOCK)
                    blk = torch.randint(0, cfg.block_cyclic, (),
                                        generator=gen, device=p.device)
                else:
                    blk = int(blocks[i])
                idx = (torch.arange(corr.numel(), device=p.device)
                       * cfg.block_cyclic // corr.numel()).reshape(corr.shape)
                corr = torch.where(idx == blk, corr * cfg.block_cyclic,
                                   torch.zeros((), dtype=f32,
                                               device=p.device))
            return (p.to(f32) - gamma.to(p.device) * corr).to(p.dtype)

        new = [one(i, *args) for i, args in enumerate(zip(
            tree_leaves(params), tree_leaves(grads_at_params),
            tree_leaves(grads_at_snap), tree_leaves(state["mu"])))]
        return tree_unflatten(params, new), dict(state, step=step + 1)

    return {"init": init, "update": update, "refresh": refresh,
            "needs_refresh": needs_refresh, "cfg": cfg}
