"""Minimal optimizers over a parameter tree (a nested dict of tensors).

Counterpart of ``repro.optim.optimizers``, with its API:
``opt.init(params) -> state``; ``opt.update(grads, state, params, step) ->
(new_params, new_state)``. The learning rate is a float or a schedule
``f(step) -> float``. State dtypes are configurable. Each update computes
in float32 and casts back to the parameter's (or the state's) dtype, as the
reference does, with the same order of operations; XLA may fuse an update
into fused multiply-adds where PyTorch rounds each product, so the two
agree to f32 rounding, not bitwise.

The updates are functional, as in the reference: they return new trees
and leave their arguments untouched (callers may drop the old tree; no
update is made in place, which at the port's sizes saves no memory that
matters). ZeRO-1's ``zero1_pspecs`` shards state over a mesh and waits for
the mesh work (ROADMAP A6).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

Schedule = Union[float, Callable]
F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of the nested dict `tree`, each with the
    same-keyed subtree of every tree in `rest` (a leaf's subtree there may
    itself be a dict, as adafactor's per-leaf state is)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _pick(out, i):
    """Item `i` of every per-leaf tuple of a `tree_map` result."""
    return tree_map(lambda o: o[i], out)


def _lr(lr: Schedule, step):
    """The step's learning rate as a float32 scalar tensor."""
    return torch.tensor(lr(step) if callable(lr) else lr, dtype=F32)


def _f32(t):
    return t.to(F32)


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        g = _lr(lr, step)
        new = tree_map(lambda p, gr: (_f32(p) - g.to(p.device) * _f32(gr))
                       .to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9,
             state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                              device=p.device), params)

    def update(grads, state, params, step):
        g = _lr(lr, step)
        new_m = tree_map(lambda m, gr: (beta * _f32(m) + _f32(gr))
                         .to(state_dtype), state, grads)
        new_p = tree_map(lambda p, m: (_f32(p) - g.to(p.device) * _f32(m))
                         .to(p.dtype), params, new_m)
        return new_p, new_m

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        g = _lr(lr, step)
        t = torch.tensor(int(step) + 1, dtype=F32)
        c1 = 1.0 - torch.tensor(b1, dtype=F32) ** t
        c2 = 1.0 - torch.tensor(b2, dtype=F32) ** t

        def upd(p, gr, m, v):
            dev = p.device
            gr = _f32(gr)
            m2 = b1 * _f32(m) + (1 - b1) * gr
            v2 = b2 * _f32(v) + (1 - b2) * gr * gr
            step_ = (g.to(dev) * (m2 / c1.to(dev))
                     / (torch.sqrt(v2 / c2.to(dev)) + eps))
            if weight_decay:
                step_ = step_ + g.to(dev) * weight_decay * _f32(p)
            return ((_f32(p) - step_).to(p.dtype), m2.to(state_dtype),
                    v2.to(state_dtype))

        out = tree_map(upd, params, grads, state["m"], state["v"])
        return (_pick(out, 0),
                {"m": _pick(out, 1), "v": _pick(out, 2)})

    return Optimizer(init, update)


def adafactor(lr: Schedule, decay: float = 0.8, eps: float = 1e-30,
              clip: float = 1.0) -> Optimizer:
    """Factored second moment: a row moment r and a column moment c for
    every leaf of 2 or more dims (over its last two; a stacked (L, n, m)
    layer tensor keeps one pair per layer), a full v for the others, and
    the update clipped to RMS <= `clip`."""

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def one(p):
            def z(shape):
                return torch.zeros(shape, dtype=F32, device=p.device)
            if _factored(p.shape):
                return {"r": z(p.shape[:-1]),
                        "c": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return tree_map(one, params)

    def update(grads, state, params, step):
        g = _lr(lr, step)
        beta = 1.0 - (torch.tensor(int(step), dtype=F32) + 1.0) ** (-decay)

        def one(p, gr, st):
            dev = p.device
            b = beta.to(dev)
            gr = _f32(gr)
            g2 = gr * gr + eps
            if _factored(p.shape):
                r = b * st["r"] + (1 - b) * g2.mean(-1)
                c = b * st["c"] + (1 - b) * g2.mean(-2)
                denom = (r[..., None] * c[..., None, :]) / torch.clamp_min(
                    r.mean(-1, keepdim=True)[..., None], eps)
                u = gr / torch.sqrt(denom + eps)
                new_st = {"r": r, "c": c}
            else:
                v = b * st["v"] + (1 - b) * g2
                u = gr / torch.sqrt(v + eps)
                new_st = {"v": v}
            # update clipping (RMS <= clip)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip, 1.0)
            return (_f32(p) - g.to(dev) * u).to(p.dtype), new_st

        # a leaf's state is a dict, handed whole to `one`
        out = tree_map(one, params, grads, state)
        return _pick(out, 0), _pick(out, 1)

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adamw": adamw,
              "adafactor": adafactor}
