"""Minimal optimizers over a parameter tree (a nested dict of tensors).

Counterpart of ``repro.optim.optimizers``, with its API:
``opt.init(params) -> state``; ``opt.update(grads, state, params, step) ->
(new_params, new_state)``. The learning rate is a float or a schedule
``f(step) -> float``. State dtypes are configurable. Each update computes
in float32 and casts back to the parameter's (or the state's) dtype, as the
reference does, with the same order of operations; XLA may fuse an update
into fused multiply-adds where PyTorch rounds each product, so the two
agree to f32 rounding, not bitwise.

Unlike the reference, ``update`` writes the new parameters and state into
the tensors it is given and returns those trees: a second tree does not
fit at the port's sizes (minitron-8b's 4 layers hold 12.3 GB of f32
weights, and adamw's parameters and moments written out of place would
take 7 x that at once; arctic-480b's layer holds 28.2 GB of bf16 weights,
as much again in gradients). The work goes a slice at a time
(``SLICE_ENTRIES``), so no temporary the size of a whole large leaf is
made: the elementwise updates (sgd, momentum, adamw) in flat chunks,
bitwise the whole-leaf formulas; adafactor a leaf of 3 or more dims in
blocks along its leading axes (``leading_blocks``), its moments r and c
bitwise the whole-leaf formula's on the CPU, the update clip's RMS summed
block by block (another order of the sum than the whole-leaf mean; one
block is the whole-leaf formula, bitwise).

ZeRO-1: ``zero1_pspecs`` is the reference's rule, a leaf's state split
over 'data' along its first unsplit dim that 'data' divides, on top of the
parameter's spec. ``zero1`` runs it over a mesh of ranks: a rank keeps
only its 'data' slice of each state leaf, updates its slice of the
parameter and all-gathers the parameter over 'data'. It runs sgd, momentum
and adamw; adafactor's factored moments over a mesh wait for ROADMAP A6b.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.distributed.sharding_rules import PartitionSpec, axis_sizes

Schedule = Union[float, Callable]
F32 = torch.float32
# the entries of a slice an update takes at once: 256 MB of f32 temporaries
SLICE_ENTRIES = 1 << 26


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params, step) ->
    (params, state)`` writes the new parameters and state into the
    tensors of `params` and `state` and returns those same trees: a caller
    that needs the old values keeps copies."""
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of the nested dicts (and plain tuples: sgd's
    state is the empty one) `tree`, each with the same-placed subtree of
    every tree in `rest` (a leaf's subtree there may itself be a dict, as
    adafactor's per-leaf state is). A tuple subclass, a partition spec,
    is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if type(tree) is tuple:
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _lr(lr: Schedule, step):
    """The step's learning rate as a float32 scalar tensor."""
    return torch.tensor(lr(step) if callable(lr) else lr, dtype=F32)


def _f32(t):
    return t.to(F32)


def flat_chunks(*ts):
    """Flat chunks of SLICE_ENTRIES entries of tensors of one shape, side
    by side: views of the first ones (written in place; they must be
    contiguous), a reshape of the last (a gradient, only read)."""
    flat = [t.view(-1) for t in ts[:-1]] + [ts[-1].reshape(-1)]
    n = flat[0].numel()
    return [[f[i:i + SLICE_ENTRIES] for f in flat]
            for i in range(0, n, SLICE_ENTRIES)]


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        g = _lr(lr, step)

        def one(p, gr):
            gd = g.to(p.device)
            for pc, gc in flat_chunks(p, gr):
                pc.copy_(_f32(pc) - gd * _f32(gc))
            return p

        return tree_map(one, params, grads), state

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9,
             state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                              device=p.device), params)

    def update(grads, state, params, step):
        g = _lr(lr, step)

        def one(p, m, gr):
            gd = g.to(p.device)
            for pc, mc, gc in flat_chunks(p, m, gr):
                mc.copy_(beta * _f32(mc) + _f32(gc))
                pc.copy_(_f32(pc) - gd * _f32(mc))
            return p

        return tree_map(one, params, state, grads), state

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

        def one(p, m, v, gr):
            dev = p.device
            gd, c1d, c2d = g.to(dev), c1.to(dev), c2.to(dev)
            for pc, mc, vc, gc in flat_chunks(p, m, v, gr):
                gc = _f32(gc)
                m2 = b1 * _f32(mc) + (1 - b1) * gc
                v2 = b2 * _f32(vc) + (1 - b2) * gc * gc
                step_ = gd * (m2 / c1d) / (torch.sqrt(v2 / c2d) + eps)
                if weight_decay:
                    step_ = step_ + gd * weight_decay * _f32(pc)
                pc.copy_(_f32(pc) - step_)
                mc.copy_(m2)
                vc.copy_(v2)
            return p

        return (tree_map(one, params, state["m"], state["v"], grads),
                state)

    return Optimizer(init, update)


def leading_blocks(p):
    """The blocks of a leaf of 2 or more dims along its leading axes:
    [(start, stop)] over the rows of ``p.view(-1, n, m)``, SLICE_ENTRIES
    entries a block (one row at least); a 2-dim leaf is one block."""
    n, m = p.shape[-2:]
    rows = p.numel() // (n * m)
    step = rows if p.dim() == 2 else max(1, SLICE_ENTRIES // (n * m))
    return [(i, min(i + step, rows)) for i in range(0, rows, step)]


def adafactor(lr: Schedule, decay: float = 0.8, eps: float = 1e-30,
              clip: float = 1.0) -> Optimizer:
    """Factored second moment: a row moment r and a column moment c for
    every leaf of 2 or more dims (over its last two; a stacked (L, n, m)
    layer tensor keeps one pair per layer), a full v for the others, and
    the update clipped to RMS <= `clip`. A leaf of 3 or more dims goes in
    blocks (``leading_blocks``): a first pass takes each block's r, c and
    the sum of its u^2, a second recomputes u from them and applies the
    update."""

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

        def scaled(gr, r, c):
            """u = gr / sqrt(denom + eps), the temporaries in place."""
            denom = (r[..., None] * c[..., None, :]).div_(torch.clamp_min(
                r.mean(-1, keepdim=True)[..., None], eps))
            return gr / denom.add_(eps).sqrt_()

        def apply(p, u, gd, ms):
            """p -= lr x u clipped to RMS <= clip (ms: u's mean square),
            in flat chunks."""
            scale = torch.clamp_min(torch.sqrt(ms + eps) / clip, 1.0)
            for pc, uc in flat_chunks(p, u):
                pc.copy_(_f32(pc) - gd * (uc / scale))

        def one(p, gr, st):
            dev = p.device
            b, gd = beta.to(dev), g.to(dev)
            if not _factored(p.shape):
                gr = _f32(gr)
                st["v"].copy_(b * st["v"] + (1 - b) * (gr * gr + eps))
                u = gr / torch.sqrt(st["v"] + eps)
                apply(p, u, gd, torch.mean(u * u))
                return p
            n, m = p.shape[-2:]
            pv, gv = p.view(-1, n, m), gr.reshape(-1, n, m)
            rv, cv = st["r"].view(-1, n), st["c"].view(-1, m)
            blocks = leading_blocks(p)
            sq = []
            for i, j in blocks:  # r, c and the sum of u^2, a block at a time
                gb = _f32(gv[i:j])
                g2 = gb * gb + eps
                rv[i:j] = b * rv[i:j] + (1 - b) * g2.mean(-1)
                cv[i:j] = b * cv[i:j] + (1 - b) * g2.mean(-2)
                del g2
                u = scaled(gb, rv[i:j], cv[i:j])
                if len(blocks) == 1:  # whole: the reference's mean
                    apply(pv, u, gd, torch.mean(u * u))
                    return p
                sq.append(torch.sum(u * u))
                del u, gb
            ms = sum(sq) / p.numel()
            for i, j in blocks:  # the update, u recomputed
                apply(pv[i:j], scaled(_f32(gv[i:j]), rv[i:j], cv[i:j]), gd,
                      ms)
            return p

        return tree_map(one, params, grads, state), state

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adamw": adamw,
              "adafactor": adafactor}


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer state split over the data axis on top of the param spec.
# ---------------------------------------------------------------------------
def zero1_pspecs(param_pspec, shape, mesh, axis: str = "data"):
    """`param_pspec` with `axis` added to the first dim of `shape` that is
    unsplit and divisible by it (unchanged if `axis` is in use, or no dim
    takes it)."""
    n = axis_sizes(mesh)[axis]
    specs = list(param_pspec) + [None] * (len(shape) - len(param_pspec))
    used = {a for s in specs if s is not None
            for a in (s if isinstance(s, tuple) else (s,))}
    if axis not in used:
        for i, (dim, s) in enumerate(zip(shape, specs)):
            if s is None and dim % n == 0 and dim >= n:
                specs[i] = axis
                break
    return PartitionSpec(*specs)


def zero1_dims(pspecs, axis: str = "data"):
    """Per leaf of a tree of ZeRO-1 state specs, the dim split over
    `axis` (None: the leaf's state is whole on every rank)."""
    return tree_map(lambda s: s.index(axis) if axis in s else None, pspecs)


def zero1(opt: Optimizer, mesh, dims) -> Optimizer:
    """`opt` with its state split over the 'data' axis of `mesh` (a
    ``core.distributed.Mesh``): `dims` says, per parameter leaf (a tree
    like the parameters), the dim its state is split along (``zero1_dims``
    of the state specs), or None. ``init(params)`` builds the state of
    this rank's slices only. ``update`` runs `opt` on this rank's slice of
    each parameter and gradient (the gradients already summed over
    'data'), then all-gathers the updated slices over 'data' into the
    parameter, in place. The slices are elementwise the whole-leaf
    update's, so the gathered parameters and state are bitwise an
    unsplit update's (sgd, momentum, adamw)."""
    n, p = mesh.size("data"), mesh.get_coordinate()[0]
    if n == 1:
        return opt

    def part(t, dim):
        if dim is None:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, p * size, size).contiguous()

    def init(params):
        return opt.init(tree_map(part, params, dims))

    def update(grads, state, params, step):
        slices = tree_map(part, params, dims)
        new, state = opt.update(tree_map(part, grads, dims), state, slices,
                                step)

        def gather(t, s, dim):
            if dim is not None:
                whole = mesh.all_gather_cat(s.movedim(dim, 0), "data",
                                            tag="zero1")
                t.copy_(whole.movedim(0, dim))
            return t

        return tree_map(gather, params, new, dims), state

    return Optimizer(init, update)
