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
parameter's spec (on a mesh with a 'pod' axis over 'data' alone, as the
reference's: the state is replicated over 'pod', each pod updating the
same slices). ``zero1`` runs it over a mesh of ranks for sgd, momentum
and adamw: a rank keeps only its 'data' slice of each state leaf, updates
its slice of the parameter and all-gathers the parameter over 'data'.
``adafactor(mesh=, pspecs=)`` runs over a mesh of ranks on the rank's
parameter shards, computing the reference's whole-leaf formula: a mean
over a split dim is a sum all-reduced over its axis and divided by the
whole dim, and the clip's mean square is summed over every axis that
splits the leaf. A rank holds exactly its shard of r, c or v under the
state's specs (`state_pspecs`; with `zero1`, ZeRO-1's), which may split r
and c on other dims than each other's and than the slice of the parameter
it updates: the moments are small, so the rank gathers what its slice
needs, and keeps its own shard of the new ones.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.distributed.sharding_rules import (PartitionSpec,
                                                    axis_names, axis_sizes,
                                                    coordinate, split_size)

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


def _dim_axes(spec, ndim):
    """Per dim of a leaf of `ndim` dims, the mesh axis `spec` splits it
    over: a name, a tuple of two names or more (the dim split over their
    product, the first major), or None."""
    out = []
    for s in list(spec) + [None] * (ndim - len(spec)):
        names = axis_names(s)
        out.append(names[0] if len(names) == 1 else (names or None))
    return out


def _uses(split, axis):
    """Whether a leaf's per-dim axes `split` (``_dim_axes``) use `axis`."""
    return any(axis in axis_names(a) for a in split)


class _LeafLayout(NamedTuple):
    """How one parameter leaf and its adafactor state lie over a mesh, as
    one rank sees it. `split`: each dim's axis on the region the rank
    updates (the parameter's spec, plus 'data' on `pd`); `whole`: the
    leaf's whole shape; `pd`: the dim of the rank's ZeRO-1 slice of the
    parameter (None: the whole shard); `nat` and `held`: per state name,
    each dim's axis in the moment of the rank's parameter shard (the
    parameter's spec with the dim dropped), and in the shard the rank
    holds (the state's spec, which may split a dim that the parameter
    leaves whole, over 'data' for ZeRO-1 or over 'model' where the
    reference's rule gives a moment the spec of another leaf of its
    shape)."""
    split: list
    whole: tuple
    pd: object
    nat: dict
    held: dict


def _moment_dims(nd, pd):
    """The dims of r and of c that the parameter's dim `pd` becomes (None
    where the moment drops it)."""
    if pd is None:
        return {"r": None, "c": None}
    return {"r": pd if pd < nd - 1 else None,
            "c": pd if pd < nd - 2 else (pd - 1 if pd == nd - 1 else None)}


def _factored(shape):
    return len(shape) >= 2


def adafactor(lr: Schedule, decay: float = 0.8, eps: float = 1e-30,
              clip: float = 1.0, mesh=None, pspecs=None,
              state_pspecs=None, zero1: bool = False,
              local_means: bool = False) -> Optimizer:
    """Factored second moment: a row moment r and a column moment c for
    every leaf of 2 or more dims (over its last two; a stacked (L, n, m)
    layer tensor keeps one pair per layer), a full v for the others, and
    the update clipped to RMS <= `clip`. A leaf of 3 or more dims goes in
    blocks (``leading_blocks``): a first pass takes each block's r, c and
    the sum of its u^2, a second recomputes u from them and applies the
    update.

    Over a mesh of ranks (`mesh`, a ``core.distributed.Mesh``, with
    `pspecs` the parameters' specs) the parameters and gradients are the
    rank's shards (the gradients already summed over 'data'), and each
    mean over a split dim is a sum all-reduced over its axis ('adafactor';
    a dim split over ('pod', 'data') over that tuple's group) divided by
    the whole dim. The rank holds its shard of each moment
    under `state_pspecs` (``shardings_for``'s specs of this optimizer's
    state; the parameters' by default). With `zero1` (those specs then
    ZeRO-1's) the rank updates its 'data' slice of a leaf that 'data'
    leaves unsplit (the dim ``zero1_pspecs`` gives it) and all-gathers it
    ('zero1'). `local_means` is a control for checks only: the moments'
    means over a split dim taken over the rank's shard alone."""
    if mesh is not None:
        return _adafactor_mesh(lr, decay, eps, clip, mesh, pspecs,
                               state_pspecs, zero1, local_means)

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
        beta = _beta(decay, step)

        def one(p, gr, st):
            dev = p.device
            b, gd = beta.to(dev), g.to(dev)
            if not _factored(p.shape):
                gr = _f32(gr)
                st["v"].copy_(b * st["v"] + (1 - b) * (gr * gr + eps))
                u = gr / torch.sqrt(st["v"] + eps)
                _apply(p, u, gd, torch.mean(u * u), eps, clip)
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
                u = _scaled(gb, rv[i:j], cv[i:j], eps)
                if len(blocks) == 1:  # whole: the reference's mean
                    _apply(pv, u, gd, torch.mean(u * u), eps, clip)
                    return p
                sq.append(torch.sum(u * u))
                del u, gb
            ms = sum(sq) / p.numel()
            for i, j in blocks:  # the update, u recomputed
                _apply(pv[i:j], _scaled(_f32(gv[i:j]), rv[i:j], cv[i:j],
                                        eps), gd, ms, eps, clip)
            return p

        return tree_map(one, params, grads, state), state

    return Optimizer(init, update)


def _beta(decay, step):
    return 1.0 - (torch.tensor(int(step), dtype=F32) + 1.0) ** (-decay)


def _scaled(gr, r, c, eps, r_mean=None):
    """u = gr / sqrt(denom + eps), the temporaries in place; `r_mean`
    (r's mean over its last dim) computed here unless given."""
    if r_mean is None:
        r_mean = r.mean(-1, keepdim=True)
    denom = (r[..., None] * c[..., None, :]).div_(torch.clamp_min(
        r_mean[..., None], eps))
    return gr / denom.add_(eps).sqrt_()


def _apply(p, u, gd, ms, eps, clip):
    """p -= lr x u clipped to RMS <= clip (ms: u's mean square), in flat
    chunks."""
    scale = torch.clamp_min(torch.sqrt(ms + eps) / clip, 1.0)
    for pc, uc in flat_chunks(p, u):
        pc.copy_(_f32(pc) - gd * (uc / scale))


def _adafactor_mesh(lr, decay, eps, clip, mesh, pspecs, state_pspecs,
                    zero1, local_means):
    """``adafactor`` on a rank of `mesh` (see its docstring)."""
    n_data = mesh.size("data")

    def layout(p, spec, sspec):
        nd = p.dim()
        split = _dim_axes(spec, nd)
        whole = tuple(s * split_size(mesh, a)
                      for s, a in zip(p.shape, split))
        pd = None
        if zero1 and not _uses(split, "data") and n_data > 1:
            z = _dim_axes(zero1_pspecs(PartitionSpec(*split), whole, mesh),
                          nd)
            pd = z.index("data") if "data" in z else None
        nat = ({"r": split[:-1], "c": split[:-2] + split[-1:]}
               if _factored(p.shape) else {"v": split})
        held = {k: _dim_axes(sspec[k], len(v)) if sspec is not None else v
                for k, v in nat.items()}
        if pd is not None:
            split = split[:pd] + ["data"] + split[pd + 1:]
        return _LeafLayout(split, whole, pd, nat, held)

    def layouts(params):
        return tree_map(layout, params, pspecs, state_pspecs
                        if state_pspecs is not None else
                        tree_map(lambda s: None, pspecs))

    def own(t, dim, axis="data"):
        """The rank's block of `t` along `dim` over `axis` (a name, or a
        tuple of names, the first major)."""
        if dim is None:
            return t
        size = t.shape[dim] // split_size(mesh, axis)
        return t.narrow(dim, coordinate(mesh, axis) * size, size)

    def gather(t, dim, tag, axis="data"):
        if dim is None:
            return t
        return mesh.all_gather_cat(t.movedim(dim, 0).contiguous(), axis,
                                   tag=tag).movedim(0, dim)

    def relaid(t, have, want):
        """`t`, laid over the mesh as `have` (each dim's axis), laid as
        `want`: gathered where `want` leaves a dim whole, cut where it
        splits one."""
        for dim, (a, b) in enumerate(zip(have, want)):
            if a != b:
                t = own(gather(t, dim if a else None, "adafactor", a),
                        dim if b else None, b)
        return t

    def summed(t, axes):
        """`t` (a new tensor) all-reduced over each of `axes` that has
        more than one rank."""
        for ax in dict.fromkeys(a for a in axes if a is not None):
            if split_size(mesh, ax) > 1:
                mesh.all_reduce(t, ax, tag="adafactor")
        return t

    def init(params):
        def one(p, lay):
            full = ({"r": p.shape[:-1], "c": p.shape[:-2] + p.shape[-1:]}
                    if _factored(p.shape) else {"v": p.shape})
            return {k: relaid(torch.zeros(shape, dtype=F32,
                                          device=p.device), lay.nat[k],
                              lay.held[k]).clone()
                    for k, shape in full.items()}

        return tree_map(one, params, layouts(params))

    def update(grads, state, params, step):
        g = _lr(lr, step)
        beta = _beta(decay, step)

        def one(p, gr, st, lay):
            dev = p.device
            b, gd = beta.to(dev), g.to(dev)
            split, pd = lay.split, lay.pd
            region = own(p, pd).contiguous()
            grad = own(gr, pd)
            dims = ({"v": pd} if not _factored(p.shape)
                    else _moment_dims(p.dim(), pd))
            # each moment over the region, from the shard the rank holds
            # (itself where the two lie alike)
            region_axes = {k: [("data" if i == dims[k] else a)
                               for i, a in enumerate(lay.nat[k])]
                           for k in st}
            mom = {k: st[k] if lay.held[k] == region_axes[k] else
                   relaid(st[k], lay.held[k], region_axes[k]).clone()
                   for k in st}
            numel = 1
            for w in lay.whole:
                numel *= w
            if not _factored(p.shape):
                gf = _f32(grad)
                mom["v"].copy_(b * mom["v"] + (1 - b) * (gf * gf + eps))
                u = gf / torch.sqrt(mom["v"] + eps)
                ms = summed(torch.sum(u * u), split) / numel
                _apply(region, u, gd, ms, eps, clip)
            else:
                _factored_region(region, grad, mom, split, lay.whole, b, gd,
                                 numel)
            for k in st:  # the rank's shard of each new moment
                if lay.held[k] != region_axes[k]:
                    st[k].copy_(relaid(mom[k], region_axes[k],
                                       lay.held[k]))
            if pd is not None:
                p.copy_(gather(region, pd, "zero1"))
            elif region is not p:
                p.copy_(region)
            return p

        def _factored_region(pr, gr, mom, split, whole, b, gd, numel):
            n, m = pr.shape[-2:]
            ax_n, ax_m = split[-2], split[-1]
            N, M = whole[-2:]
            if local_means:  # the control: each mean over the shard alone
                ax_n = ax_m = None
                N, M = n, m
            pv, gv = pr.view(-1, n, m), gr.reshape(-1, n, m)
            rv, cv = mom["r"].view(-1, n), mom["c"].view(-1, m)
            blocks = leading_blocks(pr)

            def r_mean(r):
                return summed(r.sum(-1, keepdim=True), [ax_n]) / N

            sq = torch.zeros((), dtype=F32, device=pr.device)
            for i, j in blocks:  # r, c and the sum of u^2, a block at a time
                gb = _f32(gv[i:j])
                g2 = gb * gb + eps
                rv[i:j] = b * rv[i:j] + (1 - b) * (
                    summed(g2.sum(-1), [ax_m]) / M)
                cv[i:j] = b * cv[i:j] + (1 - b) * (
                    summed(g2.sum(-2), [ax_n]) / N)
                del g2
                u = _scaled(gb, rv[i:j], cv[i:j], eps, r_mean(rv[i:j]))
                sq = sq + torch.sum(u * u)
                del u, gb
            ms = summed(sq, split) / numel
            for i, j in blocks:  # the update, u recomputed
                _apply(pv[i:j], _scaled(_f32(gv[i:j]), rv[i:j], cv[i:j],
                                        eps, r_mean(rv[i:j])), gd, ms, eps,
                       clip)

        return (tree_map(one, params, grads, state, layouts(params)),
                state)

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


def zero1_dims(pspecs, param_pspecs=None, axis: str = "data"):
    """Per leaf of a tree of ZeRO-1 state specs, the dim split over
    `axis` (None: the leaf's state is whole on every rank). With
    `param_pspecs` (the parameters' specs, a tree like it) a dim the
    parameter's own spec splits over `axis` (an expert weight's) is not
    ZeRO-1's: that leaf's state is the rank's whole shard."""
    if param_pspecs is None:
        return tree_map(lambda s: s.index(axis) if axis in s else None,
                        pspecs)
    return tree_map(lambda s, ps: s.index(axis) if axis in s and not
                    _uses(_dim_axes(ps, len(s)), axis) else None, pspecs,
                    param_pspecs)


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
    n, p = mesh.size("data"), coordinate(mesh, "data")
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
