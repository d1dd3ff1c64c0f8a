"""Tensor parallelism over the 'model' axis of a mesh of ranks, and the
carrying of trees onto a mesh and back.

The port's own module: the reference has no counterpart file, because
GSPMD writes these collectives into its programs from the partition specs
(``distributed.sharding_rules``). Here each rank holds exactly the shard
of every leaf that its spec gives it (``shard_params``), and the dense
layers run on those shards with the two conjugate collectives of Megatron
tensor parallelism:

* ``copy``: identity forward, all-reduce backward. A layer's replicated
  input goes through it before the rank's column-split weights, so its
  gradient is summed over the ranks' partial ones;
* ``reduce``: all-reduce forward, identity backward. A row-split
  product's partial sum goes through it, so every rank holds the whole.

The MoE layouts (``sharding_rules.MOE_LAYOUTS``) add the conjugate pair
of the 'data' axis:

* ``gather_data``: all-gather forward, reduce-scatter backward. The
  tokens of every data rank (each rank then takes the rows its expert
  slots hold), the router's probabilities (the route is the global
  batch's), and in the 'gather' layout the experts' FFN hidden, stored
  split over 'data' and gathered for each layer's products;
* ``scatter_data``: reduce-scatter forward, all-gather backward. The
  expert outputs each rank combined for every token of the global batch,
  summed over 'data' into each rank's rows.

The SSM family's layouts (``sharding_rules.rules_for`` puts its heads over
'model' when they divide it, ``batch_axes`` its rows over 'model' too when
the batch divides both axes) add three more pieces:

* ``norm_sum``: all-reduce forward and backward. The gated norm's sum of
  squares over the inner channels a rank holds a share of: the whole sum
  feeds each rank's own channels, so its gradient is partial on every
  rank;
* ``bc_weight``: the replicated B/C projections and their convolutions,
  whose gradient each rank takes from its own heads only (``kv_weight``'s
  rule);
* ``gather_model``: all-gather over 'model' forward, reduce-scatter
  backward, the pair ``gather_data`` is on 'data': a leaf split over
  'model' gathered whole when the rank's rows lie over 'model' (its own
  rows on every head), its gradient each rank's chunk of the sum.

On a mesh with a 'pod' axis (the reference's multi-pod layout) the batch
lies over ('pod', 'data') (``sharding_rules.data_axes``): the 'data'
pair above runs over the axes the rows lie over, a tuple of them taken as
one axis (``core.distributed.Mesh``'s tuple groups, the first name
major), and a dim split over two axes (the MoE FFN's hidden over ('pod',
'data')) is cut and joined in the tuple's order (``shard``, ``gather``).

Each is a ``torch.autograd.Function`` over ``core.distributed.Mesh``'s
collectives, which count their payload under a tag in ``Mesh.payload``
(and their calls in ``Mesh.calls``). :class:`TensorParallel` is a rank's
place on the two axes, what the rules split there, and the collectives the
layers call. Every collective goes through the mesh's process group: on
ranks that share one card that is gloo, through host memory.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding_rules import (axis_names, coordinate,
                                                    data_axes, padded_heads,
                                                    rules_for, split_size)

AXIS = "model"
DATA = "data"
# the deliberately broken pieces a check may turn on to show that its rule
# catches them: the input collective's backward all-reduce dropped; the
# partial gradient of replicated kv weights left unsummed; in the 'gather'
# MoE layout the gathered expert weights' gradient not reduce-scattered
# (each rank keeps its own slice of its own); the 'model' all-reduce of
# the expert outputs' partial sums dropped; each data rank routing only
# its own rows with its own capacity; the SSM's gated norm without its
# backward all-reduce; the replicated B/C weights' partial gradients left
# unsummed; a leaf gathered over 'model' keeping its own slice of its own
# gradient, not the reduce-scatter; and on a mesh with a 'pod' axis the
# gradients' reduction over 'pod' dropped (each pod keeping its own)
CONTROLS = ("input_grad", "kv_grad", "weight_grad", "expert_sum",
            "local_route", "norm_grad", "bc_grad", "scatter_grad",
            "pod_grad")


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over `axis`."""

    @staticmethod
    def forward(ctx, x, tp, tag, axis):
        ctx.tp, ctx.tag, ctx.axis = tp, tag, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.tp.mesh.all_reduce(grad, ctx.axis, tag=ctx.tag)
        return grad, None, None, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward over `axis`; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, tp, tag, axis):
        out = x.contiguous().clone()
        tp.mesh.all_reduce(out, axis, tag=tag)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _NormSum(torch.autograd.Function):
    """All-reduce over the axis forward and backward: a sum that feeds
    each rank's own work, so that its gradient is partial on every rank
    (under the 'norm_grad' control the backward is left as it is)."""

    @staticmethod
    def forward(ctx, x, tp, tag):
        ctx.tp, ctx.tag = tp, tag
        out = x.contiguous().clone()
        tp.mesh.all_reduce(out, AXIS, tag=tag)
        return out

    @staticmethod
    def backward(ctx, grad):
        if "norm_grad" in ctx.tp.controls:
            return grad, None, None
        grad = grad.contiguous().clone()
        ctx.tp.mesh.all_reduce(grad, AXIS, tag=ctx.tag)
        return grad, None, None


def _reduce_scatter(mesh, t, tag, axis):
    """The sum over `axis` of the ranks' `t`, cut along dim 0 into
    ``size(axis)`` chunks: this rank's chunk."""
    n = split_size(mesh, axis)
    return mesh.reduce_scatter_cat(t, axis, tag=tag) if n > 1 else t


class _Gather(torch.autograd.Function):
    """All-gather over `axis` along `dim` forward; the gradient
    reduce-scattered back (each rank's chunk of the sum over the axis),
    or with `keep_own` (a control) the rank's own chunk of its own."""

    @staticmethod
    def forward(ctx, x, tp, axis, dim, tag, keep_own):
        ctx.tp, ctx.axis, ctx.dim, ctx.tag = tp, axis, dim, tag
        ctx.keep_own = keep_own
        whole = tp.mesh.all_gather_cat(x.movedim(dim, 0), axis, tag=tag)
        return whole.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        tp, dim, axis = ctx.tp, ctx.dim, ctx.axis
        g = grad.movedim(dim, 0)
        if ctx.keep_own:
            k = coordinate(tp.mesh, axis)
            out = g.chunk(split_size(tp.mesh, axis))[k].clone()
        else:
            out = _reduce_scatter(tp.mesh, g, ctx.tag, axis)
        return (out.movedim(0, dim).contiguous(), None, None, None, None,
                None)


class _ScatterData(torch.autograd.Function):
    """Reduce-scatter over 'data' along dim 0 forward; the gradient
    all-gathered."""

    @staticmethod
    def forward(ctx, x, tp, tag):
        ctx.tp, ctx.tag = tp, tag
        return _reduce_scatter(tp.mesh, x, tag, DATA)

    @staticmethod
    def backward(ctx, grad):
        whole = ctx.tp.mesh.all_gather_cat(grad.contiguous(), DATA,
                                           tag=ctx.tag)
        return whole, None, None


def moe_layout(rules) -> str:
    """'gather' or 'token_tp': the ``MOE_LAYOUTS`` entry `rules` give
    (the experts over 'model' and their hidden over 'data', or the
    reverse); another placement of the experts is not run."""
    placed = (rules["experts"], rules["expert_mlp"], rules["expert_cap"])
    if placed[0] == AXIS and axis_names(placed[1])[-1:] == (DATA,) \
            and placed[2] == DATA:  # the hidden over ('pod', 'data') too
        return "gather"
    if placed == (DATA, AXIS, None):
        return "token_tp"
    raise NotImplementedError(
        f"experts, their hidden and capacity over {placed}: the 'gather' "
        "and 'token_tp' layouts are run")


class TensorParallel:
    """A rank's place on the 'model' axis of `mesh` (a
    ``core.distributed.Mesh``) for model `cfg` under `rules`
    (``sharding_rules.rules_for``): its ``rank`` and the axis ``size``,
    and whether the kv heads are split (``kv_heads``; the q heads, the MLP
    hidden and the vocabulary always are: a layout that replicates one of
    them over a model axis of more than one rank is refused). Beside it,
    the rank's place on 'data' (``data_rank`` of ``data_size``), the mesh
    axes the batch's data parallelism runs over (``data_axes``: ('pod',
    'data') on a mesh with a 'pod' axis), for the MoE family the experts'
    layout (``moe_layout``: 'gather' or 'token_tp'; the experts and their
    hidden must divide their axes; ``expert_hidden``, the hidden's axes),
    and
    for the SSM and hybrid families whether the SSM heads (and the inner
    channels with them) are split over the axis (``ssm_heads``; the rules
    replicate them when the axis does not divide them). Whether a batch's
    rows lie over 'model' too, or over fewer data axes than
    ``data_axes``, is the step's layout, not the model's
    (``rows_over_model``, ``row_axes``).

    ``controls`` (a subset of ``CONTROLS``, empty by default) breaks a
    piece on purpose, for a check to show that its rule catches it."""

    def __init__(self, mesh, cfg, rules=None):
        self.mesh = mesh
        self.size = mesh.size(AXIS)
        self.rank = coordinate(mesh, AXIS)
        self.data_size = mesh.size(DATA)
        self.data_rank = coordinate(mesh, DATA)
        self.data_axes = data_axes(mesh)
        rules = rules or rules_for(cfg, mesh)
        split = {"heads": padded_heads(cfg), "mlp": cfg.d_ff,
                 "vocab": cfg.padded_vocab}
        if self.size > 1:
            kept = [k for k, n in split.items()
                    if rules[k] != AXIS or n % self.size]
            if kept:
                raise NotImplementedError(
                    f"{cfg.name}: a layout that replicates {kept} over a "
                    f"model axis of {self.size} ranks is not run")
        self.kv_heads = rules["kv_heads"] == AXIS
        self.moe_layout = self.expert_hidden = None
        if cfg.num_experts:
            self.moe_layout = moe_layout(rules)
            self.expert_hidden = rules["expert_mlp"]
            for n, ax in ((cfg.num_experts, rules["experts"]),
                          (cfg.d_ff, rules["expert_mlp"])):
                if n % split_size(mesh, ax):
                    raise NotImplementedError(
                        f"{cfg.name}: {n} does not split over {ax!r} of "
                        f"{split_size(mesh, ax)} ranks")
        self.ssm_heads = (cfg.has_ssm and self.size > 1
                          and rules["ssm_heads"] == AXIS)
        self.controls = frozenset()

    def rows_over_model(self, pspec_fn) -> bool:
        """Whether the activations' batch lies over 'model' as well as
        'data' (the SSM family's layout when its batch divides both axes):
        what `pspec_fn` (``sharding_rules.activation_pspec_fn``) gives the
        batch; without it the rows lie over 'data' alone."""
        if pspec_fn is None or self.size == 1:
            return False
        return AXIS in axis_names(pspec_fn(("batch",))[0])

    def row_axes(self, pspec_fn):
        """The data axes the activations' batch lies over: those of
        ``data_axes`` that `pspec_fn` gives the batch (all of them without
        it; fewer where the batch does not divide them, ``batch_axes``'
        fallback to a prefix), as one mesh axis: a name, a tuple of names
        or ()."""
        if pspec_fn is None:
            rows = self.data_axes
        else:
            rows = tuple(a for a in axis_names(pspec_fn(("batch",))[0])
                         if a != AXIS)
        return rows[0] if len(rows) == 1 else rows

    # -- collectives -------------------------------------------------------
    def copy(self, x, tag, axis=AXIS):
        """`x`; in the backward, its gradient all-reduced over `axis` (the
        model axis by default; tag `tag`). The 'input_grad' control drops
        the model axis's all-reduce."""
        if split_size(self.mesh, axis) == 1 or (
                axis == AXIS and "input_grad" in self.controls):
            return x
        return _Copy.apply(x, self, tag, axis)

    def reduce(self, x, tag, axis=AXIS):
        """`x` all-reduced over `axis` (the model axis by default; tag
        `tag`); its gradient as it is."""
        if split_size(self.mesh, axis) == 1:
            return x
        return _Reduce.apply(x, self, tag, axis)

    def kv_weight(self, w):
        """A kv projection weight, replicated over the axis while each
        rank uses only its q heads' kv heads: its gradient is partial on
        each rank and is all-reduced (tag 'kv_grad'), unless the kv heads
        are split or the 'kv_grad' control leaves it unsummed."""
        if self.kv_heads or self.size == 1 or "kv_grad" in self.controls:
            return w
        return _Copy.apply(w, self, "kv_grad", AXIS)

    def bc_weight(self, w):
        """A replicated B/C projection or convolution weight of an SSM
        layer whose heads are split: every rank computes the same B and C,
        but each rank's gradient of them comes from its own heads, so the
        weight's gradient is all-reduced (tag 'ssm_bc_grad'), unless the
        'bc_grad' control leaves it unsummed."""
        if not self.ssm_heads or "bc_grad" in self.controls:
            return w
        return _Copy.apply(w, self, "ssm_bc_grad", AXIS)

    def norm_sum(self, x):
        """`x`, a partial sum over channels split over the axis (the gated
        norm's sum of squares), all-reduced (tag 'ssm_norm'); its gradient
        all-reduced too, unless the 'norm_grad' control drops that."""
        if self.size == 1:
            return x
        return _NormSum.apply(x, self, "ssm_norm")

    def gather_model(self, x, dim, tag):
        """The model ranks' `x` concatenated along `dim` in rank order (a
        leaf split over 'model', whole); its gradient reduce-scattered
        back (under the 'scatter_grad' control the rank's own slice of its
        own)."""
        if self.size == 1:
            return x
        return _Gather.apply(x, self, AXIS, dim, tag,
                             "scatter_grad" in self.controls)

    def gather_data(self, x, dim, tag, axis=None):
        """The ranks' `x` over `axis` (by default the data axes,
        ``data_axes``: a name, a tuple of them or ()) concatenated along
        `dim` in block order (the global batch's rows, or a split weight
        whole); its gradient reduce-scattered back (under the
        'weight_grad' control, when `tag` is 'moe_weights', the rank's own
        slice of its own)."""
        axis = self.data_axes if axis is None else axis
        if split_size(self.mesh, axis) == 1:
            return x
        keep_own = tag == "moe_weights" and "weight_grad" in self.controls
        return _Gather.apply(x, self, axis, dim, tag, keep_own)

    def scatter_data(self, x, tag, rows=None):
        """`x`, a partial sum over the data ranks of every row of the
        global batch, summed over them and cut along dim 0 to this rank's
        rows: its block along `rows` (the axes the batch lies over, by
        default ``data_axes``). The rows of the rank's block over the axes
        of `rows` other than 'data' are cut first, then reduce-scattered
        over 'data' (the gradient all-gathered); where 'data' is not in
        `rows` (the data ranks hold the same rows) the sum is an
        all-reduce (the gradient as it is)."""
        rows = axis_names(self.data_axes if rows is None else rows)
        held = tuple(a for a in rows if a != DATA)
        if split_size(self.mesh, held) > 1:
            x = x.chunk(split_size(self.mesh, held))[
                coordinate(self.mesh, held)]
        if self.data_size == 1:
            return x
        if DATA not in rows:
            return _Reduce.apply(x, self, tag, DATA)
        return _ScatterData.apply(x, self, tag)

    def max_(self, x, tag):
        """`x` (not differentiated) replaced by its maximum over the
        axis, in place."""
        if self.size > 1:
            self.mesh.all_reduce(x, AXIS, op=torch.distributed.ReduceOp.MAX,
                                 tag=tag)
        return x

    def gather(self, x, dim, tag):
        """The ranks' `x` (not differentiated) concatenated along `dim`
        in rank order."""
        if self.size == 1:
            return x
        whole = self.mesh.all_gather_cat(x.movedim(dim, 0), AXIS, tag=tag)
        return whole.movedim(0, dim)

    # -- this rank's share -------------------------------------------------
    def span(self, n: int):
        """(start, stop) of this rank's share of a dim of `n` split over
        the axis."""
        size = n // self.size
        return self.rank * size, (self.rank + 1) * size

    def kv_index(self, cfg, n_local: int) -> slice:
        """The kv heads this rank's `n_local` q heads read when the kv
        heads are replicated: a run of them, each read by a whole number
        of the rank's heads (every arch of the registry on a mesh whose
        model axis splits its heads); another layout is refused."""
        group = padded_heads(cfg) // cfg.num_kv_heads
        if group % n_local and n_local % group:
            raise NotImplementedError(
                f"{cfg.name}: {n_local} q heads a rank over kv groups of "
                f"{group} split a group unevenly")
        start = self.rank * n_local
        return slice(start // group, (start + n_local - 1) // group + 1)


def _split_dims(spec):
    """(dim, axis) for each dim `spec` splits: the axis a name, or a
    tuple of two names or more (a 1-tuple is its name)."""
    for dim, ax in enumerate(spec):
        names = axis_names(ax)
        if names:
            yield dim, names[0] if len(names) == 1 else names


def shard(t, spec, mesh):
    """This rank's shard of the whole tensor `t` under `spec` (a
    contiguous copy, so an in-place update writes the rank's own); a dim
    split over a tuple of axes is cut in the tuple's order, the first
    axis major."""
    for dim, ax in _split_dims(spec):
        n = split_size(mesh, ax)
        size = t.shape[dim] // n
        t = t.narrow(dim, coordinate(mesh, ax) * size, size)
    return t.clone(memory_format=torch.contiguous_format)


def gather(t, spec, mesh, tag="gather"):
    """The whole tensor of the ranks' shards `t` under `spec`, on every
    rank (all-gathers over each split dim's axis, a tuple of axes in its
    order)."""
    for dim, ax in _split_dims(spec):
        if split_size(mesh, ax) > 1:
            t = mesh.all_gather_cat(t.movedim(dim, 0), ax,
                                    tag=tag).movedim(0, dim)
    return t


def shard_params(tree, pspecs, mesh):
    """A tree of whole tensors (parameters, gradients or optimizer state)
    cut to this rank's shards by `pspecs` (a tree like it)."""
    # here: the optim package imports the models, which import this module
    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda t, s: shard(t, s, mesh), tree, pspecs)


def gather_params(tree, pspecs, mesh, tag="gather"):
    """The whole tensors of a tree of this rank's shards, on every rank:
    the inverse of ``shard_params``."""
    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda t, s: gather(t, s, mesh, tag), tree, pspecs)
