"""Mixture-of-Experts: top-k routing, capacity dispatch and the optional
dense residual branch (arctic).

Counterpart of ``repro.models.moe``, split so that the routing, which is
integer or exact, can be held apart from the floating-point work:

* ``route`` picks each token's k experts and renormalises their gates,
  then ranks each (token, slot) within its expert's capacity buffer by a
  stable sort, as the reference does. Ties go to the lower expert index,
  as ``jax.lax.top_k`` breaks them: a stable descending sort, never
  ``torch.topk``, which may pick another of the tied experts. Its outputs
  are the reference's bit for bit, on the CPU and on the card alike.
* ``moe_forward`` runs the router, ``route``, an index-only dispatch (the
  slot map, then a row gather from the zero-padded activations into
  (E, cap, d)), the three expert products batched over the experts in the
  activations' dtype, a scatter-free combine (each token gathers its k
  outputs and weights them by its gates in f32), the dense residual and
  the Switch auxiliary loss. Tokens over an expert's capacity are dropped
  and contribute zero, exactly as in the reference.

The reference's expert products are ``einsum``s outside Pallas, so they
are batched ``torch.bmm`` here.

Over a mesh of ranks (``tp``, a ``distributed.tensor_parallel.
TensorParallel``) ``moe_forward`` computes the function GSPMD makes of
the reference's under its ``pspec_fn``: the route is the global batch's
(every rank routes the probabilities of all tokens, gathered over 'data'
in batch-row order, so every rank holds the same route, bit for bit, and
the capacity and the auxiliary loss are the global batch's), and the
experts run in the layout of the rank's shards (``tp.moe_layout``, which
``pspec_fn.gather_weights`` must name):

* 'gather': the rank's experts are its 'model' block, their FFN hidden
  gathered over 'data' for the layer (``tp.gather_data``; the gradient
  reduce-scattered back), and its slots that block's capacity over
  'data';
* 'token_tp': the rank's experts are its 'data' block with every slot,
  their hidden its 'model' block (the stationary weights), so its
  products are partial sums over the hidden.

Each rank takes the tokens its slots hold from the global batch
(``tp.gather_data``), combines its expert outputs into every token of the
global batch (in f32), and the partial outputs are summed over 'data'
into each rank's rows (``tp.scatter_data``) and over 'model' ('moe_out').
The dense residual runs tensor-parallel, as the dense MLP does.

On a mesh with a 'pod' axis the rows lie over ('pod', 'data'): the
probabilities and the tokens are gathered over both axes (batch-row
order, pod major), and in 'gather' the FFN's hidden, split over both, is
gathered over both; the capacity stays split over 'data' alone, and in
'token_tp' the experts too, so the two pods compute the same slots. Each
rank then keeps its pod's rows of its partial outputs and sums them over
'data' and 'model', the ranks that computed a share of them. Where the
batch does not divide the data axes (``batch_axes``' fallback to a
prefix, ('pod',) or none) the data ranks hold the same rows: the partial
outputs are all-reduced over 'data', and the slots' inputs (the tokens
and the gates) take their gradients summed over 'data' too.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding_rules import axis_names, split_size
from repro_torch.models.mlp import mlp_forward, mlp_template
from repro_torch.models.params import ParamSpec


def moe_template(cfg: ArchConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    t = {
        "router": ParamSpec((d, E), ("embed", None), scale=0.1),
        "wg": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp")),
        "wu": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp")),
        "wd": ParamSpec((E, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.moe_dense_residual:
        t["dense"] = mlp_template(d, f)
    return t


def capacity(T: int, k: int, E: int, capacity_factor: float = 1.25) -> int:
    """Slots an expert holds: int(factor x T x k / E), rounded up to a
    multiple of 256, at least 256 (the reference's rule)."""
    cap = int(capacity_factor * T * k / E)
    return max(((cap + 255) // 256) * 256, 256)


@dataclasses.dataclass(frozen=True)
class Route:
    """Where a batch of T tokens goes, each to k of E experts.

    idx (T, k) int64: the experts, by descending probability, ties to the
    lower index; gate (T, k) f32: their probabilities renormalised over the
    k; pos (T*k,) int64: each (token, slot)'s rank in its expert's buffer,
    in token order; keep (T*k,) bool: pos < cap; dest (T*k,) int64:
    expert x cap + pos where kept, else the sentinel E x cap; slots
    (E*cap,) int64: the token each buffer slot holds, T where empty."""
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    slots: torch.Tensor
    cap: int


def route(probs, k: int, capacity_factor: float = 1.25) -> Route:
    """Top-k routing and capacity dispatch of (T, E) f32 probabilities.

    Runs on the probabilities' device, with no host synchronisation."""
    T, E = probs.shape
    dev = probs.device
    # ties to the lower index, as jax.lax.top_k: a stable descending sort
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    gate = probs.gather(1, idx)
    total = gate[:, 0]
    for j in range(1, k):  # a fixed order of adds, the same on every device
        total = total + gate[:, j]
    gate = gate / torch.clamp_min(total, 1e-9)[:, None]

    cap = capacity(T, k, E, capacity_factor)
    flat_e = idx.reshape(-1)
    n = T * k
    # each (token, slot)'s rank within its expert: a stable sort by expert
    # keeps token order inside each expert's segment
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.arange(n, device=dev) - seg_start[sorted_e]
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, E * cap))
    # the slot map: each kept (token, slot) writes its token id; dropped
    # ones all write the sentinel slot, which is cut off
    tok_id = torch.arange(T, device=dev).repeat_interleave(k)
    slots = torch.full((E * cap + 1,), T, dtype=torch.int64, device=dev)
    slots = slots.scatter_(0, dest, tok_id)[:-1]
    return Route(idx=idx, gate=gate, pos=pos, keep=keep, dest=dest,
                 slots=slots, cap=cap)


def route_per_rank(probs, k: int, n: int,
                   capacity_factor: float = 1.25) -> Route:
    """The 'local_route' control: each of `n` data ranks routes only its
    own rows of the (T, E) `probs` with its own capacity; the routes laid
    side by side as one route of T tokens over buffers of n x the
    per-rank capacity (rank i's slots at [i x cap, (i + 1) x cap) of
    each expert's buffer)."""
    T, E = probs.shape
    T_loc = T // n
    rs = [route(c, k, capacity_factor) for c in probs.chunk(n)]
    cap = rs[0].cap
    big = n * cap
    slots = torch.stack([torch.where(r.slots < T_loc, r.slots + i * T_loc,
                                     torch.full_like(r.slots, T))
                         .view(E, cap) for i, r in enumerate(rs)], 1)
    pos = torch.cat([r.pos + i * cap for i, r in enumerate(rs)])
    keep = torch.cat([r.keep for r in rs])
    idx = torch.cat([r.idx for r in rs])
    dest = torch.where(keep, idx.reshape(-1) * big + pos,
                       torch.full_like(pos, E * big))
    return Route(idx=idx, gate=torch.cat([r.gate for r in rs]), pos=pos,
                 keep=keep, dest=dest, slots=slots.reshape(-1), cap=big)


def _router(x, w):
    return torch.softmax((x @ w).float(), dim=-1)  # the product in x's dtype


def _experts(x, wg, wu, wd, slots, dest, gate, shape):
    """Dispatch by index from the zero-padded tokens `x` (T, d) into the
    (experts, slots) buffers of `shape`, the three products, and the
    combine into every token: (T, d) f32, each token's k outputs (a slot
    not given: the zero row) weighted by its gates."""
    T, d = x.shape
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    x_disp = x_pad[slots].view(*shape, d)
    g = torch.bmm(x_disp, wg)
    u = torch.bmm(x_disp, wu)
    y = torch.bmm(F.silu(g) * u, wd)
    y = torch.cat([y.reshape(-1, d), y.new_zeros(1, d)])
    y_tok = y[dest].view(T, -1, d).float()
    return torch.bmm(gate[:, None, :], y_tok)[:, 0]


def _mesh_layout(tp, pspec_fn) -> str:
    if pspec_fn is not None:
        asked = "gather" if getattr(pspec_fn, "gather_weights", True) \
            else "token_tp"
        if asked != tp.moe_layout:
            raise ValueError(
                f"pspec_fn asks for the {asked!r} MoE layout; the rank's "
                f"expert shards lie in {tp.moe_layout!r} (the model's "
                "rules_overrides)")
    return tp.moe_layout


def _moe_mesh(p, h, cfg: ArchConfig, capacity_factor, tp, layout, wrap,
              rows):
    """``moe_forward`` on a rank of a mesh (see the module docstring):
    (out (B,S,d) whole in h's dtype, aux). `rows` are the data axes the
    batch's rows lie over (``TensorParallel.row_axes``)."""
    B, S, d = h.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    n = tp.data_size  # the capacity's blocks ('gather'), the experts' else
    # where the rows do not lie over 'data' its ranks hold the same rows,
    # each running its own share of the slots: what feeds the slots then
    # takes their partial gradients summed over 'data' too
    spread = "data" not in axis_names(rows)
    x = h.reshape(B * S, d)
    probs = tp.gather_data(wrap(_router)(x, p["router"]), 0, "moe_probs",
                           rows)
    # the gates' gradient is partial on each model rank (its experts, or
    # its share of their hidden): summed over 'model' by the copy
    gates = tp.copy(probs, "moe_gate")
    if spread:
        gates = tp.copy(gates, "moe_gate", "data")
    blocks = split_size(tp.mesh, rows)
    r = (route_per_rank(gates, k, blocks, capacity_factor)
         if "local_route" in tp.controls and blocks > 1
         else route(gates, k, capacity_factor))
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    if layout == "gather":
        hidden = tp.expert_hidden  # 'data', or ('pod', 'data')
        wg = tp.gather_data(wg, 2, "moe_weights", hidden)
        wu = tp.gather_data(wu, 2, "moe_weights", hidden)
        wd = tp.gather_data(wd, 1, "moe_weights", hidden)
        ne, nc = E // tp.size, r.cap // n
        e0, c0 = tp.rank * ne, tp.data_rank * nc
    else:
        ne, nc = E // n, r.cap
        e0, c0 = tp.data_rank * ne, 0
    slots = r.slots.view(E, r.cap)[e0:e0 + ne, c0:c0 + nc].reshape(-1)
    e, pos = r.idx.reshape(-1), r.pos
    held = r.keep & (e >= e0) & (e < e0 + ne) & (pos >= c0) & (pos < c0 + nc)
    dest = torch.where(held, (e - e0) * nc + pos - c0,
                       torch.full_like(pos, ne * nc))
    x_in = tp.copy(x, "moe_in")
    if spread:
        x_in = tp.copy(x_in, "moe_in", "data")
    tokens = tp.gather_data(x_in, 0, "moe_tokens", rows)
    part = wrap(_experts)(tokens, wg, wu, wd, slots, dest, r.gate, (ne, nc))
    out = tp.scatter_data(part, "moe_out", rows)
    if "expert_sum" not in tp.controls:
        out = tp.reduce(out, "moe_out")
    out = out.to(h.dtype)
    if cfg.moe_dense_residual:
        dense = wrap(mlp_forward)(p["dense"], x[None], tp)
        out = out + tp.reduce(dense.reshape(B * S, d), "mlp_out")
    return out.reshape(B, S, d), _aux(probs, r.idx, E)


def _aux(probs, idx, E):
    """The Switch load-balancing loss: E x sum_e mean(probs)_e x f_e, f_e
    the share of tokens whose first choice is e."""
    me = probs.mean(0)
    ce = torch.bincount(idx[:, 0], minlength=E).float() / probs.shape[0]
    return E * torch.sum(me * ce)


def moe_forward(p, h, cfg: ArchConfig, capacity_factor: float = 1.25,
                pspec_fn=None, tp=None, pieces=None):
    """h (B,S,d) -> (out (B,S,d) in h's dtype, aux f32 scalar).

    With `tp` (a mesh of ranks) h is the rank's rows and `out` their
    whole output (summed over both axes: no caller all-reduces it);
    `pspec_fn` (``sharding_rules.activation_pspec_fn``; the reference's
    argument) must name the layout of the rank's expert shards by its
    ``gather_weights``; `pieces` wraps the local work between the
    collectives (the "collectives" remat checkpoints it). On one device
    `pspec_fn` changes nothing, as the reference's constraints do not."""
    if tp is not None:
        return _moe_mesh(p, h, cfg, capacity_factor, tp,
                         _mesh_layout(tp, pspec_fn),
                         pieces or (lambda fn: fn), tp.row_axes(pspec_fn))
    B, S, d = h.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    x = h.reshape(T, d)

    logits = (x @ p["router"]).float()  # the product in h's dtype
    probs = torch.softmax(logits, dim=-1)
    r = route(probs, k, capacity_factor)

    # dispatch by index only: a row gather from the zero-padded tokens
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    x_disp = x_pad[r.slots].view(E, r.cap, d)
    g = torch.bmm(x_disp, p["wg"])
    u = torch.bmm(x_disp, p["wu"])
    y = torch.bmm(F.silu(g) * u, p["wd"])

    # combine with no scatter: each token gathers its k outputs (a dropped
    # one reads the zero row) and weights them by its gates in f32
    y = torch.cat([y.reshape(E * r.cap, d), y.new_zeros(1, d)])
    y_tok = y[r.dest].view(T, k, d).float()
    out = torch.bmm(r.gate[:, None, :], y_tok)[:, 0].to(h.dtype)

    if cfg.moe_dense_residual:
        out = out + mlp_forward(p["dense"], x[None]).reshape(T, d)

    return out.reshape(B, S, d), _aux(probs, r.idx, E)
