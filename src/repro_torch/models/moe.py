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
are batched ``torch.bmm`` here. The experts' mesh layouts are ported as
data (``distributed.sharding_rules.MOE_LAYOUTS``, ``Model.pspecs``, and
``activation_pspec_fn``'s ``gather_weights``, which names the layout
``moe_forward``'s ``pspec_fn`` would read); running them over a mesh of
ranks (the route over the global batch, 'gather' and 'token_tp') waits
for ROADMAP A6b, and a mesh refuses the MoE family until then.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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


def moe_forward(p, h, cfg: ArchConfig, capacity_factor: float = 1.25):
    """h (B,S,d) -> (out (B,S,d) in h's dtype, aux f32 scalar)."""
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

    # the Switch load-balancing loss: E x sum_e mean(probs)_e x f_e, f_e the
    # share of tokens whose first choice is e
    me = probs.mean(0)
    ce = torch.bincount(r.idx[:, 0], minlength=E).float() / T
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, d), aux
