"""GQA attention: templates, the prefill forward and the 'heads' decode.

Counterpart of ``repro.models.attention``. Head padding is the reference's:
q heads are padded up to ``padded_heads`` and the output-projection rows of
the padded heads are zeroed at init (``zero_padded_wo``). Unlike the
reference, every path (``attn_forward``, so training and prefill, and
``decode_attn_heads``) also zeroes the padded heads' attention output
before ``wo`` (``inert_heads``). Zeroed wo rows alone do not keep the
heads out: the gradient of ``wo[h]`` is the sum over positions of
out_h (x) dy, and out_h is not 0 for a padded head, so the reference's
first optimizer step gives the padded rows weight and arctic-480b trains
as a 64-head model. Masked, the padded rows take a gradient of exactly 0
and stay 0 under every optimizer, so the model is the unpadded one in
training too; on the weights of ``init`` the masked forward is bitwise
the unmasked one. The prefill forward runs the flash-attention kernel
through ``kernels.ops.flash_attention``. Decode attends over the whole
cache in plain torch, as the reference's 'heads' path does; its 'seq' path
(a flash-decode over a sequence-sharded cache) belongs with the mesh work
and is not ported yet.

Unlike the reference, decode writes the new key and value into the cache
in place (``_write_cache``), so one copy of the cache lives on the device.
Decode also masks a cache slot by the position it holds, not by its index:
a ring of S slots (the hybrid family's long-context cache) holds position
pos - ((pos - slot) mod S) in slot `slot`. The reference compares pos with
the slot index (``repro.models.attention.decode_attn_heads``), which masks
out the newest keys of a ring once pos >= S; the two agree on a
full-length cache, where slot and position are one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, round_up
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import ParamSpec


def padded_heads(cfg: ArchConfig) -> int:
    return round_up(cfg.num_heads, 16)


def head_mask(cfg: ArchConfig, device=None):
    """(Hp,) float mask — 0 for padded q heads (one per GQA group tail)."""
    Hp = padded_heads(cfg)
    if Hp == cfg.num_heads:
        return torch.ones(Hp, dtype=torch.float32, device=device)
    group = Hp // cfg.num_kv_heads
    per_group_real = cfg.num_heads // cfg.num_kv_heads
    pos_in_group = torch.arange(Hp, device=device) % group
    return (pos_in_group < per_group_real).float()


def inert_heads(out, cfg: ArchConfig):
    """The attention output `out` (..., Hp, hd) with the padded heads'
    rows zeroed (the real heads' bits unchanged); `out` itself when
    nothing is padded."""
    if padded_heads(cfg) == cfg.num_heads:
        return out
    return out * head_mask(cfg, out.device).to(out.dtype)[:, None]


def attn_template(cfg: ArchConfig) -> dict:
    hd = cfg.resolved_head_dim
    Hp, KV, d = padded_heads(cfg), cfg.num_kv_heads, cfg.d_model
    return {
        "wq": ParamSpec((d, Hp, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((Hp, hd, d), ("heads", "head_dim", "embed")),
    }


def zero_padded_wo(cfg: ArchConfig, attn_params: dict) -> dict:
    """The attention parameters with the padded heads' wo rows zeroed. `wo`
    may be stacked over layers: the head axis is its third-last."""
    wo = attn_params["wo"]
    mask = head_mask(cfg, wo.device).to(wo.dtype)
    return dict(attn_params, wo=wo * mask[:, None, None])


def _project(h, w):
    """h (B, S, d) @ w (d, N, hd) -> (B, S, N, hd)."""
    d, n, hd = w.shape
    return (h @ w.reshape(d, n * hd)).view(*h.shape[:-1], n, hd)


def qkv(p, h, cfg: ArchConfig, positions):
    q = _project(h, p["wq"])
    k = _project(h, p["wk"])
    v = _project(h, p["wv"])
    frac = 0.5 if cfg.name.startswith("chatglm") else 1.0  # chatglm 2d-RoPE
    q = apply_rope(q, positions, cfg.rope_theta, frac)
    k = apply_rope(k, positions, cfg.rope_theta, frac)
    return q, k, v


def _out_proj(out, wo):
    """out (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    H, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def attn_forward(p, h, cfg: ArchConfig, positions, *, window: int = 0,
                 force: str = "auto"):
    """Full-sequence (prefill) attention. h (B,S,d) -> (B,S,d), plus the
    (k, v) tensors for cache construction."""
    q, k, v = qkv(p, h, cfg, positions)
    out = kops.flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_logit_softcap, force=force)
    return _out_proj(inert_heads(out, cfg), p["wo"]), (k, v)


def decode_mask(pos, S: int, window: int = 0):
    """(B, S) bool: the slots of an S-slot decode cache that the query at
    `pos` (B,) sees. Slot `slot` holds position pos - ((pos - slot) mod S)
    (negative: not written yet; pos itself sits in slot pos % S, so every
    held position is <= pos); a key is seen when that position is written
    and, with a `window`, within it."""
    slot = torch.arange(S, device=pos.device)
    kpos = pos[:, None] - (pos[:, None] - slot[None, :]) % S  # (B,S)
    mask = kpos >= 0
    if window > 0:
        mask = mask & (pos[:, None] - kpos < window)
    return mask


def decode_attn_heads(p, h, cfg: ArchConfig, cache_k, cache_v, pos,
                      window: int = 0, mask=None):
    """'heads' decode: h (B,1,d); cache (B,S,KV,hd), written in place at
    ``pos[0] % S``; pos (B,) on the device (read there, never on the host).
    The keys seen are ``mask`` (B,S), by default ``decode_mask(pos, S,
    window)``: a decode step builds it once for all its layers. Returns
    the attention output (B,1,d) and the (updated) cache."""
    q, k_new, v_new = qkv(p, h, cfg, pos[:, None])
    _write_cache(cache_k, k_new, pos)
    _write_cache(cache_v, v_new, pos)
    B, S, KV, hd = cache_k.shape
    H = q.shape[2]
    group = H // KV
    # query head h reads kv head h // group: group the q heads by kv head
    # instead of repeating the cache (the same dot products)
    qg = q.view(B, KV, group, hd)
    s = torch.einsum("bjgk,bsjk->bjgs", qg, cache_k).float()
    s = s.reshape(B, H, 1, S) / math.sqrt(hd)
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    if mask is None:
        mask = decode_mask(pos, S, window)
    s = torch.where(mask[:, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bjgs,bsjk->bjgk", w.view(B, KV, group, S),
                       cache_v.float())
    out = out.reshape(B, 1, H, hd).to(h.dtype)
    return _out_proj(inert_heads(out, cfg), p["wo"]), (cache_k, cache_v)


def _write_cache(cache, new, pos):
    """cache (B,S,KV,hd); new (B,1,KV,hd); pos (B,) — all equal in batch.

    Writes at pos % S, in place: a plain write for full-context caches
    (pos < S) and ring semantics for windowed caches."""
    idx = pos[:1].long() % cache.shape[1]
    cache.index_copy_(1, idx, new.to(cache.dtype))
