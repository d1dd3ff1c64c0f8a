"""GQA attention: templates, the prefill forward and the two decodes.

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
cache in plain torch: 'heads' (``decode_attn_heads``), as the reference's,
and over a mesh 'seq' (``decode_attn_seq``), a flash-decode over a cache
split along its sequence.

Over a mesh (``tp``, a ``distributed.tensor_parallel.TensorParallel``) the
q heads are split over the 'model' axis (a rank's slice of ``head_mask``
applies to its own heads), the kv heads where the rules split them, else
replicated: a rank then reads the kv heads its q heads belong to
(``TensorParallel.kv_index``), and the replicated ``wk`` and ``wv`` get
their partial gradients summed over the axis (``kv_weight``). ``wo`` is
row-parallel: every function here returns the rank's partial sum of the
output projection, which the caller all-reduces (``tp.reduce``), so that
a remat policy can keep the all-reduce's output
(``transformer._remat``).

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


def inert_heads(out, cfg: ArchConfig, tp=None):
    """The attention output `out` (..., H, hd) with the padded heads'
    rows zeroed (the real heads' bits unchanged); `out` itself when
    nothing is padded. With `tp`, `out` holds the rank's heads and its
    slice of the mask applies."""
    if padded_heads(cfg) == cfg.num_heads:
        return out
    mask = head_mask(cfg, out.device)
    if tp is not None:
        mask = mask[slice(*tp.span(mask.shape[0]))]
    return out * mask.to(out.dtype)[:, None]


def _inert(out, cfg: ArchConfig, tp):
    # one device calls inert_heads(out, cfg), the form tests replace
    return inert_heads(out, cfg) if tp is None else inert_heads(out, cfg, tp)


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


def qkv(p, h, cfg: ArchConfig, positions, tp=None):
    """q (B,S,H,hd), k and v (B,S,KV,hd), rotated. With `tp`, H is the
    rank's q heads and KV its kv heads (all of them, replicated, when the
    rules do not split them); h's gradient is summed over the axis."""
    wk, wv = p["wk"], p["wv"]
    if tp is not None:
        h = tp.copy(h, "attn_in")
        wk, wv = tp.kv_weight(wk), tp.kv_weight(wv)
    q = _project(h, p["wq"])
    k = _project(h, wk)
    v = _project(h, wv)
    frac = 0.5 if cfg.name.startswith("chatglm") else 1.0  # chatglm 2d-RoPE
    q = apply_rope(q, positions, cfg.rope_theta, frac)
    k = apply_rope(k, positions, cfg.rope_theta, frac)
    return q, k, v


def _out_proj(out, wo):
    """out (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    H, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def local_kv(k, cfg: ArchConfig, tp, n_local: int):
    """The kv heads a rank's `n_local` q heads read: `k` (B,S,KV,hd)
    itself unless the kv heads are replicated over a split axis."""
    if tp is None or tp.kv_heads or tp.size == 1:
        return k
    return k[:, :, tp.kv_index(cfg, n_local)]


def attn_forward(p, h, cfg: ArchConfig, positions, *, window: int = 0,
                 force: str = "auto", tp=None):
    """Full-sequence (train / prefill) attention. h (B,S,d) -> (B,S,d),
    plus the (k, v) tensors for cache construction. With `tp` the output
    is the rank's partial sum (its heads through its rows of ``wo``), the
    flash kernel runs over the rank's heads, and (k, v) are the rank's kv
    heads (all of them when replicated)."""
    q, k, v = qkv(p, h, cfg, positions, tp)
    H = q.shape[2]
    out = kops.flash_attention(q, local_kv(k, cfg, tp, H),
                               local_kv(v, cfg, tp, H), causal=True,
                               window=window,
                               softcap=cfg.attn_logit_softcap, force=force)
    return _out_proj(_inert(out, cfg, tp), p["wo"]), (k, v)


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
                      window: int = 0, mask=None, tp=None):
    """'heads' decode: h (B,1,d); cache (B,S,KV,hd), written in place at
    ``pos[0] % S``; pos (B,) on the device (read there, never on the host).
    The keys seen are ``mask`` (B,S), by default ``decode_mask(pos, S,
    window)``: a decode step builds it once for all its layers. Returns
    the attention output (B,1,d) and the (updated) cache. With `tp` the
    cache holds the rank's kv heads (the rules split them: 'heads' mode)
    and the output is the rank's partial sum."""
    q, k_new, v_new = qkv(p, h, cfg, pos[:, None], tp)
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
    return _out_proj(_inert(out, cfg, tp), p["wo"]), (cache_k, cache_v)


def decode_attn_seq(p, h, cfg: ArchConfig, cache_k, cache_v, pos, tp,
                    window: int = 0):
    """'seq' decode over a mesh: h (B,1,d); cache (B,S_loc,KV,hd), this
    rank's chunk of the sequence (positions rank x S_loc onwards), all kv
    heads; pos (B,), all equal. h, the cache and pos are the rank's rows:
    the batch lies over the mesh's data axes (``TensorParallel.data_axes``,
    the reference's ``batch_axes``: ('pod', 'data') on a mesh with a 'pod'
    axis), and every collective here runs over 'model'. The new key and
    value are written only
    into the chunk that holds ``pos[0]`` (read once on the host). The
    rank's q heads are gathered over the axis; each rank forms its chunk's
    partials for every head, its maximum score m, the sum l of
    exp(s - m) and o, their weights on the values, with the window and
    the softcap; the partials are merged by an all-reduce max and two
    all-reduce sums, with ``max(l, 1e-37)``, as the reference's
    flash-decode merge. Returns the rank's partial sum of the output
    (B,1,d), through its heads' rows of ``wo``, and the cache."""
    q, k_new, v_new = qkv(p, h, cfg, pos[:, None], tp)
    H_loc = q.shape[2]
    q = tp.gather(q, 2, "decode_q")
    B, S_loc, KV, hd = cache_k.shape
    start = tp.rank * S_loc
    at = int(pos[0]) - start
    if 0 <= at < S_loc:
        cache_k[:, at] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, at] = v_new[:, 0].to(cache_v.dtype)
    H = q.shape[2]
    group = H // KV
    qg = q.view(B, KV, group, hd)
    s = torch.einsum("bjgk,bsjk->bjgs", qg, cache_k).float()
    s = s.reshape(B, H, 1, S_loc) * (1.0 / hd ** 0.5)
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    kpos = start + torch.arange(S_loc, device=pos.device)
    mask = kpos[None, :] <= pos[:, None]
    if window > 0:
        mask = mask & (pos[:, None] - kpos[None, :] < window)
    s = torch.where(mask[:, None, None], s, -1e30)
    m = s.amax(dim=-1)  # (B,H,1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = torch.einsum("bjgs,bsjk->bjgk", e.view(B, KV, group, S_loc),
                     cache_v.float()).reshape(B, H, 1, hd)
    m_g = tp.max_(m.clone(), "decode_max")
    corr = torch.exp(m - m_g)
    l_g = tp.reduce(l * corr, "decode_l")
    o_g = tp.reduce(o * corr[..., None], "decode_o")
    out = (o_g / torch.clamp_min(l_g, 1e-37)[..., None]).transpose(1, 2)
    out = out[:, :, slice(*tp.span(H))] if H_loc != H else out
    out = out.to(h.dtype)
    return _out_proj(_inert(out, cfg, tp), p["wo"]), (cache_k, cache_v)


def _write_cache(cache, new, pos):
    """cache (B,S,KV,hd); new (B,1,KV,hd); pos (B,) — all equal in batch.

    Writes at pos % S, in place: a plain write for full-context caches
    (pos < S) and ring semantics for windowed caches."""
    idx = pos[:1].long() % cache.shape[1]
    cache.index_copy_(1, idx, new.to(cache.dtype))
