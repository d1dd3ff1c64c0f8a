"""Shared layer primitives: RMSNorm, RoPE, embeddings, softcap.

Counterpart of ``repro.models.layers``, with the same dtype rules: the
norm and the rotation compute in float32 and cast back to the input dtype,
and logits are cast to float32 before the softcap.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def softcap(x, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x, positions, theta: float = 10000.0, fraction: float = 1.0):
    """x (..., S, H, D), positions (..., S) integer. Rotates the first
    `fraction` of D (chatglm-style partial rotary when fraction < 1)."""
    D = x.shape[-1]
    inv, rot = rope_freqs(D, theta, fraction, device=x.device)
    ang = positions[..., None].float() * inv  # (..., S, rot/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def embed_tokens(embedding, tokens):
    """embedding (V, d), tokens (...) integer -> (..., d)."""
    return F.embedding(tokens, embedding)


def unembed(h, w_unembed, cap: float = 0.0):
    logits = torch.matmul(h, w_unembed)
    return softcap(logits.float(), cap)


def cross_entropy(logits, targets, vocab_size: int):
    """logits (..., V) f32 (V possibly padded), targets (...) integer.
    Padded vocab entries are masked to -1e30 before the log-sum-exp."""
    V = logits.shape[-1]
    if V > vocab_size:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean()
