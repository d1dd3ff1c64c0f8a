"""Shared layer primitives: RMSNorm, RoPE, embeddings, softcap.

Counterpart of ``repro.models.layers``, with the same dtype rules: the
norm and the rotation compute in float32 and cast back to the input dtype,
and logits are cast to float32 before the softcap.

Over a mesh (``tp``, a ``distributed.tensor_parallel.TensorParallel``)
the vocabulary is split over the 'model' axis, as the reference's rules
split it: the embedding is a masked lookup of the rank's rows, all-reduced;
the unembedding gives the rank's columns of the logits; the cross entropy
takes their maximum over the axis, then the sum of exponentials and the
gold logit by one all-reduce.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-6, tp=None):
    """x normalised by the root mean square of its last dim, scaled by
    1 + weight. With `tp` that dim is split over the 'model' axis (`x`
    and `weight` the rank's channels): the sum of squares is all-reduced
    over the axis, forward and backward (``TensorParallel.norm_sum``)."""
    dt = x.dtype
    x = x.float()
    if tp is None:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        var = tp.norm_sum(torch.sum(x * x, dim=-1, keepdim=True)) \
            / (x.shape[-1] * tp.size)
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


def _local_ids(ids, n, tp):
    """(ids - this rank's first vocab row, clamped to its n rows; whether
    each id is one of them)."""
    start = tp.rank * n
    local = ids.long() - start
    ok = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), ok


def embed_tokens(embedding, tokens, tp=None):
    """embedding (V, d), tokens (...) integer -> (..., d). With `tp`,
    `embedding` is the rank's rows of the vocabulary: each rank looks up
    the tokens it holds (0 for the others), and the sum over the axis is
    every token's row."""
    if tp is None:
        return F.embedding(tokens, embedding)
    local, ok = _local_ids(tokens, embedding.shape[0], tp)
    h = torch.where(ok[..., None], F.embedding(local, embedding), 0)
    return tp.reduce(h, "embed")


def unembed(h, w_unembed, cap: float = 0.0, tp=None):
    """h (..., d) @ w_unembed (d, V) -> f32 logits, softcapped. With `tp`,
    `w_unembed` is the rank's columns of the vocabulary and so are the
    logits; h's gradient is summed over the axis."""
    if tp is not None:
        h = tp.copy(h, "unembed_in")
    logits = torch.matmul(h, w_unembed)
    return softcap(logits.float(), cap)


def cross_entropy(logits, targets, vocab_size: int, tp=None):
    """logits (..., V) f32 (V possibly padded), targets (...) integer.
    Padded vocab entries are masked to -1e30 before the log-sum-exp. With
    `tp`, `logits` are the rank's columns of the vocabulary: the maximum
    is taken over the axis, and the sum of exponentials and the gold logit
    are summed over it (one all-reduce)."""
    if tp is not None:
        return _cross_entropy_split(logits, targets, vocab_size, tp)
    V = logits.shape[-1]
    if V > vocab_size:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean()


def _cross_entropy_split(logits, targets, vocab_size, tp):
    n = logits.shape[-1]
    ids = tp.rank * n + torch.arange(n, device=logits.device)
    if n * tp.size > vocab_size:
        logits = logits.masked_fill(ids >= vocab_size, -1e30)
    m = tp.max_(logits.detach().amax(dim=-1), "ce_max")
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    local, ok = _local_ids(targets, n, tp)
    gold = torch.where(ok, torch.gather(logits, -1, local[..., None])[..., 0],
                       0)
    sumexp, gold = tp.reduce(torch.stack([sumexp, gold]), "ce")
    return (m + torch.log(sumexp) - gold).mean()
