"""Plain PyTorch versions of the port's kernels (the ground truth in tests).

Counterpart of ``repro.kernels.ref``. A wrapper in ``ops`` takes these for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on the
card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import losses


def sodda_inner_ref(w0, Xl, yl, mu, gamma, loss: str = "hinge"):
    """The paper's L-step inner SVRG loop over a batch of blocks.

    w0 (..., mt), Xl (..., L, mt), yl (..., L), mu (..., mt) -> (..., mt);
    every leading index is an independent chain. Step i computes

        wbar <- wbar - gamma * [(l'(x_i.wbar) - l'(x_i.w0)) * x_i + mu]

    with both margins taken per step, as the reference does.
    """
    wbar = w0
    for i in range(Xl.shape[-2]):
        x = Xl[..., i, :]
        yy = yl[..., i]
        z1 = (x * wbar).sum(-1)
        z0 = (x * w0).sum(-1)
        c = losses.loss_deriv(loss, z1, yy) - losses.loss_deriv(loss, z0, yy)
        wbar = wbar - gamma * (c[..., None] * x + mu)
    return wbar


# ---------------------------------------------------------------------------
# attention: chunked online-softmax reference (numerically the flash schedule,
# memory O(S * chunk)); supports causal, sliding window, GQA, logit softcap.
# ---------------------------------------------------------------------------
def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, chunk: int = 512, q_offset: int = 0):
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D).

    `q_offset`: absolute position of q[0] (for decode: q_offset = cache_len).
    GQA: query head h attends to kv head h // (H // KV).

    The reference's arithmetic, with two differences:
      * the scores q.k are taken in float32, as the TPU kernel and the CUDA
        kernel take them; the reference's einsum runs in the input dtype
        and so rounds bf16 scores to bf16 first. For float32 inputs the two
        are the same arithmetic;
      * the reference's running max starts at -inf, so a row whose first
        chunk the window masks entirely computes exp(-inf - -inf) = NaN.
        Here a max of -inf is used as 0 in the exponents, so masked keys
        add exactly 0 wherever they fall.
    """
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"attention_ref: H={H} is not a multiple of KV={KV}")
    group = H // KV
    # 1 / sqrt(D), rounded to q's dtype before the division, as the reference
    scale = 1.0 / torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
    scale = scale.to(q.device)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    qf = q.float()
    qpos = q_offset + torch.arange(Sq, device=q.device)

    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kpos = c0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.ones(Sq, kb.shape[1], dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        p = torch.exp(s - m_use[..., None])
        alpha = torch.exp(m - m_use)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    vb.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_naive(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0):
    """O(S^2)-memory textbook attention — oracle for attention_ref itself."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    group = H // KV
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window > 0:
        mask &= qpos[:, None] - kpos[None] < window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
