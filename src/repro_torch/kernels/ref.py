"""Plain PyTorch versions of the port's kernels (the ground truth in tests).

Counterpart of ``repro.kernels.ref``. A wrapper in ``ops`` takes these for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on the
card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import losses
from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK


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
P_SPLITS = (0, 1, 2)


def split_p(p, p_split: int = 0):
    """The weights P as a tensor-core P.V product sees them (f32 out).

    0: P in f32 (the plain arithmetic); 1: P rounded once to bf16 (the
    textbook Hopper kernel: a control); 2: p_hi + p_lo with p_hi = bf16(p)
    and p_lo = bf16(p - p_hi), the two bf16 operands the wgmma kernel
    multiplies into one f32 accumulator. p_hi is within 2^-8 |p| of p,
    p - p_hi is exact in f32, and p_hi + p_lo is within 2^-16 |p| of p
    and exact in f32.
    """
    if p_split not in P_SPLITS:
        raise ValueError(f"p_split must be one of {P_SPLITS}, got {p_split}")
    if p_split == 0:
        return p
    out, *rest = bf16_pieces(p, p_split)
    for piece in rest:
        out = out + piece
    return out


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, chunk: int = 512, q_offset: int = 0,
                  p_split: int = 0, return_lse: bool = False,
                  in_pieces: int = 0, mid_pieces: int = 0):
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D).

    `q_offset`: absolute position of q[0] (for decode: q_offset = cache_len).
    GQA: query head h attends to kv head h // (H // KV).
    `p_split`: how P enters P.V (``split_p``); the row sums l always take
    the f32 P, as the kernels do.
    `in_pieces` and `mid_pieces` (not with `p_split`) take both products
    as the float32 kernel's bf16 tensor cores take them
    (``csrc/flash_attention.cu``; ``_split_product``): q, k and v in
    `in_pieces` bf16 pieces, P in `mid_pieces` (``bf16_pieces``), the
    piece products with a + b <= 2 summed smallest first, each key chunk's
    P.V fresh and added to the rescaled output in f32. The kernel takes
    (3, 3); (1, 1), every operand rounded once to bf16, is the split
    control. The defaults (0, 0) are the f32 arithmetic, bitwise the
    function without the options. The sums run in this function's order
    (whole key chunks of `chunk`), not the kernel's tiles'.
    `return_lse`: also return each row's log-sum-exp of its scores,
    lse = m + log(max(l, 1e-37)) in f32, (B, H, Sq): what the kernels save
    for the backward (``attention_grads``); -inf for a row that sees no
    key. The output is the same either way.

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
    for name, pieces in (("in_pieces", in_pieces),
                         ("mid_pieces", mid_pieces)):
        if pieces not in BWD_PIECES:
            raise ValueError(f"{name} must be one of {BWD_PIECES}, got "
                             f"{pieces}")
    if p_split and (in_pieces or mid_pieces):
        raise ValueError("p_split (the bf16 kernel's P) and "
                         "in_pieces/mid_pieces (the f32 kernel) do not mix")
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
        s = _split_product("bqhd,bkhd->bhqk", qf, kb.float(), in_pieces,
                           in_pieces) * scale
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
        acc = acc * alpha[..., None] + _split_product(
            "bhqk,bkhd->bhqd", split_p(p, p_split), vb.float(), mid_pieces,
            in_pieces)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    out = out.transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, m + torch.log(torch.clamp_min(l, 1e-37))
    return out


def attention_grads(q, k, v, out, lse, dout, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0, q_offset: int = 0,
                    chunk: int = 512, ds_split: int = 0, p_split: int = 0,
                    softcap_grad: bool = True, in_pieces: int = 0,
                    mid_pieces: int = 0):
    """The gradients of ``attention_ref``'s output for q, k and v, given
    its output `out`, its log-sum-exp `lse` (``return_lse``) and dout
    (B, Sq, H, D): (dq, dk, dv), each in its input's dtype and shape.

    The backward kernel's twin (``csrc/flash_attention_bwd.cu``), in f32,
    over `chunk` keys at a time with the FlashAttention-2 recurrence:

        Delta = rowsum(dout * out)
        P     = exp(s - lse)           (0 where the mask masks)
        dV    = P^T . dout,            dP = dout . V^T
        dS    = P * (dP - Delta) * (1 - (s / softcap)^2)
        dQ    = scale dS . K,          dK = scale dS^T . Q

    s the capped score, its cap's derivative 1 - tanh^2 applied before
    the scale; dK and dV summed over each group's query heads (GQA). The
    scale is ``attention_ref``'s, the mask too (scale, softcap, mask).

    `in_pieces` and `mid_pieces` take every product as the kernel's bf16
    tensor cores take it (``_split_product``): an input operand (q, k, v,
    dout) in `in_pieces` bf16 pieces, P and dS in `mid_pieces`
    (``bf16_pieces``), the piece products with a + b <= 2 summed smallest
    first, each key chunk's products fresh and added to dQ in f32. The
    kernel's float32 route is (3, 3), its bfloat16 route (1, 2) (inputs
    exact, P and dS in two halves); (1, 1), every operand rounded once to
    bf16, is the split control. The defaults (0, 0) are the f32
    arithmetic. The sums run in this function's order (whole key chunks
    of `chunk`), not the kernel's tiles'.

    Three options exist for controls only: `ds_split` takes dS as
    ``split_p`` takes P before the dQ and dK products (1: rounded once to
    bf16, as a textbook tensor-core kernel takes it), `p_split` takes P
    so before the dV product, and ``softcap_grad=False`` drops the cap's
    derivative.
    """
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"attention_grads: H={H} is not a multiple of "
                         f"KV={KV}")
    for name, pieces in (("in_pieces", in_pieces),
                         ("mid_pieces", mid_pieces)):
        if pieces not in BWD_PIECES:
            raise ValueError(f"{name} must be one of {BWD_PIECES}, got "
                             f"{pieces}")
    pi, pm = in_pieces, mid_pieces
    group = H // KV
    scale = 1.0 / torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
    scale = scale.to(q.device).float()
    qh = q.float().transpose(1, 2)  # (B, H, Sq, D)
    kh = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vh = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    doh = dout.float().transpose(1, 2)
    delta = (doh * out.float().transpose(1, 2)).sum(-1)  # (B, H, Sq)
    lse = lse.float()
    qpos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for c0 in range(0, Sk, chunk):
        kb, vb = kh[:, :, c0:c0 + chunk], vh[:, :, c0:c0 + chunk]
        kpos = c0 + torch.arange(kb.shape[2], device=q.device)
        s = _split_product("bhqd,bhkd->bhqk", qh, kb, pi, pi) * scale
        if softcap > 0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = torch.ones(Sq, kb.shape[2], dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
        dv[:, :, c0:c0 + chunk] = _split_product(
            "bhqk,bhqd->bhkd", split_p(p, p_split), doh, pm, pi)
        dp = _split_product("bhqd,bhkd->bhqk", doh, vb, pi, pi)
        ds = p * (dp - delta[..., None])
        if softcap > 0 and softcap_grad:
            ds = ds * (1.0 - t * t)
        ds = split_p(ds, ds_split)
        dq += _split_product("bhqk,bhkd->bhqd", ds, kb, pm, pi)
        dk[:, :, c0:c0 + chunk] = _split_product("bhqk,bhqd->bhkd", ds, qh,
                                                 pm, pi) * scale
    dq = (dq * scale).transpose(1, 2).to(q.dtype)

    def by_kv_head(g):  # (B, H, Sk, D) -> (B, Sk, KV, D), the group summed
        return g.view(B, KV, group, Sk, D).sum(2).transpose(1, 2)

    return dq, by_kv_head(dk).to(k.dtype), by_kv_head(dv).to(v.dtype)


def attention_naive(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0):
    """O(S^2)-memory textbook attention — oracle for attention_ref itself.
    Computed in f32, or in f64 for f64 inputs (the gradient checks)."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    group = H // KV
    ct = torch.promote_types(q.dtype, torch.float32)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(ct) / math.sqrt(D)
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
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct)).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD. The exact sequential recurrence (the oracle)
#   state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * outer(x_t, B_t)
#   y_t     = C_t . state_t + D_h * x_t
# and the chunked form the kernel computes (``models/ssm.py::ssd_chunked``
# of the reference). Head h reads B/C group h // (H // G).
# ---------------------------------------------------------------------------
def _group_heads(m, H: int, dtype=torch.float32):
    """(B, S, G, N) -> (B, S, H, N) in `dtype`: head h reads group
    h // (H // G)."""
    G = m.shape[2]
    if H % G:
        raise ValueError(f"ssd: H={H} is not a multiple of G={G}")
    return m.to(dtype).repeat_interleave(H // G, dim=2)


def _ssd_dtype(x):
    """The chunked SSD's compute dtype: float32, or float64 for float64
    inputs (the gradient checks at float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_ref(x, dt, A, Bm, Cm, D=None):
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) -> (B,S,H,P).

    One step at a time in f32, rounded once to x's dtype at the end.
    """
    Bsz, S, H, P = x.shape
    Bh, Ch = _group_heads(Bm, H), _group_heads(Cm, H)
    xf, dtf, A = x.float(), dt.float(), A.float()
    state = torch.zeros(Bsz, H, P, Bm.shape[-1], dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)  # (B, H)
        state = (state * decay[..., None, None]
                 + (dtf[:, t, :, None] * xf[:, t])[..., None]
                 * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_chunk_terms(x, dt, A, Bm, Cm, chunk: int = 256, w_split: int = 0,
                    state_split: int = 0, update_split: int = 0,
                    in_pieces: int = 0, mid_pieces: int = 0):
    """The two f32 terms of the chunked SSD, each (B, S, H, P):

      y_intra_i = sum_{j <= i in i's chunk} C_i.B_j exp(cum_i - cum_j) dt_j x_j
      y_inter_i = exp(cum_i) C_i . state_in  (the state carried into the chunk)

    with cum the inclusive cumsum of dt * A inside each chunk. Every
    exponent is <= 0 (A < 0, dt > 0). A ragged last chunk is zero-padded:
    a row with dt = 0, x = 0 adds nothing, so the pad changes no output.

    The three f32 operands a bf16 tensor-core kernel must feed to its
    products are taken as ``split_p`` takes P (0: f32; 1: rounded once to
    bf16, a control; 2: hi + lo, the bf16 wgmma kernel's two bf16 passes
    into one f32 accumulator):
    `w_split` the intra-chunk weights W in W . x, `state_split` the carried
    state as C . state reads it (the state itself stays f32), and
    `update_split` the operand x_j w_j of the state update
    sum_j (x_j w_j) outer B_j.

    Or `in_pieces` and `mid_pieces` (not both families at once) take
    every product as the f32 kernel's
    tensor cores take it (``csrc/ssd_scan.cu``; ``_split_product``): an
    input operand (x, B, C) in `in_pieces` bf16 pieces, one computed in
    f32 (W, the carried state, x_j w_j) in `mid_pieces` (``bf16_pieces``;
    the kernel takes (3, 3), (1, 1) is the single-rounding control).
    C . state is taken as (C exp(cum)) . state, C exp(cum) in `in_pieces`:
    the kernel splits C and scales the product's rows after it, which
    leaves out terms of the same size. The defaults are the f32
    arithmetic.
    Inputs of float64 are computed in float64 (``_ssd_dtype``).
    """
    for name, split in (("w_split", w_split), ("state_split", state_split),
                        ("update_split", update_split)):
        if split not in P_SPLITS:
            raise ValueError(f"{name} must be one of {P_SPLITS}, got {split}")
    for name, pieces in (("in_pieces", in_pieces),
                         ("mid_pieces", mid_pieces)):
        if pieces not in BWD_PIECES:
            raise ValueError(f"{name} must be one of {BWD_PIECES}, got "
                             f"{pieces}")
    if (w_split or state_split or update_split) and (in_pieces or
                                                      mid_pieces):
        raise ValueError("the *_split options (the bf16 kernel) and "
                         "in_pieces/mid_pieces (the f32 kernel) do not mix")
    pi, pm = in_pieces, mid_pieces
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    NC = (S + pad) // chunk

    ct = _ssd_dtype(x)

    def chunks(t):  # (B, S, ...) -> (B, NC, chunk, ...) in ct
        t = t.to(ct)
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, NC, chunk, *t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)
    Bc, Cc = chunks(_group_heads(Bm, H, ct)), chunks(_group_heads(Cm, H, ct))
    cum = torch.cumsum(dtc * A.to(ct), dim=2)  # (B, NC, Cn, H), <= 0
    seg = cum[:, :, :, None] - cum[:, :, None]  # (B, NC, Cn_i, Cn_j, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    # the exponent is masked before the exp: above the diagonal seg is a
    # large positive sum whose exp overflows, and autograd through a
    # masked inf multiplies inf by 0 (the reference's models/ssm.py:67
    # does, and its gradient is NaN from a chunk of 32-64). The causal
    # entries take the same exp values, so the forward is unchanged.
    decay = torch.exp(torch.where(causal, seg, -math.inf))
    Gm = _split_product("bnchk,bnjhk->bnhcj", Cc, Bc, pi, pi)  # (B, NC, H, Cn, Cn)
    W = (Gm * decay.permute(0, 1, 4, 2, 3)
         * dtc.permute(0, 1, 3, 2)[..., None, :])
    del seg, decay, Gm
    y_intra = _split_product("bnhcj,bnjhp->bnchp", split_p(W, w_split), xc,
                             pm, pi)
    del W

    # each chunk's outgoing state contribution, then the carry across chunks
    last = cum[:, :, -1:]  # (B, NC, 1, H)
    w_state = torch.exp(last - cum) * dtc  # (B, NC, Cn, H)
    S_c = _split_product("bnchp,bnchk->bnhpk",
                         split_p(xc * w_state[..., None], update_split), Bc,
                         pm, pi)
    state = torch.zeros(Bsz, H, P, N, dtype=ct, device=x.device)
    states_in = []
    for c in range(NC):
        states_in.append(state)
        state = state * torch.exp(last[:, c, 0])[..., None, None] + S_c[:, c]
    states_in = torch.stack(states_in, dim=1)  # (B, NC, H, P, N)
    y_inter = _split_product("bnchk,bnhpk->bnchp",
                             Cc * torch.exp(cum)[..., None],
                             split_p(states_in, state_split), pi, pm)
    return (y_intra.reshape(Bsz, NC * chunk, H, P)[:, :S],
            y_inter.reshape(Bsz, NC * chunk, H, P)[:, :S])


def ssd_chunked_ref(x, dt, A, Bm, Cm, D=None, chunk: int = 256):
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) -> (B,S,H,P).

    The chunked SSD (``ssd_chunk_terms``), D . x added in f32 and rounded
    once to x's dtype, as the reference's ``models/ssm.py::ssd_chunked``
    does. (The reference's ``ops.ssd_scan`` rounds the kernel's output and
    then the sum with D . x: twice.) The result depends on `chunk` only
    through f32 rounding.
    """
    y_intra, y_inter = ssd_chunk_terms(x, dt, A, Bm, Cm, chunk)
    y = y_intra + y_inter
    if D is not None:
        ct = _ssd_dtype(x)
        y = y + D.to(ct)[None, None, :, None] * x.to(ct)
    return y.to(x.dtype)


def ssd_chunked_grads(x, dt, A, Bm, Cm, D, dy, chunk: int = 64):
    """The plain version of the SSD scan's backward: autograd through
    :func:`ssd_chunked_ref` on f32 copies of the inputs (f64 for f64
    inputs), given dy (B,S,H,P). Returns (dx, ddt, dA, dBm, dCm, dD): dx,
    ddt, dBm and dCm rounded once to x's dtype, dA and dD in the compute
    dtype (float32), dD None when D is."""
    ct = _ssd_dtype(x)
    leaves = [t.detach().to(ct).requires_grad_()
              for t in (x, dt, A, Bm, Cm)]
    d = None if D is None else D.detach().to(ct).requires_grad_()
    with torch.enable_grad():
        y = ssd_chunked_ref(*leaves, d, chunk=chunk)
        grads = torch.autograd.grad(y, leaves + ([] if d is None else [d]),
                                    dy.to(ct))
    dx, ddt, dA, dB, dC = grads[:5]
    dt_ = x.dtype
    return (dx.to(dt_), ddt.to(dt_), dA, dB.to(dt_), dC.to(dt_),
            None if d is None else grads[5])


# pieces of one operand of the f32 kernels' bf16 tensor-core products
BWD_PIECES = (0, 1, 2, 3)


def bf16_pieces(v, pieces: int):
    """`v` as the sum of its first `pieces` bf16 pieces: p0 = bf16(v),
    p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), each residual exact in the
    working dtype. Three pieces hold an f32 value exactly (8 + 8 + 8
    significant bits); two are within 2^-16 |v| of it; one is a single
    rounding. Returns the list of pieces (``pieces = 0``: ``[v]``, the
    operand unsplit)."""
    if pieces not in BWD_PIECES:
        raise ValueError(f"pieces must be one of {BWD_PIECES}, got {pieces}")
    if pieces == 0:
        return [v]
    out, rest = [], v
    for _ in range(pieces):
        p = rest.to(torch.bfloat16).to(v.dtype)
        out.append(p)
        rest = rest - p
    return out


def _split_product(eq, a, b, pa, pb):
    """einsum(eq, a, b) as the f32 kernels' tensor cores form it: the
    sum of the products of piece a of `a` and piece b of `b` with
    a + b <= 2 (pa, pb pieces; 0 for unsplit), the smallest first."""
    ap, bp = bf16_pieces(a, pa), bf16_pieces(b, pb)
    out = None
    for s in (2, 1, 0):
        for i in range(min(s + 1, len(ap))):
            j = s - i
            if j < len(bp):
                t = torch.einsum(eq, ap[i], bp[j])
                out = t if out is None else out + t
    return out


def ssd_bwd_decomposed(x, dt, A, Bm, Cm, D, dy, in_pieces: int = 0,
                       mid_pieces: int = 0):
    """The backward kernel's decomposition (``csrc/ssd_scan_bwd.cu``'s
    note), in the inputs' dtype: (dx, ddt, dA, dBm, dCm, dD), dD None when
    D is. Each product is taken as the kernel's tensor cores take it: an
    operand that is an input (x, dy, B, C) in `in_pieces` bf16 pieces, one
    that the kernel computes in f32 (the states and their gradients, the
    weights W, dG, and the weighted rows u x, E dy of the carries) in
    `mid_pieces` (``bf16_pieces``; 0 leaves every operand unsplit, the
    plain decomposition). The kernel takes (3, 3) for f32 inputs and
    (1, 3) for bf16; (1, 1) is the single-rounding control. The chunk is
    the kernel's, ``ssd_scan.CHUNK``.

      S0 (state entering a chunk) and dS (gradient of the state leaving
      it) by the two sweeps; then per chunk and head
      G^T = B C^T, dW^T = x dy^T, L_ji = exp(cum_i - cum_j) (j <= i),
      W^T = G^T L dt_j, dG^T = dW^T L dt_j, M^T = dW^T L G^T,
      dx = W^T dy + u_j raw + D dy with raw = dS B^T (per 64-wide tile of
      N, summed), du_j = x_j . raw_j,
      dC^T += B^T dG^T + E_i (S0^T dy^T), q_i = E_i C_i . (S0^T dy^T)_i,
      dB^T += C^T dG + u_j (dS^T x^T), summed over the group's heads in
      ascending order; dcum, its suffix sums, ddt and dA as the note.
    """
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    chunk = SSD_CHUNK
    rep, NC = H // G, -(-S // chunk)
    pad = NC * chunk - S
    ct = x.dtype if x.dtype == torch.float64 else torch.float32
    pi, pm = in_pieces, mid_pieces

    def chunks(t):
        t = F.pad(t.to(ct), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(B, NC, chunk, *t.shape[2:])

    xc, dtc, dyc = chunks(x), chunks(dt), chunks(dy)
    Bc, Cc = chunks(Bm), chunks(Cm)  # (B, NC, Q, G, N)
    hg = torch.arange(H, device=x.device) // rep
    Bh, Ch = Bc[:, :, :, hg], Cc[:, :, :, hg]  # per head
    A = A.to(ct)
    cum = torch.cumsum(dtc * A, 2)  # (B, NC, Q, H)
    last = cum[:, :, -1]
    eu = torch.exp(last[:, :, None] - cum)
    u, E, el = eu * dtc, torch.exp(cum), torch.exp(last)
    # the sweeps: scale the carry by exp(last), then add the chunk's product
    S0 = torch.zeros(B, NC, H, P, N, dtype=ct, device=x.device)
    dS = torch.zeros_like(S0)
    st = torch.zeros(B, H, P, N, dtype=ct, device=x.device)
    for c in range(NC):
        S0[:, c] = st
        st = st * el[:, c, :, None, None] + _split_product(
            "bjhp,bjhn->bhpn", xc[:, c] * u[:, c, ..., None], Bh[:, c],
            pm, pi)
    st = torch.zeros_like(st)
    for c in reversed(range(NC)):
        dS[:, c] = st
        st = st * el[:, c, :, None, None] + _split_product(
            "bihp,bihn->bhpn", dyc[:, c] * E[:, c, ..., None], Ch[:, c],
            pm, pi)
    # the per-chunk terms, rows j of the transposed products
    cumh = cum.permute(0, 1, 3, 2)  # (B, NC, H, Q)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()  # [i][j], j <= i
    Lt = torch.exp(torch.where(causal.T, cumh[..., None, :]
                               - cumh[..., :, None], -math.inf))  # [j][i]
    dtj = dtc.permute(0, 1, 3, 2)[..., :, None]  # dt_j on rows j
    Gt = _split_product("bcjgn,bcign->bcgji", Bc, Cc, pi, pi)[:, :, hg]
    dWt = _split_product("bcjhp,bcihp->bchji", xc, dyc, pi, pi)
    Wt, Tt = Gt * Lt * dtj, dWt * Lt
    dGt, Mt = Tt * dtj, Tt * Gt
    dx = _split_product("bchji,bcihp->bcjhp", Wt, dyc, pm, pi)
    raw = 0
    for n0 in range(0, N, 64):
        raw = raw + _split_product("bchpn,bcjhn->bcjhp",
                                   dS[..., n0:n0 + 64],
                                   Bh[..., n0:n0 + 64], pm, pi)
    dx = dx + u[..., None] * raw
    if D is not None:
        dx = dx + D.to(ct)[:, None] * dyc
    du = (xc * raw).sum(-1)
    dCi = _split_product("bchpn,bcihp->bcihn", S0, dyc, pm, pi)
    q = E * (Ch * dCi).sum(-1)
    dBi = _split_product("bchpn,bcjhp->bcjhn", dS, xc, pm, pi)
    dCh = (_split_product("bcjhn,bchji->bcihn", Bh, dGt, pi, pm)
           + E[..., None] * dCi)
    dBh = (_split_product("bcihn,bchji->bcjhn", Ch, dGt, pi, pm)
           + u[..., None] * dBi)
    colm = Mt.sum(-1).permute(0, 1, 3, 2)  # sum_i M_ij, on rows j
    rowm = (Mt * dtj).sum(-2).permute(0, 1, 3, 2)  # sum_j M_ij dt_j
    dcum = rowm - dtc * colm + q - du * u
    dcum[:, :, -1] += (du * u).sum(2) + el * (dS * S0).sum((-1, -2))
    suffix = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = colm + du * eu + A * suffix

    def unchunk(t):
        return t.reshape(B, NC * chunk, *t.shape[3:])[:, :S]

    dB = torch.zeros(B, NC, chunk, G, N, dtype=ct, device=x.device)
    dC = torch.zeros_like(dB)
    for h in range(H):  # the group's heads, ascending
        dB[:, :, :, h // rep] += dBh[:, :, :, h]
        dC[:, :, :, h // rep] += dCh[:, :, :, h]
    return (unchunk(dx), unchunk(ddt), (dtc * suffix).sum((0, 1, 2)),
            unchunk(dB), unchunk(dC),
            None if D is None else (dyc * xc).sum((0, 1, 2, 4)))
