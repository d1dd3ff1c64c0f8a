"""Mamba-2 block (SSD form): template, chunked prefill forward, O(1) decode.

Counterpart of ``repro.models.ssm``. The prefill forward runs the SSD scan
through ``kernels.ops.ssd_scan``: the hand-written kernel for CUDA
tensors, the plain chunked version (``kernels.ref.ssd_chunked_ref``, the
reference's ``ssd_chunked`` in torch) for CPU tensors. Decode is plain
torch, one step of the recurrence per token; unlike the reference it
updates the SSM state and the convolution history of its cache in place.

Over a mesh whose rules split the SSM heads over 'model' (``tp``, a
``distributed.tensor_parallel.TensorParallel`` with ``ssm_heads``) a rank
runs its heads, Megatron-style: its columns of ``wz``, ``wx``, ``wdt`` and
``conv_x`` (h through ``tp.copy``, 'ssm_in'), its ``A_log``, ``D``,
``dt_bias`` and ``norm``, its rows of ``wout`` (the output all-reduced,
'ssm_out'). ``wB``, ``wC``, ``conv_B`` and ``conv_C`` are replicated
(one B/C group): every rank computes the same B and C, and their
gradients are summed over the axis ('ssm_bc_grad'). The gated norm runs
over all the inner channels, its sum of squares all-reduced forward and
backward ('ssm_norm'). In decode the convolution history stays whole on
every rank (the cache's spec), so each step gathers the rank's new x
channels ('ssm_conv').
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamSpec

G = 1  # ssm groups (mamba2-130m and zamba2 both use 1 B/C group)


def ssm_template(cfg: ArchConfig) -> dict:
    d, di, N, nh, k = (cfg.d_model, cfg.ssm_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv)
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, G * N), ("embed", None)),
        "wC": ParamSpec((d, G * N), ("embed", None)),
        "wdt": ParamSpec((d, nh), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((k, di), (None, "ssm_inner"), scale=0.5),
        "conv_B": ParamSpec((k, G * N), (None, None), scale=0.5),
        "conv_C": ParamSpec((k, G * N), (None, None), scale=0.5),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "wout": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w):
    """Depthwise causal conv: x (B,S,C), w (k,C) via k shifted adds (not
    ``F.conv1d``, which cuDNN would take in TF32)."""
    k = w.shape[0]
    out = x * w[k - 1]
    for i in range(k - 1):
        shift = k - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, : x.shape[1]] * w[i]
    return out


def ssd_chunked(x, dt, A, Bm, Cm, D=None, chunk: int = 256,
                force: str = "auto"):
    """Chunked SSD. x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N).

    The reference's contract: S is a multiple of `chunk`. `force` goes to
    ``kernels.ops.ssd_scan``.
    """
    S = x.shape[1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of "
                         f"chunk={chunk}")
    return kops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, force=force)


def ssm_forward(p, h, cfg: ArchConfig, chunk: int = 256, force: str = "auto",
                tp=None, pieces=None):
    """Prefill forward. h (B,S,d) -> (B,S,d). With `tp` (the heads split
    over 'model') `p` holds the rank's heads and the output is summed over
    the axis; `pieces` wraps the local work before the norm's all-reduce
    (the "collectives" remat checkpoints it)."""
    gated = _gated if pieces is None else pieces(_gated)
    y = rms_norm(gated(p, h, cfg, chunk, force, tp), p["norm"], cfg.norm_eps,
                 tp)
    out = y @ p["wout"]
    return out if tp is None else tp.reduce(out, "ssm_out")


def gather_heads(p, cfg: ArchConfig, tp):
    """An SSM layer's parameters `p` with every leaf the rules split over
    'model' (the inner channels' and the heads') gathered whole over the
    axis, its gradient reduce-scattered back ('ssm_weights',
    ``tp.gather_model``); the replicated leaves as they are. Run when a
    rank's rows lie over 'model' (its own rows on every head)."""
    out = dict(p)
    for k, spec in ssm_template(cfg).items():
        for dim, ax in enumerate(spec.axes):
            if ax in ("ssm_inner", "ssm_heads"):
                out[k] = tp.gather_model(p[k], dim, "ssm_weights")
    return out


def _gated(p, h, cfg: ArchConfig, chunk: int, force: str, tp):
    """``ssm_forward``'s work before the norm, over the heads `p` holds:
    the scan's output gated by silu(z), (B, S, those inner channels)."""
    N, hd = cfg.ssm_state, cfg.ssm_head_dim
    B, S, _ = h.shape
    bc = (lambda w: w) if tp is None else tp.bc_weight
    if tp is not None:
        h = tp.copy(h, "ssm_in")
    z = h @ p["wz"]
    xs = h @ p["wx"]
    Bc = h @ bc(p["wB"])
    Cc = h @ bc(p["wC"])
    dt = h @ p["wdt"]
    xs = F.silu(_causal_conv(xs, p["conv_x"]))
    Bc = F.silu(_causal_conv(Bc, bc(p["conv_B"])))
    Cc = F.silu(_causal_conv(Cc, bc(p["conv_C"])))
    dt = F.softplus(dt + p["dt_bias"].to(dt.dtype))
    nh = dt.shape[-1]
    A = -torch.exp(p["A_log"].float())
    # the kernel's operands whole and contiguous at the rank's head count
    y = ssd_chunked(xs.reshape(B, S, nh, hd).contiguous(), dt.contiguous(),
                    A.contiguous(), Bc.reshape(B, S, G, N),
                    Cc.reshape(B, S, G, N), p["D"].float().contiguous(),
                    chunk=chunk, force=force)
    return y.reshape(B, S, nh * hd) * F.silu(z)


# ---------------------------------------------------------------------------
# Decode: O(1) state update per token
# ---------------------------------------------------------------------------
def ssm_cache_template(cfg: ArchConfig, batch: int, device=None,
                       layers: tuple = (), tp=None) -> dict:
    """A zeroed cache, f32 whatever the parameter dtype: {'state':
    (*layers,B,nh,hd,N), 'conv': (*layers,B,k-1,di+2GN)}; `layers` is
    () for one layer, (L,) for a model. With `tp` splitting the heads the
    state holds the rank's nh / model heads (the conv history stays
    whole: its spec replicates it)."""
    di, N, nh, hd, k = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                        cfg.ssm_head_dim, cfg.ssm_conv)
    if tp is not None and tp.ssm_heads:
        nh //= tp.size
    C = di + 2 * G * N
    f32 = torch.float32
    return {"state": torch.zeros((*layers, batch, nh, hd, N), dtype=f32,
                                 device=device),
            "conv": torch.zeros((*layers, batch, k - 1, C), dtype=f32,
                                device=device)}


def ssm_decode_step(p, h, cfg: ArchConfig, cache, tp=None):
    """h (B,1,d); cache {'state': (B,nh,hd,N), 'conv': (B,k-1,di+2GN)}.

    Returns (out (B,1,d), cache); the cache's tensors are updated in place.
    With `tp` (the heads split over 'model') `p` and the state hold the
    rank's heads, the conv history all the channels (the rank's new x
    channels gathered over the axis, 'ssm_conv'), and the output is
    summed over the axis.
    """
    di, N, hd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_head_dim
    B = h.shape[0]
    x1 = h[:, 0]
    z = x1 @ p["wz"]
    x_new = x1 @ p["wx"]  # (B, the inner channels p holds)
    n_loc = x_new.shape[-1]
    if tp is not None:
        x_new = tp.gather(x_new, 1, "ssm_conv")
    raw = torch.cat([x_new, x1 @ p["wB"], x1 @ p["wC"]], -1)  # (B,C)
    hist = torch.cat([cache["conv"].to(raw.dtype), raw[:, None]], 1)  # (B,k,C)
    mine = hist
    if tp is not None:  # the rank's x channels and every B/C channel
        lo = tp.rank * n_loc
        mine = torch.cat([hist[..., lo:lo + n_loc], hist[..., di:]], -1)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], -1)  # (k,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", mine, conv_w))
    xs, Bc, Cc = torch.split(conv_out, [n_loc, G * N, G * N], dim=-1)
    dt = F.softplus(x1 @ p["wdt"] + p["dt_bias"].to(x1.dtype))  # (B,nh)
    nh = dt.shape[-1]
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt.float() * A)  # (B,nh)
    xh = xs.reshape(B, nh, hd).float()
    Bh = Bc.reshape(B, G, N).repeat_interleave(nh // G, 1).float()
    Ch = Cc.reshape(B, G, N).repeat_interleave(nh // G, 1).float()
    state = cache["state"]
    state.mul_(decay[..., None, None]).add_(
        (dt.float()[..., None] * xh)[..., None] * Bh[:, :, None])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) \
        + p["D"].float()[None, :, None] * xh
    y = y.reshape(B, n_loc)
    y = rms_norm(y * F.silu(z).float(), p["norm"], cfg.norm_eps, tp)
    out = (y @ p["wout"].to(y.dtype)).to(h.dtype)
    if tp is not None:
        out = tp.reduce(out, "ssm_out")
    cache["conv"].copy_(hist[:, 1:])
    return out[:, None], cache
