"""SwiGLU MLP (dense) — the FFN for every non-MoE layer. Counterpart of
``repro.models.mlp``."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def mlp_template(d_model: int, d_ff: int) -> dict:
    return {
        "wg": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wu": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wd": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_forward(p, h):
    """h (B, S, d) -> (B, S, d)."""
    g = h @ p["wg"]
    u = h @ p["wu"]
    return (F.silu(g) * u) @ p["wd"]
