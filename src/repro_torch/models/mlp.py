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


def mlp_forward(p, h, tp=None):
    """h (B, S, d) -> (B, S, d). With `tp` (a
    ``distributed.tensor_parallel.TensorParallel``) the hidden dim is split
    over the 'model' axis: `wg` and `wu` are the rank's columns, `wd` its
    rows (column-parallel in, row-parallel out), h's gradient is summed
    over the axis, and the output is the rank's partial sum, which the
    caller all-reduces (``tp.reduce``)."""
    if tp is not None:
        h = tp.copy(h, "mlp_in")
    g = h @ p["wg"]
    u = h @ p["wu"]
    return (F.silu(g) * u) @ p["wd"]
