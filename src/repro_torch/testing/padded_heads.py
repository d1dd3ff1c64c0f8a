"""The padded q heads' rows of attention gradients, for the checks that
hold the port's gradients to the reference's.

The reference zeroes a padded head's ``wo`` rows at init only, so its
gradient there is the sum over positions of out_h (x) dy, not 0
(``src/repro/models/attention.py:3-8``); the port keeps the padded heads
inert (``models.attention.inert_heads``), and its gradient of those rows is
exactly 0. With the rows masked, the reference's ``wo`` gradient is the
gradient of the unpadded function, which is what the port's must equal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import head_mask, padded_heads


def wo_leaves(tree):
    """The indices, in ``tree_leaves`` order (sorted keys), of every
    attention ``wo`` leaf of a parameter or gradient tree."""
    out, n = [], 0

    def walk(node, path):
        nonlocal n
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
            return
        if path[-2:] == ("attn", "wo"):
            out.append(n)
        n += 1

    walk(tree, ())
    return out


def padded_rows(cfg):
    """(Hp,) bool numpy: the padded q heads."""
    return head_mask(cfg).numpy() == 0


def unpadded(cfg, tree, leaves):
    """`leaves` (numpy, in `tree`'s leaf order: the reference's gradient)
    with each ``wo`` leaf's padded-head rows zeroed (the head axis is a
    ``wo`` leaf's third-last, stacked over layers or not)."""
    if padded_heads(cfg) == cfg.num_heads:
        return list(leaves)
    rows = padded_rows(cfg)
    out = list(leaves)
    for i in wo_leaves(tree):
        w = np.array(out[i])
        w[..., rows, :, :] = 0
        out[i] = w
    return out


def padded_wo_gradient(cfg, tree, leaves):
    """The largest |entry| of the padded-head rows over every ``wo`` leaf
    of `leaves` (numpy arrays or torch tensors, on any device, in `tree`'s
    leaf order); 0.0 when nothing is padded."""
    if padded_heads(cfg) == cfg.num_heads:
        return 0.0
    rows = torch.from_numpy(padded_rows(cfg))
    out = 0.0
    for i in wo_leaves(tree):
        w = leaves[i]
        if not isinstance(w, torch.Tensor):
            w = torch.tensor(np.asarray(w).astype(np.float64))
        out = max(out, float(w[..., rows.to(w.device), :, :].abs().max()))
    return out
