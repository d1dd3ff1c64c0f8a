"""The doubly-distributed mesh's summation order, reproduced on one device.

A gloo all-reduce adds the ranks' tensors in an order fixed by each
element's place in the ring (:func:`ring_sum`), not in rank order. With the
hinge loss a last-bit difference in z moves rows across the kink, so a mesh
run parts from a single-device run summed in any other order.
:func:`snapshot_gradient_in_mesh_order` is the single-device plain version
of the issue half in the mesh's order, and :func:`snapshot_as` swaps it in
for ``sodda.snapshot_gradient`` inside a block: a single-device run there
steps as the mesh does. Checks use it; no program path does.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import losses, sodda

__all__ = ["ring_sum", "snapshot_gradient_in_mesh_order", "snapshot_as"]


def ring_sum(parts):
    """The sum of `parts` (one tensor a rank, in rank order, all of one
    shape) as gloo's ring all-reduce forms it. The ring splits the
    flattened elements into W = len(parts) segments of 2 ceil(n / 2W)
    elements (the last ones shorter or empty), and segment s is summed
    sequentially from rank s - 1 downwards: ((x_{s-1} + x_{s-2}) + ...) +
    x_s, indices mod W. Measured bitwise against gloo's all_reduce on the
    CPU for W = 3, 4, 5 and n from 1 to 400 000; CUDA tensors take the same
    ring through host memory."""
    W = len(parts)
    flat = [t.reshape(-1) for t in parts]
    n = flat[0].numel()
    seg = 2 * -(-n // (2 * W))
    out = torch.empty_like(flat[0])
    for s in range(W):
        a, b = min(n, s * seg), min(n, (s + 1) * seg)
        order = [(s - 1 - i) % W for i in range(W)]
        acc = flat[order[0]][a:b]
        for r in order[1:]:
            acc = acc + flat[r][a:b]
        out[a:b] = acc
    return out.view(parts[0].shape)


def snapshot_gradient_in_mesh_order(n: int, m: int):
    """``sodda.snapshot_gradient(loss, X, y, w, sample, d_count)`` on one
    device as a gloo mesh of (N / n) x (M / m) ranks computes it: each
    tile's partial inner products X_pq (w_q * mask_b_q) on a contiguous copy
    of the tile (a rank's X_loc), summed over q by :func:`ring_sum`; each
    tile's masked partial gradient mask_c_q * X_pq^T s_p, summed over p the
    same way. The grid follows X's shape, so a rescaled run keeps it."""

    def snapshot(loss, X, y, w, sample, d_count):
        P, Q = X.shape[0] // n, X.shape[1] // m
        wq, mb, mc = w.view(Q, m), sample.mask_b.view(Q, m), \
            sample.mask_c.view(Q, m)
        md = sample.mask_d.view(P, n)
        mu_parts = [[] for _ in range(Q)]
        for p in range(P):
            rows = slice(p * n, (p + 1) * n)
            tiles = [X[rows, q * m:(q + 1) * m].contiguous() for q in range(Q)]
            z = ring_sum([tiles[q] @ (wq[q] * mb[q]) for q in range(Q)])
            s = losses.loss_deriv(loss, z, y[rows]) * md[p] / d_count
            for q in range(Q):
                mu_parts[q].append(mc[q] * (tiles[q].T @ s))
            del tiles
        return torch.cat([ring_sum(parts) for parts in mu_parts])

    return snapshot


@contextlib.contextmanager
def snapshot_as(fn):
    """Route the single-device backends' snapshot gradient (the issue half:
    two GEMVs) to fn(loss, X, y, w, sample, d_count) inside the block."""
    orig = sodda.snapshot_gradient
    sodda.snapshot_gradient = fn
    try:
        yield
    finally:
        sodda.snapshot_gradient = orig
