"""Doubly-distributed grid partitioning and the pi_q block-assignment maps.

The data matrix X (N, M) is split into P observation partitions (rows) and
Q feature partitions (columns); each feature partition is further divided
into P sub-blocks of width m_tilde = M/(Q P). Worker (p, q) owns tile
x^{p,q} and, in iteration t, updates the parameter sub-block
w_{q, pi_q(p)} — pi_q is a permutation of {0..P-1} so exactly one worker
touches each sub-block (conflict-free concatenation, paper step 19).
Counterpart of ``repro.core.partition``.

Randomness: iteration t's sample is drawn from a ``torch.Generator``
seeded from ``(seed, t)`` alone, so sample t is a pure function of
``(seed, t)`` as the reference's ``fold_in(key, t)`` makes it. It draws the
same distribution as the reference, not the same bits; tests that need the
reference's exact draw pass it in through :func:`sample_from_numpy`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "block_col_start",
    "blocks_view",
    "sample_iteration",
    "sample_from_numpy",
    "seeded_generator",
    "IterationSample",
]


def block_col_start(q: int, k, m: int, m_tilde: int):
    """Global column index where sub-block (q, k) starts."""
    return q * m + k * m_tilde


def blocks_view(X, P: int, Q: int):
    """View X (N, M) as (P, Q*P, n, m_tilde): [p, q*P+k] is x^{p,q,k}.

    A strided view, never a copy: calling ``.contiguous()`` or ``.reshape``
    on it copies all of X.
    """
    N, M = X.shape
    n, mt = N // P, M // (Q * P)
    return X.view(P, n, Q * P, mt).permute(0, 2, 1, 3)


class IterationSample(NamedTuple):
    """All randomness of one SODDA outer iteration."""

    mask_b: torch.Tensor  # (M,) f32 — features entering the inner products
    mask_c: torch.Tensor  # (M,) f32 — gradient coordinates computed (C ⊆ B)
    mask_d: torch.Tensor  # (N,) f32 — observations used for the snapshot
    pi: torch.Tensor  # (Q, P) int64 — block assignment
    J: torch.Tensor  # (P, Q, L) int64 — inner-loop local row draws


def _exact_count_mask(u, count: int):
    """Mask selecting exactly `count` entries along the last axis of `u`:
    those with the `count` smallest values.

    Equivalent in distribution to sampling `count` elements without
    replacement (paper steps 5-7); ranking one u twice gives C^t ⊆ B^t.
    Ranks break ties by position, so the count is exact even for equal u's.
    """
    if count >= u.shape[-1]:
        return torch.ones_like(u)
    idx = torch.argsort(u, dim=-1, stable=True)[..., :count]
    return torch.zeros_like(u).scatter_(-1, idx, 1.0)


def _iteration_seed(seed: int, t: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, t)
    (splitmix64 finalizer over the pair)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(t)) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) >> 1


def seeded_generator(device, seed: int, *coords: int) -> torch.Generator:
    """A generator on `device` seeded by a pure function of ``(seed,
    *coords)``: :func:`_iteration_seed` folded over the coordinates, the
    counterpart of nested ``fold_in``."""
    for c in coords:
        seed = _iteration_seed(seed, c)
    return torch.Generator(device=device).manual_seed(seed)


def sample_iteration(seed: int, t: int, P: int, Q: int, n: int, M: int,
                     L: int, b_count: int, c_count: int, d_count_local: int,
                     device) -> IterationSample:
    """Draw (B^t, C^t, D^t, pi, J) for outer iteration t on `device`.

    D^t is stratified per observation partition (d_count_local rows each),
    as in the reference. Everything is drawn on `device` from one generator
    seeded by ``(seed, t)``; nothing synchronises with the host.
    """
    gen = seeded_generator(device, seed, t)
    u = torch.rand(M, generator=gen, device=device)
    mask_b = _exact_count_mask(u, b_count)
    mask_c = _exact_count_mask(u, c_count)  # nested: C ⊆ B
    ud = torch.rand(P, n, generator=gen, device=device)
    mask_d = _exact_count_mask(ud, d_count_local).reshape(P * n)
    pi = torch.argsort(torch.rand(Q, P, generator=gen, device=device), dim=1)
    J = torch.randint(0, n, (P, Q, L), generator=gen, device=device)
    return IterationSample(mask_b, mask_c, mask_d, pi, J)


def sample_from_numpy(mask_b, mask_c, mask_d, pi, J, device) -> IterationSample:
    """An :class:`IterationSample` on `device` from numpy arrays, such as
    the fields of a sample the JAX reference drew (the replay seam)."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    return IterationSample(f32(mask_b), f32(mask_c), f32(mask_d), i64(pi),
                           i64(J))
