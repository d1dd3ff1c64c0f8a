"""RADiSA and RADiSA-avg baselines (Nathan & Klabjan 2017, paper ref [13]).

Counterpart of ``repro.core.radisa``. RADiSA is the b = c = d = 100%
special case of SODDA (exact full-gradient snapshot; paper Corollary 1).
RADiSA-avg, the variant the paper benchmarks against, has every worker
(p, q) update the *entire* local feature block w_[q] from its own
observations, with the P per-partition solutions averaged afterwards (the
combination the paper's pi-mechanism replaces).

Iteration t's row draws J are taken from a generator seeded by
``(seed, t)`` (``partition.seeded_generator``), the counterpart of the
reference's ``fold_in(key, t)``: the same distribution, not the same bits.
Tests replay the reference's J through the ``J`` argument.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import losses
from repro_torch.core.partition import seeded_generator
from repro_torch.core.sodda import (  # noqa: F401 (init_state: re-export)
    SoddaState, _gamma, init_state, inner_loop, sodda_step)
from repro_torch.kernels import ops as kops

__all__ = ["radisa_config", "radisa_step", "radisa_avg_step",
           "run_radisa_avg", "radisa_avg_iteration_flops", "init_state"]


def radisa_config(cfg: SoddaConfig) -> SoddaConfig:
    return dataclasses.replace(cfg, b_frac=1.0, c_frac=1.0, d_frac=1.0)


def radisa_step(state: SoddaState, X, y, cfg: SoddaConfig,
                use_kernel: bool = False, sample=None) -> SoddaState:
    """RADiSA = SODDA with the exact full gradient as snapshot."""
    return sodda_step(state, X, y, radisa_config(cfg), use_kernel, sample)


def radisa_avg_step(state: SoddaState, X, y, cfg: SoddaConfig,
                    use_kernel: bool = False,
                    J: Optional[torch.Tensor] = None) -> SoddaState:
    """One RADiSA-avg iteration: the exact full gradient, then for every
    worker (p, q) an L-step chain over its whole m-wide feature block from
    rows J[p, q] of partition p, then the mean over p.

    The (P, Q, L, m) working set is gathered out of X by computed indices
    (rows p*n + J[p, q], columns q*m + [0, m)), so X is never copied. With
    ``use_kernel`` the P*Q chains run through ``kops.sodda_inner`` at width
    m. ``J`` (P, Q, L) replaces the iteration's own draw.
    """
    P, Q, n, m, L, M = cfg.P, cfg.Q, cfg.n, cfg.m, cfg.L, cfg.M
    dev = X.device
    gamma = float(_gamma(cfg, state.t))
    mu = losses.full_gradient(cfg.loss, X, y, state.w, cfg.l2)

    if J is None:
        gen = seeded_generator(dev, state.seed, state.t)
        J = torch.randint(0, n, (P, Q, L), generator=gen, device=dev)
    rows = torch.arange(P, device=dev)[:, None, None] * n + J  # (P, Q, L)
    cols = (torch.arange(Q, device=dev)[:, None] * m
            + torch.arange(m, device=dev))  # (Q, m)
    Xl = X[rows[..., :, None], cols[None, :, None, :]]  # (P, Q, L, m)
    yl = y[rows]  # (P, Q, L)
    w0 = state.w.view(Q, m).expand(P, Q, m)
    mu_blk = mu.view(Q, m).expand(P, Q, m)

    if use_kernel:
        wL = kops.sodda_inner(
            w0.reshape(P * Q, m), Xl.reshape(P * Q, L, m),
            yl.reshape(P * Q, L), mu_blk.reshape(P * Q, m),
            gamma, cfg.loss).view(P, Q, m)
    else:
        wL = inner_loop(cfg.loss, w0, Xl, yl, mu_blk, gamma)
    new_w = wL.mean(dim=0).reshape(M)  # average over the P workers
    return SoddaState(w=new_w, t=state.t + 1, seed=state.seed)


def run_radisa_avg(seed: int, X, y, cfg: SoddaConfig, iters: int,
                   record_every: int = 1, **kwargs):
    """A RADiSA-avg run through the ``radisa-avg`` engine backend
    (``kwargs``: ``driver.run``'s ``device`` and ``sampler``)."""
    from repro_torch.core import driver  # local: driver builds on engine
    return driver.run(seed, (X, y), cfg, iters, "radisa-avg",
                      record_every=record_every, **kwargs)


def radisa_avg_iteration_flops(cfg: SoddaConfig) -> float:
    snapshot = 4.0 * cfg.N * cfg.M  # exact full gradient (fwd + transpose)
    inner = cfg.P * cfg.Q * cfg.L * 6.0 * cfg.m  # full m-wide blocks
    return snapshot + inner
