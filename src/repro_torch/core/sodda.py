"""SODDA — StOchastic Doubly Distributed Algorithm (paper Algorithm 1).

Single-device implementation on torch tensors, batched over the (P, Q)
worker grid. Counterpart of ``repro.core.sodda``; the inner loop runs
either as plain PyTorch (``inner_loop``) or through the hand-written CUDA
kernel behind ``repro_torch.kernels.ops.sodda_inner``.

The outer-iteration counter ``t`` lives on the host, so the step size
gamma_t is computed there in float32 (bitwise the reference's on-device
value) and the step never synchronises with the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.sodda_svm import SoddaConfig
from repro_torch.core import losses
from repro_torch.core.partition import (IterationSample, block_col_start,
                                        sample_iteration)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.platform import resolve_device

__all__ = ["SoddaState", "AsyncSoddaState", "SoddaRecord",
           "AsyncSoddaRecord", "init_state", "init_async_state",
           "state_from_numpy", "async_state_from_numpy", "seed_key",
           "key_seed", "carry_record", "carry_from_record", "record_template",
           "sodda_step", "sodda_step_async", "consume_update",
           "snapshot_gradient", "inner_loop", "iteration_flops"]


class SoddaState(NamedTuple):
    w: torch.Tensor  # (M,) current iterate, on the device
    t: int  # 1-based outer iteration (for gamma_t), on the host
    seed: int  # base seed: iteration t's sample is drawn from (seed, t)


class AsyncSoddaState(NamedTuple):
    """The carry of the stale-by-one ``async`` backend: the
    :class:`SoddaState` fields plus the double-buffered exchange vector.
    ``mu`` holds the snapshot gradient *issued* during outer iteration t-1
    (at w^{t-1} under the t-1 sample); iteration t's inner loops consume it
    while issuing the iteration-t exchange into the next carry."""

    w: torch.Tensor  # (M,) current iterate, on the device
    t: int  # 1-based outer iteration, on the host
    seed: int  # base seed
    mu: torch.Tensor  # (M,) exchange buffer issued one iteration earlier

    def sync_state(self) -> SoddaState:
        """Drop the exchange buffer (the driver's finalize half)."""
        return SoddaState(w=self.w, t=self.t, seed=self.seed)


def init_state(seed: int, M: int, device) -> SoddaState:
    return SoddaState(w=torch.zeros(M, dtype=torch.float32, device=device),
                      t=1, seed=int(seed))


def state_from_numpy(w, t, seed: int = 0, device=None) -> SoddaState:
    """A :class:`SoddaState` from a reference state's ``w`` and ``t``
    (numpy arrays or numbers). The reference's PRNG key has no torch
    counterpart; the port's own draws come from ``seed``."""
    return SoddaState(
        w=torch.tensor(np.asarray(w, np.float32),
                   device=resolve_device(device)),
        t=int(t), seed=int(seed))


def async_state_from_numpy(w, t, mu, seed: int = 0,
                           device=None) -> AsyncSoddaState:
    """An :class:`AsyncSoddaState` from a reference carry's ``w``, ``t`` and
    ``mu`` (numpy arrays or numbers); the port's own draws come from
    ``seed``, as in :func:`state_from_numpy`."""
    state = state_from_numpy(w, t, seed, device)
    return AsyncSoddaState(
        w=state.w, t=state.t, seed=state.seed,
        mu=torch.tensor(np.asarray(mu, np.float32), device=state.w.device))


# ---------------------------------------------------------------------------
# The carry as a checkpoint holds it: the reference's fields, in its order.
#
# A checkpoint shared across the two packages carries *state*, not draws:
# the iterate, the step counter, the base key and (async) the exchange
# buffer. The port draws iteration t's sample from (seed, t) through torch
# generators, the reference from its key through threefry, so a run
# continued in the other package is a valid SODDA run from that state but
# not the same trajectory unless its draws are replayed (``sampler``).
# ---------------------------------------------------------------------------
class SoddaRecord(NamedTuple):
    """A :class:`SoddaState` as the reference's ``SoddaState`` stores it:
    leaves ``.w`` (M,) f32, ``.t`` int32 and ``.key`` uint32 (2,)."""

    w: np.ndarray
    t: np.int32
    key: np.ndarray


class AsyncSoddaRecord(NamedTuple):
    """An :class:`AsyncSoddaState` as the reference's ``AsyncSoddaState``
    stores it: :class:`SoddaRecord`'s leaves plus ``.mu`` (M,) f32."""

    w: np.ndarray
    t: np.int32
    key: np.ndarray
    mu: np.ndarray


def seed_key(seed: int) -> np.ndarray:
    """The reference's base key of the port's `seed`: ``[0, seed]`` as
    uint32, exactly ``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32.
    PRNGKey truncates a larger seed (``PRNGKey(2**40 + 3)`` is ``[0, 3]``),
    so such a seed has no key of its own and is refused."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(
            f"seed {seed} has no reference key: a checkpointed run needs "
            "0 <= seed < 2**32 (PRNGKey keeps only the low 32 bits)")
    return np.array([0, seed], dtype=np.uint32)


def key_seed(key) -> int:
    """The port's seed of a reference base key ``[0, seed]``. A key whose
    first word is nonzero (a ``split`` or ``fold_in`` key) is no
    ``PRNGKey(seed)`` and is refused."""
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(
            f"expected a uint32 (2,) PRNG key, got {key.dtype} {key.shape}")
    if int(key[0]) != 0:
        raise ValueError(
            f"key {key.tolist()} is not PRNGKey(seed) for any seed (its "
            "first word is nonzero): the port has no seed for it")
    return int(key[1])


def carry_record(carry):
    """The checkpoint record of a ``SoddaState`` or ``AsyncSoddaState``."""
    w = carry.w.detach().cpu().numpy()
    t, key = np.int32(carry.t), seed_key(carry.seed)
    if isinstance(carry, AsyncSoddaState):
        return AsyncSoddaRecord(w=w, t=t, key=key,
                                mu=carry.mu.detach().cpu().numpy())
    return SoddaRecord(w=w, t=t, key=key)


def record_template(extended: bool):
    """The structure of a carry's record (values unused): with ``mu`` for
    the stale-by-one carry when `extended`."""
    zeros = np.zeros(0, np.float32)
    base = dict(w=zeros, t=np.int32(0), key=seed_key(0))
    return AsyncSoddaRecord(mu=zeros, **base) if extended \
        else SoddaRecord(**base)


def carry_from_record(record, device):
    """The carry a record holds, on `device`: ``t`` a Python int, the seed
    from the key (:func:`key_seed`)."""
    seed = key_seed(record.key)
    if isinstance(record, AsyncSoddaRecord):
        return async_state_from_numpy(record.w, record.t, record.mu, seed,
                                      device)
    return state_from_numpy(record.w, record.t, seed, device)


# ---------------------------------------------------------------------------
# Step 8: stochastic snapshot gradient
#   mu^t = (1/d^t) sum_{j in D^t} bar_grad_{w_{C^t}} f_j(x_j^{B^t} w_{B^t})
# Two GEMVs over the whole of X (cuBLAS through torch on the card).
# ---------------------------------------------------------------------------
def snapshot_gradient(loss: str, X, y, w, sample: IterationSample,
                      d_count: int):
    zb = X @ (w * sample.mask_b)  # inner products restricted to B^t
    s = losses.loss_deriv(loss, zb, y) * sample.mask_d / d_count
    return sample.mask_c * (X.T @ s)  # coordinates restricted to C^t


# ---------------------------------------------------------------------------
# Steps 13-17: the L-step inner loop on one sub-block (paper step 16):
#   wbar <- wbar - gamma * [ l'(x.wbar) x - l'(x.w0) x + mu_blk ]
# ---------------------------------------------------------------------------
def inner_loop(loss: str, w0, Xl, yl, mu_blk, gamma):
    """w0 (..., mt), Xl (..., L, mt), yl (..., L), mu_blk (..., mt)
    -> (..., mt); each leading index is an independent chain."""
    return kref.sodda_inner_ref(w0, Xl, yl, mu_blk, gamma, loss)


# ---------------------------------------------------------------------------
# One full outer iteration (paper steps 5-19)
# ---------------------------------------------------------------------------
def _counts(cfg: SoddaConfig):
    b = max(1, int(round(cfg.b_frac * cfg.M)))
    c = max(1, min(b, int(round(cfg.c_frac * cfg.M))))
    d_local = max(1, int(round(cfg.d_frac * cfg.n)))
    return b, c, d_local


def _gamma(cfg: SoddaConfig, t: int) -> np.float32:
    """gamma_t in float32, computed on the host exactly as the reference
    computes it on the device: f32(lr0) / (1 + sqrt(f32(max(t-1, 0))))."""
    if cfg.constant_lr > 0:
        return np.float32(cfg.constant_lr)
    return np.float32(cfg.lr0) / (
        np.float32(1.0) + np.sqrt(np.float32(max(t - 1, 0))))


def _issue(cfg: SoddaConfig, X, y, w, t: int, seed: int,
           sample: Optional[IterationSample] = None):
    """The issue half of iteration t: draw the sample (unless `sample` is
    given) and compute the exchange. One definition shared by the
    synchronous step, the async step and the async warm-up: the first async
    iteration is synchronous only because all three issue identically."""
    b_count, c_count, d_local = _counts(cfg)
    if sample is None:
        sample = sample_iteration(seed, t, cfg.P, cfg.Q, cfg.n, cfg.M, cfg.L,
                                  b_count, c_count, d_local, X.device)
    return sample, snapshot_gradient(cfg.loss, X, y, w, sample,
                                     cfg.P * d_local)


def consume_update(X, y, w, mu, smp: IterationSample, gamma,
                   cfg: SoddaConfig, use_kernel: bool = False):
    """Steps 10-19 — the *consume* half of an outer iteration.

    Gathers the per-(p, q) working sets for the iteration's sample, runs the
    L-step inner loops against the exchange vector ``mu`` (fresh in the
    synchronous step, one iteration stale in the async one), and concatenates
    the updated sub-blocks into the new iterate.

    The (P, Q, L, m_tilde) working set is gathered straight out of X with
    computed indices — row p*n + J[p, q], columns q*m + pi[q, p]*m_tilde +
    [0, m_tilde) — so no view of X is ever copied (a reshape of the
    reference's (P, QP, n, m_tilde) transpose would copy all of X).
    """
    P, Q, n, m, L, M = cfg.P, cfg.Q, cfg.n, cfg.m, cfg.L, cfg.M
    mt = cfg.m_tilde
    dev = X.device
    p_ar = torch.arange(P, device=dev)
    q_ar = torch.arange(Q, device=dev)

    # gather per-(p,q) working sets ----------------------------------------
    k = smp.pi.T  # (P, Q): sub-block k = pi_q(p) of worker (p, q)
    rows = p_ar[:, None, None] * n + smp.J  # (P, Q, L) global rows
    col0 = block_col_start(q_ar[None, :], k, m, mt)  # (P, Q)
    cols = col0[..., None] + torch.arange(mt, device=dev)  # (P, Q, mt)
    Xl = X[rows[..., :, None], cols[..., None, :]]  # (P, Q, L, mt)
    yl = y[rows]  # (P, Q, L)
    wb = w.view(Q, P, mt)
    w0 = wb[q_ar[None, :], k]  # (P, Q, mt)
    mu_blk = mu.view(Q, P, mt)[q_ar[None, :], k]

    if use_kernel:
        wL = kops.sodda_inner(
            w0.reshape(P * Q, mt), Xl.reshape(P * Q, L, mt),
            yl.reshape(P * Q, L), mu_blk.reshape(P * Q, mt),
            gamma, cfg.loss).view(P, Q, mt)
    else:
        wL = inner_loop(cfg.loss, w0, Xl, yl, mu_blk, gamma)

    # step 19: conflict-free concatenation — each (q, pi_q(p)) written once
    new_wb = wb.clone()
    new_wb[q_ar.repeat_interleave(P), smp.pi.reshape(-1)] = (
        wL.transpose(0, 1).reshape(Q * P, mt))
    return new_wb.view(M)


def sodda_step(state: SoddaState, X, y, cfg: SoddaConfig,
               use_kernel: bool = False,
               sample: Optional[IterationSample] = None) -> SoddaState:
    """One outer iteration. ``sample`` replaces the iteration's own draw
    (tests feed the reference's sample through it)."""
    t = state.t
    sample, mu = _issue(cfg, X, y, state.w, t, state.seed, sample)
    w_new = consume_update(X, y, state.w, mu, sample, float(_gamma(cfg, t)),
                           cfg, use_kernel)
    return SoddaState(w=w_new, t=t + 1, seed=state.seed)


# ---------------------------------------------------------------------------
# Stale-by-one outer iteration: the 'async' engine backend. Iteration t
# consumes the exchange issued at t-1 and issues its own for t+1, so on a
# mesh the issue half (the snapshot-gradient reduction) would have no
# consumer in its own iteration.
# ---------------------------------------------------------------------------
def sodda_step_async(carry: AsyncSoddaState, X, y, cfg: SoddaConfig,
                     staleness: int = 1, use_kernel: bool = False,
                     sample: Optional[IterationSample] = None
                     ) -> AsyncSoddaState:
    """One stale-by-one outer iteration on the extended carry: issue this
    iteration's exchange from the current iterate, run the inner loops
    against ``carry.mu``. ``staleness=0`` consumes the just-issued buffer
    instead, which is :func:`sodda_step`'s arithmetic, bitwise. ``sample``
    replaces the iteration's own draw."""
    t = carry.t
    sample, mu_issued = _issue(cfg, X, y, carry.w, t, carry.seed, sample)
    mu_consumed = carry.mu if staleness else mu_issued
    w_new = consume_update(X, y, carry.w, mu_consumed, sample,
                           float(_gamma(cfg, t)), cfg, use_kernel)
    return AsyncSoddaState(w=w_new, t=t + 1, seed=carry.seed, mu=mu_issued)


def init_async_state(state: SoddaState, X, y, cfg: SoddaConfig,
                     sample: Optional[IterationSample] = None
                     ) -> AsyncSoddaState:
    """The warm-up (the driver's carry-init half): issue the exchange for
    iteration ``state.t`` (under `sample` when given) so the first consume
    sees a valid buffer. The iterate has not moved yet, so the first async
    iteration is synchronous; staleness begins at the second."""
    _, mu = _issue(cfg, X, y, state.w, state.t, state.seed, sample)
    return AsyncSoddaState(w=state.w, t=state.t, seed=state.seed, mu=mu)


# ---------------------------------------------------------------------------
# Analytic per-iteration cost (gradient-coordinate evaluations).
# ---------------------------------------------------------------------------
def iteration_flops(cfg: SoddaConfig, exact_snapshot: bool = False) -> float:
    b = 1.0 if exact_snapshot else cfg.b_frac
    c = 1.0 if exact_snapshot else cfg.c_frac
    d = 1.0 if exact_snapshot else cfg.d_frac
    snapshot = 2.0 * d * cfg.N * (b * cfg.M) + 2.0 * d * cfg.N * (c * cfg.M)
    inner = cfg.P * cfg.Q * cfg.L * 6.0 * cfg.m_tilde
    return snapshot + inner
