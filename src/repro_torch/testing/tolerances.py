"""Tolerance policies: the machine-checkable equivalence contract.

The port's own copy of ``repro.testing.tolerances`` (same four policies,
same checks), so ``chip_smoke.py`` can hold the port to them on a machine
without the JAX package.

  * BITWISE        — same trace, same arithmetic: exact equality.
  * F32_REDUCTION  — same math, different reduction order / fusion (the
                     hand-written kernel against its plain version, the
                     port against the JAX reference): error bounded by a
                     small multiple of f32 epsilon times the iterate scale.
  * QUANTIZED      — int8 wire compression: objective-level contract.
  * STALENESS      — stale-by-one exchange: objective-level contract.

The first two are *trajectory* policies (``w_rel`` set); the last two are
*objective-level* policies (``w_rel=None`` disables the per-iterate check).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class TolerancePolicy(NamedTuple):
    name: str
    # trajectory contract: max_t |w_ref^t - w^t| <= w_rel * max(scale, 1)
    # where scale = max_t |w_ref^t|;  None disables the trajectory check.
    w_rel: Optional[float]
    # objective contract: |F_ref - F| <= obj_rel * max(|F_ref|, obj_floor)
    obj_rel: float
    obj_floor: float = 0.1


BITWISE = TolerancePolicy("bitwise", w_rel=0.0, obj_rel=0.0)
F32_REDUCTION = TolerancePolicy("f32-reduction", w_rel=1e-4, obj_rel=1e-4)
QUANTIZED = TolerancePolicy("int8-quantized", w_rel=None, obj_rel=0.05)
STALENESS = TolerancePolicy("stale-by-one", w_rel=None, obj_rel=0.10)


def assert_trajectories_close(ref_ws: Sequence, got_ws: Sequence,
                              policy: TolerancePolicy, context: str = ""):
    """Check the iterate trajectory contract of `policy` (see module doc)."""
    if policy.w_rel is None:
        return
    assert len(ref_ws) == len(got_ws), (len(ref_ws), len(got_ws))
    ref = [np.asarray(w) for w in ref_ws]
    got = [np.asarray(w) for w in got_ws]
    scale = max(max(float(np.max(np.abs(w))) for w in ref), 1.0)
    errs = [float(np.max(np.abs(r - g))) for r, g in zip(ref, got)]
    if policy.w_rel == 0.0:
        assert all(e == 0.0 for e in errs), (policy.name, context, errs)
    else:
        bound = policy.w_rel * scale
        assert max(errs) <= bound, (
            f"{policy.name} {context}: max traj err {max(errs):.3e} > "
            f"{bound:.3e} (scale {scale:.3e}); per-iter errs {errs}")


def assert_objectives_close(f_ref: float, f_got: float,
                            policy: TolerancePolicy, context: str = ""):
    bound = policy.obj_rel * max(abs(f_ref), policy.obj_floor)
    assert abs(f_ref - f_got) <= bound, (
        f"{policy.name} {context}: |{f_ref:.6f} - {f_got:.6f}| > {bound:.2e}")


def half_ulp_excess(oracle, scale, **outs):
    """For each bf16 output in `outs`: its largest distance to the f32
    `oracle` beyond half a bf16 ulp of the oracle, over `scale`. A
    correctly rounded output scores <= 0; a sound kernel scores at most
    its f32 summation noise."""
    exponent = torch.frexp(oracle.abs().clamp_min(2.0 ** -126))[1]
    half_ulp = torch.exp2((exponent - 9).float())  # bf16 ulp is 2^(e - 8)
    return {name: float(((o.float() - oracle).abs() - half_ulp).max()) / scale
            for name, o in outs.items()}
