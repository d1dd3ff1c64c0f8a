"""Port losses against ``repro.core.losses`` on the same numpy inputs.

Tolerances: hinge and squared are elementwise arithmetic in the same f32
operations, so they are held BITWISE; the logistic loss goes through
exp/log1p implementations of two libraries, and ``objective`` and
``full_gradient`` through matrix-vector products in another reduction
order, so those are held to F32_REDUCTION.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as ref
from repro.testing.tolerances import (F32_REDUCTION, assert_objectives_close,
                                      assert_trajectories_close)
from repro_torch.core import losses as port

LOSSES = ["hinge", "logistic", "squared"]


def _margins(seed=0, size=513):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(size) < 0.5, -1.0, 1.0).astype(np.float32)
    z = (rng.normal(size=size) * 3).astype(np.float32)
    z[:32] = y[:32]  # y*z == 1 exactly: the hinge's kink
    z[32:40] = 0.0
    return z, y


def _both(fn_ref, fn_port, *arrays):
    got = fn_port(*(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.asarray(fn_ref(*(jnp.asarray(a) for a in arrays)))
    return want, got


@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("part", ["value", "deriv"])
def test_elementwise_bitwise(loss, part):
    z, y = _margins()
    pick = {"value": (ref.loss_value, port.loss_value),
            "deriv": (ref.loss_deriv, port.loss_deriv)}[part]
    want, got = _both(lambda z_, y_: pick[0](loss, z_, y_),
                      lambda z_, y_: pick[1](loss, z_, y_), z, y)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part", ["value", "deriv"])
def test_logistic_f32_reduction(part):
    z, y = _margins(seed=1)
    pick = {"value": (ref.loss_value, port.loss_value),
            "deriv": (ref.loss_deriv, port.loss_deriv)}[part]
    want, got = _both(lambda z_, y_: pick[0]("logistic", z_, y_),
                      lambda z_, y_: pick[1]("logistic", z_, y_), z, y)
    assert_trajectories_close([want], [got], F32_REDUCTION, f"logistic {part}")


def _problem(seed, N=300, M=40):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(N, M)).astype(np.float32)
    y = np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32)
    w = (rng.normal(size=M) * 0.3).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_objective_f32_reduction(loss, l2):
    X, y, w = _problem(2)
    want, got = _both(lambda *a: ref.objective(loss, *a, l2=l2),
                      lambda *a: port.objective(loss, *a, l2=l2), X, y, w)
    assert got.shape == ()
    assert_objectives_close(float(want), float(got), F32_REDUCTION, loss)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_full_gradient_f32_reduction(loss, l2):
    X, y, w = _problem(3)
    want, got = _both(lambda *a: ref.full_gradient(loss, *a, l2=l2),
                      lambda *a: port.full_gradient(loss, *a, l2=l2), X, y, w)
    assert got.shape == want.shape == (X.shape[1],)
    assert_trajectories_close([want], [got], F32_REDUCTION, loss)
