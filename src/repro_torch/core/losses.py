"""GLM losses for the SODDA objective F(w) = (1/N) sum_i f_i(x_i w).

Each loss is defined through the scalar margin z = x_i w and label y_i, with
value l(z, y) and derivative l'(z, y) = d l / d z, so that
grad f_i(x_i w) = l'(x_i w, y_i) * x_i. All three losses named by the paper
(hinge, logistic, squared) are provided. Counterpart of
``repro.core.losses``.
"""
from __future__ import annotations

import torch

__all__ = ["loss_value", "loss_deriv", "objective", "full_gradient", "LOSSES"]


def _hinge_value(z, y):
    return torch.clamp(1.0 - y * z, min=0.0)


def _hinge_deriv(z, y):
    # subgradient: -y where y*z < 1 else 0 (paper trains hinge-loss SVM)
    return torch.where(y * z < 1.0, -y, torch.zeros_like(y))


def _logistic_value(z, y):
    # log(1 + exp(-y z)), numerically stable
    a = -y * z
    return torch.logaddexp(torch.zeros_like(a), a)


def _logistic_deriv(z, y):
    return -y * torch.sigmoid(-y * z)


def _squared_value(z, y):
    return 0.5 * (z - y) ** 2


def _squared_deriv(z, y):
    return z - y


LOSSES = {
    "hinge": (_hinge_value, _hinge_deriv),
    "logistic": (_logistic_value, _logistic_deriv),
    "squared": (_squared_value, _squared_deriv),
}


def loss_value(name: str, z, y):
    return LOSSES[name][0](z, y)


def loss_deriv(name: str, z, y):
    return LOSSES[name][1](z, y)


def objective(name: str, X, y, w, l2: float = 0.0):
    """F(w) = mean_i l(x_i w, y_i) + (l2/2)||w||^2, a 0-d device tensor."""
    z = X @ w
    val = loss_value(name, z, y).mean()
    if l2:
        val = val + 0.5 * l2 * torch.dot(w, w)
    return val


def full_gradient(name: str, X, y, w, l2: float = 0.0):
    """grad F(w) = (1/N) X^T l'(Xw, y) + l2*w."""
    z = X @ w
    s = loss_deriv(name, z, y) / X.shape[0]
    g = X.T @ s
    if l2:
        g = g + l2 * w
    return g
