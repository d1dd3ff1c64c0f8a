"""Plain PyTorch versions of the port's kernels (the ground truth in tests).

Counterpart of ``repro.kernels.ref``. A wrapper in ``ops`` takes these for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core import losses


def sodda_inner_ref(w0, Xl, yl, mu, gamma, loss: str = "hinge"):
    """The paper's L-step inner SVRG loop over a batch of blocks.

    w0 (..., mt), Xl (..., L, mt), yl (..., L), mu (..., mt) -> (..., mt);
    every leading index is an independent chain. Step i computes

        wbar <- wbar - gamma * [(l'(x_i.wbar) - l'(x_i.w0)) * x_i + mu]

    with both margins taken per step, as the reference does.
    """
    wbar = w0
    for i in range(Xl.shape[-2]):
        x = Xl[..., i, :]
        yy = yl[..., i]
        z1 = (x * wbar).sum(-1)
        z0 = (x * w0).sum(-1)
        c = losses.loss_deriv(loss, z1, yy) - losses.loss_deriv(loss, z0, yy)
        wbar = wbar - gamma * (c[..., None] * x + mu)
    return wbar
