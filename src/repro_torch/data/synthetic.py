"""The paper's synthetic SVM dataset generator (Section 5.1, after [22]).

x_i ~ U[-1, 1]^M and a planted separator z ~ U[-1, 1]^M; labels
y_i = sgn(x_i . z) with each sign flipped independently with prob 0.01.
Features are standardized to unit variance by the empirical per-column
std. Counterpart of ``repro.data.synthetic.make_svm_data``: the same
distribution from a torch generator, not the same bits.

X is generated in place on the device in its one (N, M) buffer: no
temporary of X's size exists at any point, so the peak device memory of
generation is X plus O(N + M).
"""
from __future__ import annotations

import torch

from repro_torch.platform import resolve_device

__all__ = ["make_svm_data"]


def make_svm_data(generator: torch.Generator, N: int, M: int, device=None,
                  flip_prob: float = 0.01, standardize: bool = True):
    """Returns (X (N,M) f32, y (N,) f32 in {-1,+1}, planted z (M,)).

    `generator` must live on `device` (default: the CUDA device;
    ``RuntimeError`` without one).
    """
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, data goes to "
                         f"{device}")
    X = torch.empty(N, M, dtype=torch.float32, device=device)
    X.uniform_(-1.0, 1.0, generator=generator)
    z = torch.empty(M, dtype=torch.float32, device=device)
    z.uniform_(-1.0, 1.0, generator=generator)
    y = torch.sign(X @ z)
    y = torch.where(y == 0, torch.ones_like(y), y)
    flips = torch.rand(N, generator=generator, device=device) < flip_prob
    y = torch.where(flips, -y, y)
    if standardize:
        # U[-1,1] already has mean 0; scale to unit variance. The empirical
        # std of a constant column is 0 (N == 1 makes every column
        # constant), so degenerate columns are left unscaled instead.
        std = torch.std(X, dim=0, correction=0)
        X.div_(torch.where(std > 0, std, torch.ones_like(std)))
    return X, y, z
