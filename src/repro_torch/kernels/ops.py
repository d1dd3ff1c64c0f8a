"""Dispatching wrappers for the port's kernels.

Counterpart of ``repro.kernels.ops``. A CUDA tensor launches the
hand-written kernel or raises; a CPU tensor takes the plain PyTorch version
in ``ref``. There is no fallback from a failed launch, and no 128-lane
padding: that is a TPU rule, and the CUDA kernel masks its own tail.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.sodda_inner import sodda_inner_cuda

FORCES = ("auto", "cuda", "ref")


def sodda_inner(w0, Xl, yl, mu, gamma, loss: str = "hinge",
                force: str = "auto"):
    """Batched SODDA inner loop. w0 (B,mt), Xl (B,L,mt), yl (B,L), mu (B,mt).

    ``force="auto"`` launches the CUDA kernel for CUDA tensors and runs
    :func:`ref.sodda_inner_ref` for CPU tensors; ``"cuda"`` requires CUDA
    tensors; ``"ref"`` runs the plain version on any device.
    ``sodda_inner.launches`` counts kernel launches.
    """
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    device = Xl.device.type
    if force == "ref" or (force == "auto" and device == "cpu"):
        return ref.sodda_inner_ref(w0, Xl, yl, mu, gamma, loss)
    if device != "cuda":
        raise RuntimeError(f"sodda_inner(force={force!r}) launches the CUDA "
                           f"kernel and needs CUDA tensors, got {Xl.device}")
    out = sodda_inner_cuda(w0, Xl, yl, mu, gamma, loss)
    sodda_inner.launches += 1
    return out


sodda_inner.launches = 0
