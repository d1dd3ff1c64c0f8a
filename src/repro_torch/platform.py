"""The one place that decides which device the port runs on.

Every entry point (``core.driver.run``, ``core.engine.make_step``,
``data.synthetic.make_svm_data``) resolves its ``device`` argument here.
The default is the CUDA device; a host without one raises instead of
falling back to the CPU, so a CPU run is always one the caller asked for.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device for `device` (default: the current CUDA device).

    Raises ``RuntimeError`` when CUDA is asked for, explicitly or by
    default, and no CUDA device is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_on_device(name: str, tensor: torch.Tensor,
                    device: Optional[torch.device]) -> None:
    """Raise ``ValueError`` if `tensor` does not lie on `device`."""
    if tensor.device != device:
        raise ValueError(
            f"{name} is on {tensor.device}, but this run is on {device}")
