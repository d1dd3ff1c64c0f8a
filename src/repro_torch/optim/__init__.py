"""Optimizers of the port (counterpart of ``repro.optim``): sgd, momentum,
adamw and adafactor over a parameter tree, SODDA-SVRG, and the int8 wire
compression of the mesh (``grad_compression``). ZeRO-1's ``zero1_pspecs``
waits for the mesh work (ROADMAP A6)."""
from repro_torch.optim.optimizers import (OPTIMIZERS, Optimizer, adafactor,
                                          adamw, momentum, sgd)
from repro_torch.optim.sodda_optimizer import SoddaSVRGConfig, make_sodda_svrg

__all__ = ["OPTIMIZERS", "Optimizer", "sgd", "momentum", "adamw", "adafactor",
           "make_sodda_svrg", "SoddaSVRGConfig"]
