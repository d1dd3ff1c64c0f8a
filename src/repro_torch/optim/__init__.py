"""Optimizers of the port (counterpart of ``repro.optim``): sgd, momentum,
adamw and adafactor over a parameter tree, SODDA-SVRG, and the int8 wire
compression of the mesh (``grad_compression``), and ZeRO-1
(``zero1_pspecs``, the state's layout; ``zero1``, the split update over a
mesh of ranks, for sgd, momentum and adamw; ``adafactor(mesh=,
zero1=)``, its factored moments over a mesh of ranks)."""
from repro_torch.optim.optimizers import (OPTIMIZERS, Optimizer, adafactor,
                                          adamw, momentum, sgd)
from repro_torch.optim.sodda_optimizer import SoddaSVRGConfig, make_sodda_svrg

__all__ = ["OPTIMIZERS", "Optimizer", "sgd", "momentum", "adamw", "adafactor",
           "make_sodda_svrg", "SoddaSVRGConfig"]
