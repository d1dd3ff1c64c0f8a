"""repro_torch: the PyTorch/CUDA port of the SODDA reproduction.

Module paths mirror the JAX reference package ``repro``
(``repro_torch.core.sodda`` holds the counterpart of ``repro.core.sodda``),
so each part of the port has one counterpart to be tested against. The
port imports torch and numpy only; it never imports jax or ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``repro_torch.platform``).
"""
