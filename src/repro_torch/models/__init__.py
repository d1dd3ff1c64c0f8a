"""The LM stack of the port: dense transformer and SSM families
(counterpart of ``repro.models``). ``Model`` ties config, template and the
serving entry points together."""
from repro_torch.models.model import Model

__all__ = ["Model"]
