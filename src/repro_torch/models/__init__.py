"""The LM stack of the port: the dense transformer (with the vlm and audio
families), MoE, SSM and hybrid families (counterpart of ``repro.models``).
``Model`` ties config, template and the serving entry points together;
``input_specs`` describes every input of a cell."""
from repro_torch.models.model import Model, input_specs

__all__ = ["Model", "input_specs"]
