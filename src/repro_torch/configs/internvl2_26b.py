"""internvl2-26b: InternViT-6B vision encoder + InternLM2-20B language backbone.

[arXiv:2404.16821; hf] Backbone (modeled here): 48L d_model=6144 48H (GQA
kv=8) d_ff=16384 vocab=92553. The InternViT frontend is a STUB per the
assignment: ``input_specs()`` provides 256 precomputed patch embeddings of
width d_model which the model concatenates ahead of the text tokens. The
port's copy of the reference's ``configs/internvl2_26b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821; hf",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=10000.0,
    frontend="vision",
    frontend_tokens=256,
)
