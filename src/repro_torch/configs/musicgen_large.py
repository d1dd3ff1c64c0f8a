"""musicgen-large: decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf] 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048. The EnCodec frontend is a STUB: tokens ARE the codec codes, so
``input_specs`` provides int32 token ids directly (no extra embedding stub
needed). The port's copy of the reference's ``configs/musicgen_large.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284; hf",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10000.0,
)
