"""phi3-mini-3.8b: dense decoder with RoPE + SwiGLU + GQA.

[arXiv:2404.14219; unverified] 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064. The port's copy of the reference's ``configs/phi3_mini.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219; unverified",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
)
