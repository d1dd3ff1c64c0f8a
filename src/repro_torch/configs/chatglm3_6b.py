"""chatglm3-6b: dense decoder, 2d-RoPE, extreme GQA (kv=2).

[arXiv:2406.12793; hf] 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024. ChatGLM applies RoPE to half of each head dim (2d rope) —
modeled with ``rope_fraction=0.5`` behaviour folded into the attention
layer. The port's copy of the reference's ``configs/chatglm3_6b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793; hf",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_theta=10000.0,
)
