"""mamba2-130m: attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified] 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128. Standard mamba2 hyperparameters: expand=2 (d_inner=1536),
head_dim=64 (24 ssm heads), conv=4, chunk=256. Embeddings tied. The port's
copy of the reference's ``configs/mamba2_130m.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
