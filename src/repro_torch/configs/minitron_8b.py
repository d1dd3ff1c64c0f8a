"""minitron-8b: width-pruned Nemotron-4, dense decoder.

[arXiv:2407.14679; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000. The port's copy of the reference's ``configs/minitron_8b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    source="arXiv:2407.14679; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=10000.0,
)
