"""yi-34b — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-architecture GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    layer_pattern=("full",) * 60,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf",
)
