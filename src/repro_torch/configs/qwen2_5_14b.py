"""qwen2.5-14b — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13_824,
    vocab_size=152_064,
    layer_pattern=("full",) * 48,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
