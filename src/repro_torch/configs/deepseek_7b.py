"""deepseek-7b — 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400, llama-architecture.  [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11_008,
    vocab_size=102_400,
    layer_pattern=("full",) * 30,
    source="arXiv:2401.02954; hf",
)
