"""recurrentgemma-9b — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention 1:2.  [arXiv:2402.19427; unverified]

Griffin pattern: repeating (rglru, rglru, local) — two recurrent blocks
per local-attention block; 38 layers = 12 full triplets + one (rglru,
rglru) tail.  Local window 2048, lru_width = d_model.  Bounded state ⇒
long_500k decode runs.
"""
from repro_torch.configs.base import ArchConfig

_PATTERN = ("rglru", "rglru", "local") * 12 + ("rglru", "rglru")

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    layer_pattern=_PATTERN,
    local_window=2_048,
    lru_width=4_096,
    source="arXiv:2402.19427; unverified",
)
