"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA.  [arXiv:2401.04088; hf]

Sliding-window attention (window 4096) per the assignment's SWA note;
8 experts is below the 16-way model axis so experts are tensor-parallel
(TP-MoE) rather than expert-parallel — DESIGN.md §Arch-applicability.
SWA bounds the KV cache, so long_500k decode runs for this arch.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    layer_pattern=("swa",) * 56,
    n_experts=8,
    top_k=2,
    window=4_096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)
