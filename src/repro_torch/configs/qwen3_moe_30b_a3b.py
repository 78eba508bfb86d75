"""qwen3-moe-30b-a3b — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

Qwen3-MoE uses an explicit head_dim of 128 (q-proj 2048→4096) with
QK-norm; expert FFN width 768 with top-8 of 128 experts per layer.
This is the PRIMARY arch for the paper's technique: expert placement
(Alg. 1) + two-level dispatch (Alg. 2) — DESIGN.md §4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    layer_pattern=("full",) * 48,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
