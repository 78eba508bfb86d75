"""musicgen-large — 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Audio: the transformer backbone is modeled exactly; the EnCodec
frontend is a STUB — inputs are 4 parallel codebook token streams
(delay pattern applied upstream) whose embeddings are summed; the head
emits logits for all 4 codebooks per step.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=("full",) * 48,
    modality="audio",
    n_codebooks=4,
    source="arXiv:2306.05284; hf",
)
