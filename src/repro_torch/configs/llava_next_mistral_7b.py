"""llava-next-mistral-7b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

VLM: the Mistral-7B backbone is modeled exactly; the vision frontend is
a STUB per the assignment — ``input_specs()`` supplies 576 precomputed
CLIP patch embeddings (one anyres base tile) that are prepended to the
text-token embeddings inside the model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    layer_pattern=("full",) * 32,
    modality="vlm",
    vision_tokens=576,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
