"""Model zoo of the port: text LMs without experts — dense attention
(full or windowed), Mamba-2 (ssm) and RG-LRU + local-attention hybrids —
for serving and training, assembled by :mod:`repro_torch.models.lm`."""
from repro_torch.models.lm import (
    PDef,
    abstract_params,
    check_supported,
    decode_step,
    embed_inputs,
    forward,
    init_cache,
    init_params,
    lm_logits,
    loss_fn,
    padded_vocab,
    param_defs,
    prefill,
    segments,
)

__all__ = [
    "PDef",
    "abstract_params",
    "check_supported",
    "decode_step",
    "embed_inputs",
    "forward",
    "init_cache",
    "init_params",
    "lm_logits",
    "loss_fn",
    "padded_vocab",
    "param_defs",
    "prefill",
    "segments",
]
