"""Model zoo of the port: every config of the zoo — dense attention (full
or windowed), Mamba-2 (ssm), RG-LRU + local-attention hybrids, mixtures of
experts, and the vlm and audio front ends — for serving and training,
assembled by :mod:`repro_torch.models.lm`."""
from repro_torch.models.lm import (
    PDef,
    abstract_params,
    cache_specs,
    decode_step,
    distribute_batch,
    distribute_params,
    embed_inputs,
    forward,
    init_cache,
    init_params,
    lm_logits,
    loss_fn,
    padded_vocab,
    param_defs,
    param_specs,
    prefill,
    segments,
)

__all__ = [
    "PDef",
    "abstract_params",
    "cache_specs",
    "decode_step",
    "distribute_batch",
    "distribute_params",
    "embed_inputs",
    "forward",
    "init_cache",
    "init_params",
    "lm_logits",
    "loss_fn",
    "padded_vocab",
    "param_defs",
    "param_specs",
    "prefill",
    "segments",
]
