"""Architecture registry: the 10 assigned architectures (exact dims from
the assignment), copied from ``repro.configs``."""
from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES

from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.musicgen_large import CONFIG as _musicgen

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _qwen3_moe,
        _mixtral,
        _rgemma,
        _mamba2,
        _yi,
        _phi4,
        _qwen25,
        _deepseek,
        _llava,
        _musicgen,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCHS", "get_config"]
