"""mamba2-1.3b — 48L d_model=2048 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]

Pure SSM stack: d_inner = 2·d_model = 4096, head_dim 64 ⇒ 64 SSD heads,
one B/C group, conv kernel 4.  Mamba-2 blocks have no separate MLP
(d_ff = 0).  Constant state ⇒ long_500k decode runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("ssm",) * 48,
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    conv_kernel=4,
    source="arXiv:2405.21060; unverified",
)
