"""Sharding policies (DP/FSDP/TP/EP role resolution) and the optional
GPipe pipeline-parallel schedule."""
from repro_torch.sharding.policies import ShardingPolicy, make_policy
from repro_torch.sharding.pipeline import bubble_fraction, gpipe

__all__ = ["ShardingPolicy", "make_policy", "gpipe", "bubble_fraction"]
