"""Deterministic synthetic data pipeline (host-sharded, prefetched)."""
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
