"""Serving substrate of the port: batched prefill + lockstep decode engine."""
from repro_torch.serve.engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
