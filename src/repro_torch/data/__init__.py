"""Synthetic token data — port of ``repro.data``."""
from .synthetic import SyntheticConfig, SyntheticTokens, make_batch_specs

__all__ = ["SyntheticConfig", "SyntheticTokens", "make_batch_specs"]
