"""Checkpoints — port of ``repro.checkpoint``."""
from .checkpoint import latest_step, restore_pytree, save_pytree

__all__ = ["save_pytree", "restore_pytree", "latest_step"]
