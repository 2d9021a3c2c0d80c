"""Model stack of the port: the mamba2 (SSM) path of ``repro.models``."""
from .model import Model

__all__ = ["Model"]
