"""Layers and functions of the port's ``nn`` surface."""

from . import functional
from .layers.common import Embedding, Linear, RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm", "functional"]
