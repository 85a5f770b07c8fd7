"""Layers and functions of the port's ``nn`` surface."""

from . import functional
from .clip import ClipGradByGlobalNorm
from .layers.common import Embedding, Linear, RMSNorm

__all__ = ["ClipGradByGlobalNorm", "Embedding", "Linear", "RMSNorm",
           "functional"]
