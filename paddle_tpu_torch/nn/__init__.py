"""Layers and functions of the port's ``nn`` surface."""

from . import functional, initializer
from .clip import ClipGradByGlobalNorm
from .layers.common import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["ClipGradByGlobalNorm", "Dropout", "Embedding", "LayerNorm",
           "Linear", "RMSNorm", "functional", "initializer"]
