"""Layers and functions of the port's ``nn`` surface."""

from . import functional, initializer
from .clip import ClipGradByGlobalNorm
from .layers.common import (Conv2D, Dropout, Embedding, GroupNorm,
                            LayerNorm, Linear, RMSNorm)

__all__ = ["ClipGradByGlobalNorm", "Conv2D", "Dropout", "Embedding",
           "GroupNorm", "LayerNorm", "Linear", "RMSNorm", "functional",
           "initializer"]
