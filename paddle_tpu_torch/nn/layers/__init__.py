from .common import (Conv2D, Dropout, Embedding, GroupNorm, LayerNorm,
                     Linear, RMSNorm)

__all__ = ["Conv2D", "Dropout", "Embedding", "GroupNorm", "LayerNorm",
           "Linear", "RMSNorm"]
