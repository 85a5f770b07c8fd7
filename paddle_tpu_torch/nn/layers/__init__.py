from .common import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm"]
