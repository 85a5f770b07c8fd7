from .common import Embedding, Linear, RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm"]
