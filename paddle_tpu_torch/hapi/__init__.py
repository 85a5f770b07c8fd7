from . import callbacks
from .model import Model
from .train_step import StagedBatch, TrainStep

__all__ = ["Model", "StagedBatch", "TrainStep", "callbacks"]
