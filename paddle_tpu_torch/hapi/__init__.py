from .train_step import TrainStep

__all__ = ["TrainStep"]
