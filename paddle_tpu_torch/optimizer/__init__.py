"""Optimizers and LR schedulers of the port's training path."""

from . import lr
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, Lamb, LarsMomentum, Momentum, NAdam,
                        Optimizer, RAdam, RMSProp, Rprop)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "LBFGS",
           "Lamb", "LarsMomentum", "Momentum", "NAdam", "Optimizer", "RAdam",
           "RMSProp", "Rprop", "SGD", "lr"]
