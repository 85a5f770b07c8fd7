"""Framework utilities of the port: checkpoint ``save`` / ``load``."""

from .io import load, save

__all__ = ["load", "save"]
