from . import generators

__all__ = ["generators"]
