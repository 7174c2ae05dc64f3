from . import printing

__all__ = ["printing"]
