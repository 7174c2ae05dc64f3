from . import plotting, printing

__all__ = ["plotting", "printing"]
