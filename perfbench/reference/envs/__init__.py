from . import car_racing

__all__ = ["car_racing"]
