from .arrays import Array, open_ds, prepare_ds
from .geometry import Coordinate, Roi

__all__ = ["Array", "Coordinate", "Roi", "open_ds", "prepare_ds"]
