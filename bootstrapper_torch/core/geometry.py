"""World-unit integer geometry: ``Coordinate`` and ``Roi``.

This is the foundation of the whole framework: every array, block, and
request is expressed as a region-of-interest (ROI) in *world units*
(e.g. nanometres), independent of voxel size.  The reference framework
builds the same calculus on ``funlib.geometry`` (see reference
``bootstrapper/predict.py:128-140`` for typical usage); here it is a
small, pure, dependency-free reimplementation with identical semantics:

- coordinates are tuples of ``int`` (or ``None`` for unbounded dims),
- arithmetic is elementwise and ``None``-propagating,
- division is *floor* division by default (world units are integral),
- ROIs support grow/intersect/union/snap-to-grid algebra.
"""

from __future__ import annotations

import math
from collections.abc import Iterable
from typing import Optional, Union

Number = Union[int, float]


def _is_scalar(x) -> bool:
    return isinstance(x, (int, float)) or x is None


class Coordinate(tuple):
    """An immutable tuple of integers (or ``None``) with elementwise math.

    ``None`` entries denote "unbounded / unknown" and propagate through
    arithmetic like NaN.  Floats passed in are truncated toward zero to
    keep world units integral (matching funlib semantics).
    """

    def __new__(cls, *args):
        if len(args) == 1 and isinstance(args[0], Iterable):
            args = tuple(args[0])
        return super().__new__(
            cls, (None if a is None else int(a) for a in args)
        )

    @property
    def dims(self) -> int:
        return len(self)

    # -- elementwise arithmetic ------------------------------------------------

    def _binop(self, other, op, name):
        if isinstance(other, Iterable):
            other = tuple(other)
            if len(other) != len(self):
                raise ValueError(
                    f"{name}: dimension mismatch {len(self)} vs {len(other)}"
                )
            return Coordinate(
                None if a is None or b is None else op(a, b)
                for a, b in zip(self, other)
            )
        if _is_scalar(other):
            return Coordinate(
                None if a is None or other is None else op(a, other)
                for a in self
            )
        return NotImplemented

    def __neg__(self):
        return Coordinate(None if a is None else -a for a in self)

    def __abs__(self):
        return Coordinate(None if a is None else abs(a) for a in self)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b, "sub")

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a, "rsub")

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b, "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        # integral world units: truediv is floor-div (funlib behaviour)
        return self._binop(other, lambda a, b: a // b, "div")

    def __floordiv__(self, other):
        return self._binop(other, lambda a, b: a // b, "floordiv")

    def __mod__(self, other):
        return self._binop(other, lambda a, b: a % b, "mod")

    def __pow__(self, other):
        return self._binop(other, lambda a, b: a**b, "pow")

    # -- helpers ---------------------------------------------------------------

    def ceil_div(self, other) -> "Coordinate":
        return self._binop(other, lambda a, b: -((-a) // b), "ceil_div")

    def round_division(self, other) -> "Coordinate":
        return self._binop(
            other, lambda a, b: int(round(a / b)), "round_division"
        )

    def min(self, other) -> "Coordinate":
        return self._binop(other, min, "min")

    def max(self, other) -> "Coordinate":
        return self._binop(other, max, "max")

    def is_multiple_of(self, other) -> bool:
        return all(m == 0 for m in (self % other))

    @classmethod
    def zeros(cls, dims: int) -> "Coordinate":
        return cls((0,) * dims)

    @classmethod
    def ones(cls, dims: int) -> "Coordinate":
        return cls((1,) * dims)


class Roi:
    """A rectangular region of interest: ``offset`` + ``shape``, world units.

    ``None`` in offset/shape marks an unbounded dimension.  ``shape``
    entries must be >= 0 when bounded; an all-zero shape is the empty ROI.
    """

    __slots__ = ("_offset", "_shape")

    def __init__(self, offset, shape):
        self._offset = Coordinate(offset)
        self._shape = Coordinate(shape)
        if self._offset.dims != self._shape.dims:
            raise ValueError("offset and shape dims differ")

    # -- accessors -------------------------------------------------------------

    @property
    def offset(self) -> Coordinate:
        return self._offset

    @property
    def begin(self) -> Coordinate:
        return self._offset

    @property
    def shape(self) -> Coordinate:
        return self._shape

    @property
    def end(self) -> Coordinate:
        return self._offset + self._shape

    @property
    def dims(self) -> int:
        return self._offset.dims

    @property
    def center(self) -> Coordinate:
        return self._offset + self._shape / 2

    @property
    def size(self) -> Optional[int]:
        if any(s is None for s in self._shape):
            return None
        return math.prod(self._shape)

    @property
    def empty(self) -> bool:
        return any(s == 0 for s in self._shape)

    @property
    def unbounded(self) -> bool:
        return any(s is None for s in self._shape)

    # -- equality / repr -------------------------------------------------------

    def __eq__(self, other):
        return (
            isinstance(other, Roi)
            and self._offset == other._offset
            and self._shape == other._shape
        )

    def __hash__(self):
        return hash((self._offset, self._shape))

    def __repr__(self):
        b = ",".join("None" if x is None else str(x) for x in self.begin)
        e = ",".join("None" if x is None else str(x) for x in self.end)
        return f"Roi[({b}), ({e})]"

    # -- algebra ---------------------------------------------------------------

    def shift(self, by) -> "Roi":
        return Roi(self._offset + Coordinate(by), self._shape)

    def __add__(self, by):
        return self.shift(by)

    def __sub__(self, by):
        return self.shift(-Coordinate(by))

    def __mul__(self, f):
        return Roi(self._offset * f, self._shape * f)

    def __truediv__(self, f):
        return Roi(self._offset / f, self._shape / f)

    def grow(self, amount_neg=None, amount_pos=None) -> "Roi":
        """Grow (or shrink with negative amounts) on both sides."""
        if amount_neg is None and amount_pos is None:
            raise ValueError("grow needs at least one amount")
        if amount_neg is None:
            amount_neg = Coordinate.zeros(self.dims)
        if amount_pos is None:
            amount_pos = Coordinate.zeros(self.dims)
        amount_neg = (
            Coordinate((amount_neg,) * self.dims)
            if _is_scalar(amount_neg)
            else Coordinate(amount_neg)
        )
        amount_pos = (
            Coordinate((amount_pos,) * self.dims)
            if _is_scalar(amount_pos)
            else Coordinate(amount_pos)
        )
        return Roi(
            self._offset - amount_neg, self._shape + amount_neg + amount_pos
        )

    def intersect(self, other: "Roi") -> "Roi":
        begin = self.begin.max(other.begin)
        end = self.end.min(other.end)
        shape = Coordinate(
            None
            if e is None
            else max(0, e - (b if b is not None else e))
            for b, e in zip(begin, end)
        )
        # clamp empty intersections to zero-shape at begin
        return Roi(begin, shape)

    def intersects(self, other: "Roi") -> bool:
        return not self.intersect(other).empty

    def union(self, other: "Roi") -> "Roi":
        begin = self.begin.min(other.begin)
        end = self.end.max(other.end)
        return Roi(begin, end - begin)

    def contains(self, other) -> bool:
        if isinstance(other, Roi):
            if other.empty:
                return self.contains(other.begin)
            return self.contains(other.begin) and self.contains(
                other.end - Coordinate.ones(self.dims)
            )
        point = Coordinate(other)
        for b, e, p in zip(self.begin, self.end, point):
            if p is None:
                return False
            if b is not None and p < b:
                return False
            if e is not None and p >= e:
                return False
        return True

    def snap_to_grid(self, voxel_size, mode: str = "grow") -> "Roi":
        """Align begin/end to multiples of ``voxel_size``.

        mode: 'grow' (default), 'shrink', or 'closest'.
        """
        vs = Coordinate(voxel_size)

        def floor(c):
            return Coordinate(
                None if a is None else (a // v) * v for a, v in zip(c, vs)
            )

        def ceil(c):
            return Coordinate(
                None if a is None else -((-a) // v) * v for a, v in zip(c, vs)
            )

        def closest(c):
            return Coordinate(
                None if a is None else int(round(a / v)) * v
                for a, v in zip(c, vs)
            )

        if mode == "grow":
            begin, end = floor(self.begin), ceil(self.end)
        elif mode == "shrink":
            begin, end = ceil(self.begin), floor(self.end)
        elif mode == "closest":
            begin, end = closest(self.begin), closest(self.end)
        else:
            raise ValueError(f"unknown snap mode {mode!r}")
        shape = Coordinate(
            None if e is None or b is None else max(0, e - b)
            for b, e in zip(begin, end)
        )
        return Roi(begin, shape)

    def to_slices(self, voxel_size=None, offset=None) -> tuple:
        """Voxel-space slices of this ROI relative to ``offset`` (world)."""
        vs = (
            Coordinate.ones(self.dims)
            if voxel_size is None
            else Coordinate(voxel_size)
        )
        off = (
            Coordinate.zeros(self.dims) if offset is None else Coordinate(offset)
        )
        slices = []
        for b, e, v, o in zip(self.begin, self.end, vs, off):
            if b is None or e is None:
                slices.append(slice(None))
            else:
                slices.append(slice((b - o) // v, (e - o) // v))
        return tuple(slices)

    def copy(self) -> "Roi":
        return Roi(self._offset, self._shape)
