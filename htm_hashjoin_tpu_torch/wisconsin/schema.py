"""Typed column schemas — the TPU re-design of mc/wisconsin-src/schema.h.

The reference's Schema packs typed columns into byte-offset tuple layouts
(schema.h:44+: int/long/double/string/pointer, ``getTupleSize``,
``calcOffset``, ``asLong``).  That AoS byte layout exists for cache-line
locality; a TPU wants structure-of-arrays, so here a Schema is just the
ordered list of column types, and the Table (table.py) stores one device
array per column.  ``tuple_size`` is kept (bytes per logical row) because
the reference reports and sizes buffers with it.

Column types map to dtypes: int→int32, long→int64, double→float64.
``string`` columns are supported for load/save parity (loader.cpp parses
them) but live host-side as numpy arrays; join attributes must be numeric.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Sequence

import numpy as np


class ColumnType(str, enum.Enum):
    """Reference schema.h column types (CT_INTEGER/CT_LONG/CT_DECIMAL/
    CT_CHAR/CT_POINTER)."""

    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    STRING = "string"
    POINTER = "pointer"  # reference StorePointer bookkeeping; here: int64 row id

    @property
    def dtype(self) -> np.dtype:
        return {
            ColumnType.INT: np.dtype(np.int32),
            ColumnType.LONG: np.dtype(np.int64),
            ColumnType.DOUBLE: np.dtype(np.float64),
            ColumnType.STRING: np.dtype(object),
            ColumnType.POINTER: np.dtype(np.int64),
        }[self]

    @property
    def size(self) -> int:
        """Bytes per value in the reference's packed tuple layout
        (schema.h getColumnWidth analog)."""
        return {
            ColumnType.INT: 4,
            ColumnType.LONG: 8,
            ColumnType.DOUBLE: 8,
            ColumnType.STRING: 16,   # reference stores fixed CHAR(n); report 16
            ColumnType.POINTER: 8,
        }[self]


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered column types.  ``Schema.create(("long","long"))`` mirrors
    Schema::create from conf lists (main.cpp:207-212)."""

    types: tuple

    @classmethod
    def create(cls, names: Sequence[str]) -> "Schema":
        return cls(tuple(ColumnType(n) for n in names))

    def columns(self) -> int:
        return len(self.types)

    @property
    def tuple_size(self) -> int:
        """Bytes per logical row (schema.h getTupleSize analog) — used for
        buffer sizing and bandwidth reporting."""
        return sum(t.size for t in self.types)

    def concat(self, other: "Schema", select: Sequence[int]) -> "Schema":
        """Output schema of a join: all of self ++ selected columns of other
        (BaseAlgo::init builds sout this way, algo.h:40-44; select indices are
        1-based as in the conf files' ``select: (2)``)."""
        return Schema(self.types + tuple(other.types[i - 1] for i in select))

    def project(self, select: Sequence[int]) -> "Schema":
        """Schema of a 1-based column selection."""
        return Schema(tuple(self.types[i - 1] for i in select))

    def build_schema(self, select: Sequence[int], jattr: int) -> "Schema":
        """The hash-table tuple layout: join key first, then the selected
        payload columns (BaseAlgo::init: 'build schema is just {key, s1
        schema}', algo.h:38-44)."""
        return Schema((self.types[jattr - 1],)
                      + tuple(self.types[i - 1] for i in select))

    def empty_columns(self) -> List[np.ndarray]:
        return [np.empty((0,), dtype=t.dtype) for t in self.types]
