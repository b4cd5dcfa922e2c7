"""Columnar tables — the Wisconsin paged storage engine
(mc/wisconsin-src/{table,page,loader}.{h,cpp}) on tensors.

Counterpart of ``htm_hashjoin_tpu/wisconsin/table.py``.  Numeric columns
are torch tensors on one explicit device and stay there end to end; string
columns are host numpy ``object`` arrays.  What survives from the
reference:

  * ``page_size`` — rows per logical page, the work-tiling unit: ``split``
    deals page-sized row blocks round-robin exactly like Table::split
    (table.cpp:238-272).
  * ``WriteTable.generate`` — the generation bridge (table.cpp:206-233):
    zipf>0 → zipf relation, size==alphabet → pk, else fk, through the
    port's seeded generators.
  * ``load``/``save`` — '|'-separated text files (loader.cpp; conf 'file:'
    entries like 016M_build.tbl), ``.npz`` binaries (the PERSIST_RELATIONS
    analog, mc/src/generator.c:211-224) and ``.bz2`` text.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.timing import readback_array
from .schema import ColumnType, Schema

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float64): torch.float64}


def is_strings(col) -> bool:
    """Whether a column is a host string column (numpy ``object``)."""
    return isinstance(col, np.ndarray) and col.dtype == object


def host(col) -> np.ndarray:
    """A column as a host numpy array; a tensor's copy is a counted wait on
    the device (``utils.timing.readback_array``)."""
    if isinstance(col, torch.Tensor):
        return readback_array(col)
    return np.asarray(col)


@dataclasses.dataclass
class Table:
    """Immutable columnar table: one tensor (or host string array) per
    schema column.

    ``rows`` caps the logical row count when columns carry capacity padding
    (join outputs are materialized at next-pow2 capacity with the invalid
    tail beyond ``rows``).  ``PageCursor`` equivalents are (start, stop)
    row blocks from split()."""

    schema: Schema
    columns: List
    page_size: int = 1 << 20   # rows per logical page (conf 'pagesize')
    rows: Optional[int] = None  # logical row count (None = column length)

    @property
    def num_rows(self) -> int:
        if self.rows is not None:
            return self.rows
        return 0 if not self.columns else int(self.columns[0].shape[0])

    def column(self, i: int):
        """1-based column accessor (reference conf attribute/select indices
        are 1-based, e.g. ``jattr: 1``).  Returns the valid prefix when the
        backing array carries capacity padding."""
        c = self.columns[i - 1]
        if self.rows is not None and c.shape[0] != self.rows:
            return c[: self.rows]
        return c

    def key_column(self, jattr: int) -> torch.Tensor:
        col = self.column(jattr)
        if self.schema.types[jattr - 1] == ColumnType.STRING:
            raise TypeError("join attribute must be numeric")
        return col

    def split(self, nparts: int) -> List[np.ndarray]:
        """Round-robin page split: page p goes to part p % nparts
        (Table::split, table.cpp:238-272).  Returns per-part row-index
        arrays."""
        n = self.num_rows
        pages = [np.arange(s, min(s + self.page_size, n))
                 for s in range(0, n, self.page_size)]
        parts: List[List[np.ndarray]] = [[] for _ in range(nparts)]
        for p, rows in enumerate(pages):
            parts[p % nparts].append(rows)
        return [np.concatenate(b) if b else np.empty((0,), np.int64)
                for b in parts]

    def gather(self, rows) -> "Table":
        """Row gather — on the device for tensor columns, on the host for
        strings."""
        out = []
        for i in range(len(self.columns)):
            c = self.column(i + 1)
            if isinstance(c, torch.Tensor):
                out.append(c[torch.as_tensor(rows, device=c.device)])
            else:
                out.append(np.asarray(c)[host(rows)])
        return Table(self.schema, out, self.page_size)

    def save(self, path: str, separator: str = "|") -> None:
        """Text .tbl writer (the output: 'test.tbl' conf entry), or .npz."""
        cols = [host(self.column(i + 1)) for i in range(len(self.columns))]
        if path.endswith(".npz"):
            np.savez(path, *cols)
            return
        with open(path, "w") as f:
            for i in range(self.num_rows):
                f.write(separator.join(str(c[i]) for c in cols) + "\n")

    def checksum(self, col: int = 1) -> int:
        """Σ of a numeric column — conservation oracle hook."""
        c = self.column(col)
        if isinstance(c, torch.Tensor):
            return int(c.long().sum())
        return int(np.asarray(c, dtype=np.int64).sum())


class WriteTable(Table):
    """Appendable table (reference WriteTable, table.h:200-253) on
    ``device``.  Appends buffer in chunks; ``finalize`` concatenates once —
    the bump allocator analog without per-tuple work."""

    def __init__(self, schema: Schema, page_size: int = 1 << 20,
                 device=None):
        self.device = torch.device(device or "cpu")
        super().__init__(schema, [self._column(c) for c in
                                  schema.empty_columns()], page_size)
        self._chunks: List[List] = []

    def _column(self, col):
        """Numeric columns become tensors on the table's device; strings
        stay host numpy."""
        if isinstance(col, torch.Tensor):
            return col.to(self.device)
        col = np.asarray(col)
        if col.dtype == object:
            return col
        return torch.from_numpy(np.ascontiguousarray(col)).to(self.device)

    def append_batch(self, cols: Sequence) -> None:
        if len(cols) != self.schema.columns():
            raise ValueError("column count mismatch")
        self._chunks.append([self._column(c) for c in cols])

    def finalize(self) -> None:
        if not self._chunks:
            return
        if len(self._chunks) == 1 and self.num_rows == 0:
            self.columns = self._chunks[0]       # the generate() fast path
        else:
            parts = [[self.columns[i]] + [c[i] for c in self._chunks]
                     for i in range(self.schema.columns())]
            self.columns = [
                np.concatenate([host(p) for p in ps]) if is_strings(ps[-1])
                else torch.cat(ps)
                for ps in parts]
        self._chunks = []

    # -- generation bridge (table.cpp:206-233) ------------------------------

    def generate(self, relation_size: int, alphabet_size: int,
                 zipf_param: float, seed: int) -> None:
        """WriteTable::generate semantics: zipf when zipf_param>0, pk when
        size==alphabet, fk otherwise (table.cpp:214-227).  Column 1 is the
        key; remaining numeric columns get the 1-based row id (the tuple
        payload / rid convention of mc/src/types.h tuple_t)."""
        from ..data import generators as G

        if zipf_param > 0.0:
            keys = G.zipf_keys(relation_size, alphabet_size, zipf_param,
                               seed, self.device)
        elif relation_size == alphabet_size:
            keys = G.pk_keys(relation_size, seed, self.device)
        else:
            keys = G.fk_from_pk_keys(relation_size, alphabet_size, seed,
                                     self.device)
        # Physical storage narrows LONG columns to int32 when the generated
        # value range certifies it (keys <= alphabet, payload rid <= size),
        # as the JAX package does (its table.py:170-190): the logical schema
        # type stays 'long', but a 256M-row probe's int64 columns would
        # double the bytes of every pass, and the partition split's
        # key-value sort (K7) takes int32 columns only.
        i32_ok = max(relation_size, alphabet_size) < (1 << 31)
        cols = []
        for i, t in enumerate(self.schema.types):
            narrow = (torch.int32 if i32_ok and t != ColumnType.DOUBLE
                      else _TORCH_DTYPES[t.dtype])
            if i == 0:
                cols.append(keys.to(narrow) if t != ColumnType.STRING
                            else host(keys).astype(str).astype(object))
            elif t == ColumnType.STRING:
                cols.append(np.arange(1, relation_size + 1).astype(str)
                            .astype(object))
            else:
                cols.append(torch.arange(1, relation_size + 1, dtype=narrow,
                                         device=self.device))
        self.append_batch(cols)
        self.finalize()

    # -- text loader (loader.cpp) -------------------------------------------

    def load(self, path: str, separators: str = "|") -> None:
        """Field-separated text loader (Loader::load, loader.cpp; conf
        'file:'/'path:' entries).  .npz files load binary-fast; integer
        schemas parse through the native parallel loader when built;
        .bz2 files decompress transparently (the reference vendors
        bzip2-1.0.5 for exactly this, mc/wisconsin-src Makefile)."""
        if path.endswith(".bz2"):
            import bz2
            import tempfile
            with bz2.open(path, "rt") as src, \
                    tempfile.NamedTemporaryFile("w", suffix=".tbl",
                                                delete=False) as tmp:
                for chunk in iter(lambda: src.read(1 << 22), ""):
                    tmp.write(chunk)
                name = tmp.name
            try:
                self.load(name, separators)
            finally:
                os.unlink(name)
            return
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=True) as data:
                self.append_batch([data[k] for k in data.files])
            self.finalize()
            return
        if all(t in (ColumnType.INT, ColumnType.LONG, ColumnType.POINTER)
               for t in self.schema.types):
            from ..data import tblio
            mat = tblio.load_tbl(path, self.schema.columns(), separators[0])
            if mat is not None:
                self.append_batch([mat[:, i].astype(t.dtype) for i, t in
                                   enumerate(self.schema.types)])
                self.finalize()
                return
        raw = [[] for _ in range(self.schema.columns())]
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split(separators[0])
                for i in range(self.schema.columns()):
                    raw[i].append(fields[i])
        cols = []
        for i, t in enumerate(self.schema.types):
            if t == ColumnType.STRING:
                cols.append(np.array(raw[i], dtype=object))
            else:
                cols.append(np.array(raw[i], dtype=t.dtype))
        self.append_batch(cols)
        self.finalize()
