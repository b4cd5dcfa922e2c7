"""Wisconsin "multijoin" subsystem on tensors — the port of
``htm_hashjoin_tpu/wisconsin`` (mc/wisconsin-src, the configurable
partition/build/probe join framework, SURVEY.md §2.3).

The reference composes a joiner from four orthogonal policies via C++
template mixins (joinerfactory.cpp:23-75):

  storage   — StoreCopy (materialize tuples into the hash table) vs
              StorePointer (store pointers, late materialization)
  build     — BuildIsPart (thread-private partitions, unsynchronized
              inserts) vs BuildIsNotPart (shared table, atomic inserts)
  probe     — ProbeIsPart / ProbeIsNotPart / ProbeSteal (work stealing)
  special   — NestedLoops, FlatMemoryJoiner (radix flat-array build +
              histogram-range probe)

plus a partitioner family (partitioner.cpp:69-757), a hash-function
factory (hash.h:26-113), a paged storage engine (table/page/schema) and a
libconfig-driven driver (main.cpp:97-420).  The reference's own ``.conf``
files parse and run unchanged (conf.py implements the libconfig subset
they use):

    python -m htm_hashjoin_tpu_torch.wisconsin <conf> [--write-output]

Tables live on one device: ``run_multijoin(conf, device=...)`` runs on the
CUDA device by default, where the partition split at reference scale goes
through the key-value global sort K7 (``ops/global_sort_kv.py``), and on
the CPU with the plain versions when given ``device="cpu"``.  Importing
this package imports torch only.
"""

from .schema import ColumnType, Schema
from .table import Table, WriteTable
from .hashfn import (HashFunction, RangePartitionHash, ModuloHash, MagicHash,
                     hash_factory)
from .partitioner import (NoPartitioner, ParallelPartitioner,
                          IndependentPartitioner, DerekPartitioner,
                          RadixPartitioner, partitioner_factory)
from .joiners import (HashJoiner, NestedLoops, FlatMemoryJoiner,
                      joiner_factory)
from .conf import parse_conf, parse_conf_string
from .confgen import generate_conf_grid, render_conf
from .datagen import build_rows, probe_rows
from .datagen import generate as generate_tbl_files
from .driver import run_multijoin

__all__ = [
    "generate_conf_grid", "render_conf",
    "build_rows", "probe_rows", "generate_tbl_files",
    "ColumnType", "Schema", "Table", "WriteTable",
    "HashFunction", "RangePartitionHash", "ModuloHash", "MagicHash",
    "hash_factory",
    "NoPartitioner", "ParallelPartitioner", "IndependentPartitioner",
    "DerekPartitioner", "RadixPartitioner", "partitioner_factory",
    "HashJoiner", "NestedLoops", "FlatMemoryJoiner", "joiner_factory",
    "parse_conf", "parse_conf_string", "run_multijoin",
]
