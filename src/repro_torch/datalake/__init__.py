"""The named data lake, the port's copy of ``repro/datalake``: the stores
and ``DataLake``.  The segment fetcher, the KV and replication modules are
not ported yet."""

from .lake import SEGMENT_SIZE, DataLake
from .store import DirStore, MemoryStore, ObjectStore

__all__ = ["DataLake", "SEGMENT_SIZE", "DirStore", "MemoryStore", "ObjectStore"]
