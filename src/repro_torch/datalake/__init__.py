"""The named data lake, the port's copy of ``repro/datalake``: the stores,
``DataLake``, the windowed segment fetcher, named KV state
(``datalake.kv``) and demand-driven replication."""

from .fetch import SegmentFetcher, fetch
from .lake import SEGMENT_SIZE, DataLake
from .replication import ReplicationManager, ReplicationPolicy
from .store import DirStore, MemoryStore, ObjectStore

__all__ = ["DataLake", "SEGMENT_SIZE", "ObjectStore", "MemoryStore",
           "DirStore", "SegmentFetcher", "fetch",
           "ReplicationManager", "ReplicationPolicy"]
