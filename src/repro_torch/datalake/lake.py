"""The named data lake (paper §III.C): publish/retrieve datasets by name.

Computations pull raw inputs from the lake and publish intermediate/final
outputs back into it; clients later retrieve results with an ordinary data
Interest ("/lidc/data/<identifier>").  Objects larger than one packet are
segmented NDN-style (`.../seg=i` components plus a `.../manifest`), which is
also how multi-gigabyte checkpoints are stored and fetched.

The lake attaches to a forwarder as a producer on the `/lidc/data` prefix,
exactly like the paper's data-lake NFD + fileserver pod behind the gateway.

**Segment serving + the zero-copy invariant.**  Each ``seg=i`` slice and the
``manifest`` are first-class named objects: the producer handler answers a
segment Interest with a Data packet whose content is the *stored
memoryview* — no ``bytes`` materialization on the put path (segmentation
slices one buffer) or the serve path (the view ships straight into the
packet).  Because segments are ordinary named Data, every intermediate
forwarder caches and aggregates at segment granularity; the consumer-side
:class:`~repro.datalake.fetch.SegmentFetcher` pulls them under an AIMD
congestion window and reassembles incrementally.  A bare-name Interest for
a segmented object still answers with one reassembled monolithic Data —
kept as the baseline/oracle path (it *does* pay a reassembly copy).
Callers must not mutate a buffer after ``put_bytes``; the store aliases it.

The port's copy of ``repro/datalake/lake.py``: the same logic, its imports
pointing inside ``repro_torch``; an object's keys are written in one
``store.batch()``, so a directory store indexes them together.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ..core import reasons
from ..core.names import DATA_PREFIX, Name
from ..core.packets import Data, Interest, sign_data
from ..core.forwarder import Forwarder, Nack
from .store import MemoryStore, ObjectStore

__all__ = ["DataLake", "SEGMENT_SIZE"]

SEGMENT_SIZE = 1 << 20  # 1 MiB virtual packets


class DataLake:
    """A named object store with NDN segmentation and signed answers."""

    def __init__(self, store: Optional[ObjectStore] = None,
                 prefix: str = DATA_PREFIX,
                 signer: str = "datalake", key: bytes = b"lidc-lake-key",
                 segment_size: int = SEGMENT_SIZE):
        self.store = store or MemoryStore()
        self.prefix = Name.parse(prefix)
        self.signer = signer
        self.key = key
        self.segment_size = max(1, int(segment_size))
        self.puts = 0
        self.gets = 0
        self.segment_serves = 0     # zero-copy store-key answers
        self.monolithic_serves = 0  # bare-name reassembly answers (baseline)

    # ------------------------------------------------------------------ put
    def put_bytes(self, name: Name, blob: bytes,
                  meta: Optional[Dict[str, Any]] = None) -> Name:
        """Store a blob under a name, segmenting if needed.

        Zero-copy: segmentation stores ``memoryview`` slices of the one
        input buffer — no per-segment ``bytes`` copies.  The caller must
        not mutate ``blob`` afterwards (the store aliases it).
        """
        assert self.prefix.is_prefix_of(name), f"{name} outside {self.prefix}"
        self.puts += 1
        seg_size = self.segment_size
        size = len(blob)
        with self.store.batch():
            if size <= seg_size:
                self._write(str(name), blob)
                if meta:
                    self._write(str(name) + "#meta", json.dumps(meta).encode())
                return name
            mv = blob if isinstance(blob, memoryview) else memoryview(blob)
            nseg = (size + seg_size - 1) // seg_size
            base = str(name)
            for i in range(nseg):
                self._write(f"{base}/seg={i}", mv[i * seg_size:(i + 1) * seg_size])
            manifest = {"segments": nseg, "size": size,
                        "segment_size": seg_size, **(meta or {})}
            self._write(f"{base}/manifest", json.dumps(manifest).encode())
        return name

    def _write(self, key: str, blob) -> None:
        """One stored key of an object."""
        self.store.put(key, blob)

    def put_json(self, name: Name, obj: Any, **kw) -> Name:
        return self.put_bytes(name, json.dumps(obj, sort_keys=True).encode(), **kw)

    def put_arrays(self, name: Name, arrays: Dict[str, np.ndarray]) -> Name:
        """Store a flat dict of numpy arrays (checkpoint shards use this)."""
        import io
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return self.put_bytes(name, buf.getvalue(),
                              meta={"kind": "arrays", "n": len(arrays)})

    # ------------------------------------------------------------------ get
    def get_view(self, name: Name):
        """Whole-object read returning a bytes-like *view* where possible:
        an unsegmented object comes back exactly as stored (possibly a
        ``memoryview`` — zero-copy); a segmented one is reassembled (which
        copies).  Readers that only slice or buffer-protocol the result
        (numpy, hashing, signing) should prefer this over
        :meth:`get_bytes`."""
        self.gets += 1
        blob = self.store.get(str(name))
        if blob is not None:
            return blob
        man = self.store.get(str(name.append("manifest")))
        if man is None:
            return None
        manifest = json.loads(bytes(man).decode())
        parts: List[bytes] = []
        for i in range(int(manifest["segments"])):
            seg = self.store.get(str(name.append(f"seg={i}")))
            if seg is None:
                return None  # torn object
            parts.append(seg)
        return b"".join(parts)

    def get_bytes(self, name: Name) -> Optional[bytes]:
        """Whole-object read as ``bytes``; reassembles segmented objects
        (the oracle / monolithic baseline path — this one *does* copy)."""
        blob = self.get_view(name)
        if blob is None or isinstance(blob, bytes):
            return blob
        return bytes(blob)

    def get_json(self, name: Name) -> Optional[Any]:
        blob = self.get_bytes(name)
        return None if blob is None else json.loads(blob.decode())

    def get_arrays(self, name: Name) -> Optional[Dict[str, np.ndarray]]:
        import io
        blob = self.get_bytes(name)
        if blob is None:
            return None
        with np.load(io.BytesIO(blob)) as z:
            return {k: z[k] for k in z.files}

    def has(self, name: Name) -> bool:
        return (self.store.get(str(name)) is not None
                or self.store.get(str(name.append("manifest"))) is not None)

    def names(self) -> List[str]:
        return [k for k in self.store.keys()
                if not (k.endswith("#meta"))]

    # ------------------------------------------------------- producer glue
    def attach(self, node: Forwarder) -> None:
        """Serve `/lidc/data` Interests on a forwarder (the fileserver pod).

        Streaming fast path: an Interest naming a stored key directly —
        a ``seg=i`` slice, a ``manifest``, or an unsegmented object — is
        answered from the store with *zero copies* (the stored view is the
        packet content).  A bare-name Interest for a segmented object
        falls back to monolithic reassembly (baseline/oracle path).
        """

        def handler(interest: Interest, publish: Callable[[Data], None],
                    now: float):
            blob = self.store.get(str(interest.name))
            if blob is not None:
                self.gets += 1
                self.segment_serves += 1
            else:
                blob = self.get_bytes(interest.name)   # monolithic oracle
                if blob is None:
                    return Nack(interest, reasons.DATA_NOT_FOUND)
                self.monolithic_serves += 1
            d = Data(name=interest.name, content=blob, created_at=now,
                     freshness=30.0)
            return sign_data(d, self.key, self.signer)

        node.attach_producer(self.prefix, handler)
