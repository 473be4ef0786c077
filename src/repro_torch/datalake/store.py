"""Storage backends for the data lake — the 'PVC' layer.

The paper mounts an NFS-backed PersistentVolumeClaim into the cluster and
serves files from it.  We provide two equivalent backends:

* :class:`MemoryStore` — dict-backed, used by tests/benchmarks.
* :class:`DirStore` — directory-backed (one file per object), the analog of
  the paper's NFS PVC; survives process restarts, which is what makes
  checkpoint/restart across cluster failures real.

The port's copy of ``repro/datalake/store.py``: the same logic, its imports
pointing inside ``repro_torch``, plus ``batch()``: ``DirStore`` writes its
index once for the keys put inside one (the reference rewrites it after
every key; the file ends the same).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["ObjectStore", "MemoryStore", "DirStore"]


class ObjectStore:
    """Key → bytes-like mapping.  Implementations accept ``bytes`` or
    ``memoryview`` values and must store ``bytes``/``memoryview`` inputs
    *without copying* (the zero-copy invariant the segment pipeline relies
    on): a segmented put hands the store N ``memoryview`` slices of one
    blob, and the serve path ships the stored view straight into a Data
    packet.  Callers therefore must not mutate a buffer after putting it.
    """

    def put(self, key: str, blob: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> Iterable[str]:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def batch(self):
        """A context for several puts that stand or fall together."""
        return nullcontext(self)


class MemoryStore(ObjectStore):
    """Dict-backed store.  ``copies`` counts every ``bytes()``
    materialization the store performed — the copy-counter the data-plane
    benchmark asserts stays at zero across a segmented put + serve."""

    def __init__(self) -> None:
        self._d: Dict[str, bytes] = {}
        self.copies = 0

    def put(self, key: str, blob: bytes) -> None:
        if not isinstance(blob, (bytes, memoryview)):
            blob = bytes(blob)     # defensive copy for mutable inputs only
            self.copies += 1
        self._d[key] = blob

    def get(self, key: str) -> Optional[bytes]:
        return self._d.get(key)

    def delete(self, key: str) -> None:
        self._d.pop(key, None)

    def keys(self):
        return list(self._d)

    def total_bytes(self) -> int:
        return sum(len(v) for v in self._d.values())


class DirStore(ObjectStore):
    """One file per object; keys are sanitized via sha256 prefixing."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "_index.json")
        self._index: Dict[str, str] = {}
        self._batches = 0
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _fname(self, key: str) -> str:
        h = hashlib.sha256(key.encode()).hexdigest()[:32]
        return os.path.join(self.root, h + ".bin")

    def _save_index(self) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f)
        os.replace(tmp, self._index_path)   # atomic: no torn index on crash

    @contextmanager
    def batch(self):
        """Puts inside the outermost batch enter the index on disk together,
        when it ends: a process killed inside it leaves their files named by
        no index entry, so no reader sees any of them."""
        self._batches += 1
        try:
            yield self
        finally:
            self._batches -= 1
            if not self._batches:
                self._save_index()

    def put(self, key: str, blob: bytes) -> None:
        path = self._fname(key)
        fd, tmp = tempfile.mkstemp(dir=self.root)
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)               # atomic object write
        self._index[key] = os.path.basename(path)
        if not self._batches:
            self._save_index()

    def get(self, key: str) -> Optional[bytes]:
        if key not in self._index:
            return None
        path = os.path.join(self.root, self._index[key])
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def delete(self, key: str) -> None:
        name = self._index.pop(key, None)
        if name:
            try:
                os.remove(os.path.join(self.root, name))
            except FileNotFoundError:
                pass
            self._save_index()

    def keys(self):
        return list(self._index)
