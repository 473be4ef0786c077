"""Lake names and a small in-memory lake, the port's own copies.

The reference keeps checkpoints and datasets as named objects of its data
lake (``repro/datalake/lake.py``) under ``/lidc/data``.  The port builds the
same names and works against any lake with ``put_arrays`` /
``get_arrays`` / ``put_json`` / ``get_json`` that keys objects by
``str(name)``, the reference's lake included: ``LakeName`` has the
``components``, ``append`` and ``str`` that lake reads.  ``MemoryLake`` is
the smallest such lake, for ``chip_smoke.py`` and the CLI without
``--lake-dir``; ``DirLake`` keeps the objects in a directory, in the
reference's on-disk layout, so a run outlives its process.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["DATA_PREFIX", "SEGMENT_SIZE", "LakeName", "MemoryLake", "DirLake",
           "lake_name"]

DATA_PREFIX = "/lidc/data"
SEGMENT_SIZE = 1 << 20   # the reference's 1 MiB segments


@dataclass(frozen=True)
class LakeName:
    """A hierarchical name, '/'-separated components."""

    components: Tuple[str, ...]

    @staticmethod
    def parse(uri: str) -> "LakeName":
        uri = uri.strip()
        if not uri.startswith("/"):
            raise ValueError(f"name must start with '/': {uri!r}")
        return LakeName(tuple(p for p in uri.split("/") if p))

    def append(self, *components: str) -> "LakeName":
        return LakeName(self.components + tuple(
            p for c in components for p in str(c).split("/") if p))

    def __str__(self) -> str:
        return "/" + "/".join(self.components)


def lake_name(name: Union[str, Any]) -> Any:
    """A string parsed into a ``LakeName``; any other name as it is."""
    return LakeName.parse(name) if isinstance(name, str) else name


class MemoryLake:
    """Named objects in a dict, keyed by ``str(name)``.  Arrays are kept as
    given (read-only, not copied); JSON is stored serialised."""

    def __init__(self):
        self.objects: Dict[str, Any] = {}

    def put_arrays(self, name, arrays: Dict[str, np.ndarray]):
        for a in arrays.values():
            a.flags.writeable = False
        self.objects[str(name)] = dict(arrays)
        return name

    def get_arrays(self, name) -> Optional[Dict[str, np.ndarray]]:
        arrays = self.objects.get(str(name))
        return None if arrays is None else dict(arrays)

    def put_json(self, name, obj: Any):
        self.objects[str(name)] = json.dumps(obj, sort_keys=True)
        return name

    def get_json(self, name) -> Optional[Any]:
        blob = self.objects.get(str(name))
        return None if blob is None else json.loads(blob)


class DirLake:
    """Named objects in a directory, byte for byte the layout of the
    reference's ``DataLake(store=DirStore(root))`` (``repro/datalake/
    {lake,store}.py``), so either framework reads what the other wrote:

    * one file per stored key, ``sha256(key)[:32] + ".bin"``, written to a
      temporary file and renamed into place; ``_index.json`` maps each key
      to its file and is replaced whole, never torn;
    * an object of at most ``SEGMENT_SIZE`` bytes is one key (plus
      ``<key>#meta`` when it has metadata); a larger one is the keys
      ``<key>/seg=i`` and then ``<key>/manifest``, ``{"segments", "size",
      "segment_size", **meta}``;
    * arrays are ``np.savez`` bytes with meta ``{"kind": "arrays", "n"}``,
      JSON is ``json.dumps(obj, sort_keys=True)``.

    The reference rewrites the index after every key; here it is written
    once an object's keys are all on disk (the file ends the same).  An
    object whose write is cut short is in no index, so readers never see
    it, and a checkpoint's ``latest`` pointer, written after its arrays,
    never names a torn checkpoint.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "_index.json")
        self._index: Dict[str, str] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    # -- keys: the reference's DirStore
    def _write(self, key: str, blob) -> None:
        fname = hashlib.sha256(key.encode()).hexdigest()[:32] + ".bin"
        fd, tmp = tempfile.mkstemp(dir=self.root)
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(self.root, fname))
        self._index[key] = fname

    def _save_index(self) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f)
        os.replace(tmp, self._index_path)

    def _path(self, key: str) -> Optional[str]:
        fname = self._index.get(key)
        path = None if fname is None else os.path.join(self.root, fname)
        return path if path is not None and os.path.exists(path) else None

    def _read(self, key: str) -> Optional[bytes]:
        path = self._path(key)
        if path is None:
            return None
        with open(path, "rb") as f:
            return f.read()

    # -- objects: the reference's DataLake
    def put_bytes(self, name, blob, meta: Optional[Dict[str, Any]] = None):
        """Store ``blob`` (any bytes-like object) under ``name``, in
        segments if it is larger than one."""
        key, view = str(name), memoryview(blob).cast("B")
        seg = SEGMENT_SIZE
        if view.nbytes <= seg:
            self._write(key, view)
            if meta:
                self._write(key + "#meta", json.dumps(meta).encode())
        else:
            nseg = (view.nbytes + seg - 1) // seg
            for i in range(nseg):
                self._write(f"{key}/seg={i}", view[i * seg:(i + 1) * seg])
            manifest = {"segments": nseg, "size": view.nbytes, "segment_size": seg,
                        **(meta or {})}
            self._write(f"{key}/manifest", json.dumps(manifest).encode())
        self._save_index()
        return name

    def get_bytes(self, name) -> Optional[bytes]:
        """The object's bytes, its segments joined; None if it is absent or
        a segment is missing."""
        key = str(name)
        blob = self._read(key)
        if blob is not None:
            return blob
        man = self._read(f"{key}/manifest")
        if man is None:
            return None
        manifest = json.loads(man.decode())
        out = bytearray(int(manifest["size"]))
        view, at = memoryview(out), 0
        for i in range(int(manifest["segments"])):
            path = self._path(f"{key}/seg={i}")
            if path is None:
                return None
            with open(path, "rb") as f:
                at += f.readinto(view[at:])
        return bytes(out) if at == len(out) else None

    def put_json(self, name, obj: Any):
        return self.put_bytes(name, json.dumps(obj, sort_keys=True).encode())

    def get_json(self, name) -> Optional[Any]:
        blob = self.get_bytes(name)
        return None if blob is None else json.loads(blob.decode())

    def put_arrays(self, name, arrays: Dict[str, np.ndarray]):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return self.put_bytes(name, buf.getbuffer(), meta={"kind": "arrays", "n": len(arrays)})

    def get_arrays(self, name) -> Optional[Dict[str, np.ndarray]]:
        blob = self.get_bytes(name)
        if blob is None:
            return None
        with np.load(io.BytesIO(blob)) as z:
            return {k: z[k] for k in z.files}

    def has(self, name) -> bool:
        key = str(name)
        return self._path(key) is not None or self._path(f"{key}/manifest") is not None

    def names(self) -> List[str]:
        return [k for k in self._index if not k.endswith("#meta")]
