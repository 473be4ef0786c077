"""Lake names and two small lakes, the port's own.

The reference keeps checkpoints and datasets as named objects of its data
lake (``repro/datalake/lake.py``) under ``/lidc/data``; so does the port,
whose control plane has its own ``DataLake`` (``datalake/lake.py``).  The
checkpoints and the data pipeline work against any lake with
``put_arrays`` / ``get_arrays`` / ``put_json`` / ``get_json`` that keys
objects by ``str(name)``, the reference's lake included.  ``LakeName`` is
the control plane's ``Name`` (``core/names.py``).  ``MemoryLake`` is the
smallest such lake, for ``chip_smoke.py`` and the CLI without
``--lake-dir``; ``DirLake`` keeps the objects in a directory, in the
reference's on-disk layout, so a run outlives its process.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Union

import numpy as np

from .core.names import DATA_PREFIX, Name
from .datalake.lake import SEGMENT_SIZE, DataLake
from .datalake.store import DirStore

__all__ = ["DATA_PREFIX", "SEGMENT_SIZE", "LakeName", "MemoryLake", "DirLake",
           "lake_name"]

# a lake name is the control plane's hierarchical name
LakeName = Name


def lake_name(name: Union[str, Any]) -> Any:
    """A string parsed into a ``LakeName``; any other name as it is."""
    return LakeName.parse(name) if isinstance(name, str) else name


class MemoryLake:
    """Named objects in a dict, keyed by ``str(name)``.  Arrays are kept as
    given (read-only, not copied), where ``DataLake()`` would write every
    checkpoint out as ``np.savez`` bytes and read it back
    (``scripts/lake_cost.py`` times both); JSON is stored serialised."""

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


class DirLake(DataLake):
    """The control plane's ``DataLake`` over a ``DirStore`` at ``root``: the
    reference's ``DataLake(store=DirStore(root))`` (``repro/datalake/
    {lake,store}.py``) byte for byte on disk, so either framework reads what
    the other wrote.  Each object's keys enter the index together, so an
    object whose write is cut short is in no index and readers never see it,
    and a checkpoint's ``latest`` pointer, written after its arrays, never
    names a torn checkpoint."""

    def __init__(self, root: str):
        super().__init__(store=DirStore(root))
        self.root = root
