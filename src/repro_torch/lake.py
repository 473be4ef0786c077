"""Lake names and a small in-memory lake, the port's own copies.

The reference keeps checkpoints and datasets as named objects of its data
lake (``repro/datalake/lake.py``) under ``/lidc/data``.  The port builds the
same names and works against any lake with ``put_arrays`` /
``get_arrays`` / ``put_json`` / ``get_json`` that keys objects by
``str(name)``, the reference's lake included: ``LakeName`` has the
``components``, ``append`` and ``str`` that lake reads.  ``MemoryLake`` is
the smallest such lake, for the CLI and ``chip_smoke.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

__all__ = ["DATA_PREFIX", "LakeName", "MemoryLake", "lake_name"]

DATA_PREFIX = "/lidc/data"


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
