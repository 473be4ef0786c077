#!/usr/bin/env python3
"""What the port's lakes cost to put and get one checkpoint, on the host.

    python3 scripts/lake_cost.py [--mib 1024] [--arrays 64] [--dir PATH]

Writes one dict of ``--arrays`` f32 arrays, ``--mib`` MiB in all (a train
state as ``ckpt.save_checkpoint`` hands it to a lake), with ``put_arrays``
and reads it back with ``get_arrays`` in four lakes:

* ``MemoryLake``: keeps the arrays as given;
* ``DataLake()``: the control plane's lake over a ``MemoryStore``
  (``np.savez`` bytes in 1 MiB segments);
* ``DirLake``: ``DataLake`` over a ``DirStore`` in ``--dir``, the object's
  keys indexed once, when its last key is written;
* the same with the index rewritten after every key, as the reference's
  ``DirStore`` does.

Prints a JSON line per lake: put and get seconds, and the stored keys.
Needs only numpy; the directory is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.datalake import DataLake  # noqa: E402
from repro_torch.datalake.store import DirStore  # noqa: E402
from repro_torch.lake import DirLake, LakeName, MemoryLake  # noqa: E402


class PerKeyIndex(DirStore):
    """A ``DirStore`` that rewrites its index after every key."""

    def batch(self):
        return nullcontext(self)


def timed(lake, name, arrays):
    t0 = time.perf_counter()
    lake.put_arrays(name, arrays)
    put = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = lake.get_arrays(name)
    get = time.perf_counter() - t0
    assert got is not None and all(np.array_equal(got[k], arrays[k]) for k in arrays)
    return put, get


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--arrays", type=int, default=64)
    ap.add_argument("--dir", default=None, help="where the directory lakes go")
    args = ap.parse_args()
    n = args.mib * 2**20 // 4 // args.arrays
    rng = np.random.default_rng(0)
    arrays = {f"params/w{i}": rng.standard_normal(n, dtype=np.float32)
              for i in range(args.arrays)}
    name = LakeName.parse("/lidc/data/ckpt/cost/step=1")
    work = Path(tempfile.mkdtemp(prefix="lake-cost-", dir=args.dir))
    try:
        lakes = {"MemoryLake": lambda: MemoryLake(),
                 "DataLake(MemoryStore)": lambda: DataLake(),
                 "DirLake (index once an object)": lambda: DirLake(str(work / "once")),
                 "DataLake(DirStore, index every key)":
                     lambda: DataLake(store=PerKeyIndex(str(work / "every")))}
        for label, make in lakes.items():
            lake = make()
            put, get = timed(lake, name, dict(arrays))
            keys = len(lake.store.keys()) if hasattr(lake, "store") else len(lake.objects)
            print(json.dumps({"lake": label, "mib": args.mib, "arrays": args.arrays,
                              "put_s": put, "get_s": get, "keys": keys}), flush=True)
            del lake
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
