"""Demand-driven replication: hot datasets move to the edge on their own.

The port's counterpart of the repo's ``examples/hot_dataset_replication.py``,
on the port's forwarder, lake and replication manager
(``repro_torch.datalake.replication``).  An origin cluster holds eight named
datasets behind a slow WAN hop; an edge site fronts three reader nodes
issuing zipf-skewed fetches.  The edge's :class:`ReplicationManager` watches
per-object Interest demand (decaying, bounded: telemetry the forwarder
already collects), pulls the hot head of the distribution once over the
WAN, then serves and advertises the replicas locally.  A second wave of the
same workload shows the effect: origin egress collapses while delivery
stays perfect.  Everything runs on the virtual clock, on the host::

    PYTHONPATH=src python -m repro_torch.examples.hot_dataset_replication
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Any, Dict

from ..core import Forwarder, Name, Network
from ..core.forwarder import link
from ..datalake import DataLake, ReplicationManager, ReplicationPolicy, fetch

__all__ = ["SIZE", "DATASETS", "READS_PER_WAVE", "run"]

SIZE = 128 * 1024                      # per dataset
DATASETS = 8
READS_PER_WAVE = 60


def run(*, verbose: bool = True) -> Dict[str, Any]:
    """Two waves of zipf-skewed reads through an edge that replicates;
    returns the origin's egress per wave, the manager's counters, the
    replicated names, the reads delivered and the audit's findings."""
    say = print if verbose else (lambda *a, **k: None)
    # 1. topology: origin -- (30 ms WAN) -- edge -- three reader nodes
    net = Network()
    origin = Forwarder(net, "origin")
    edge = Forwarder(net, "edge", cs_capacity_bytes=SIZE)   # cache fits ONE
    fe, fo = link(net, edge, origin, 0.030)
    edge.register_route(Name.parse("/lidc/data"), fe)
    readers = []
    for i in range(3):
        r = Forwarder(net, f"reader{i}", cs_capacity_bytes=4096)
        fr, _ = link(net, r, edge, 0.001)
        r.register_route(Name.parse("/lidc/data"), fr)
        readers.append(r)

    lake = DataLake(segment_size=8192)
    lake.attach(origin)
    names = []
    for d in range(DATASETS):
        n = Name.parse(f"/lidc/data/ds{d:02d}/blob")
        lake.put_bytes(n, bytes([d]) * SIZE)
        names.append(n)

    # 2. arm the manager on the edge: its budget fits three replicas, so
    #    only the zipf head earns a copy and the tail keeps paying the WAN
    mgr = ReplicationManager(
        net, edge,
        policy=ReplicationPolicy(hot_rate=2.0, budget_bytes=3 * SIZE, half_life=4.0)).start()

    rng = random.Random(11)
    weights = [1.0 / (r + 1) ** 1.1 for r in range(DATASETS)]
    done = {"ok": 0}

    def wave(start: float) -> None:
        for k in range(READS_PER_WAVE):
            name = rng.choices(names, weights)[0]
            reader = readers[k % len(readers)]
            net.schedule(start + k * 0.05, lambda n=name, rd=reader: fetch(
                net, rd, n, verify_key=lake.key,
                on_complete=lambda b: done.__setitem__("ok", done["ok"] + 1)))

    def snapshot(label: str, tx0: int) -> int:
        tx = fo.tx_data_bytes
        st = mgr.stats()
        say(f"{label:<18} origin egress {(tx - tx0) / 1024:7.0f} KiB   "
            f"replicas {st['replicas']}  replica serves {st['serves']:3d}  "
            f"delivered {done['ok']}/{READS_PER_WAVE * 2}")
        return tx

    # 3. wave one arrives cold: every read crosses the WAN, demand builds,
    #    and the manager pulls the hot head (one copy each, PIT-deduped)
    wave(0.0)
    net.run(until=10.0)
    t1 = snapshot("wave 1 (cold)", 0)

    # 4. wave two hits the replicas: the head is served at the edge and the
    #    origin sees only the cold tail
    wave(net.now)
    net.run(until=net.now + 10.0)
    t2 = snapshot("wave 2 (hot)", t1)

    st = mgr.stats()
    cold_cost = READS_PER_WAVE * SIZE           # every wave-2 read over the WAN
    offload = 1.0 - (t2 - t1) / cold_cost
    hot = sorted("/".join(k[-2:]) for k in mgr.replicas)
    say(f"\nreplicated {st['replicas']} of {DATASETS} datasets ({hot}; "
        f"{st['bytes_used'] / 1024:.0f} KiB of "
        f"{st['budget_bytes'] / 1024:.0f} KiB budget)\n"
        f"wave 2 origin egress is {offload:.0%} below the replica-free cost "
        f"({cold_cost / 1024:.0f} KiB): only the cold tail still pays the WAN")
    return {"egress": [t1, t2 - t1], "stats": st, "replicated": hot,
            "delivered": done["ok"], "offload": offload, "audit": mgr.audit(lake),
            "virtual_s": net.now}


def main() -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    out = run()
    return 0 if out["delivered"] == READS_PER_WAVE * 2 and out["audit"] == [] else 1


if __name__ == "__main__":
    sys.exit(main())
