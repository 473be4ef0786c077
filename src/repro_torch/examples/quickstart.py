"""Quickstart: the paper's whole story, run by the port on an H100.

The counterpart of the repo's ``examples/quickstart.py``: three clusters
join a decentralized overlay built from the port's control plane
(``repro_torch.core``), a semantically named training job is expressed into
the network (no cluster is ever addressed), the client polls the status
protocol, fetches the result by its name, and an identical request is
answered from the result cache without a new job::

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --smoke --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

from ..runtime.fleet import build_fleet

__all__ = ["JOB", "edge_counts", "run"]

# /lidc/compute/train/lidc-demo/custom/chips=4&steps=15
JOB = {"app": "train", "arch": "lidc-demo", "shape": "custom", "chips": 4, "steps": 15}


def edge_counts(system) -> Dict[str, int]:
    """The Interests, Data and Nacks the edge router has seen so far, and
    its Content Store hits."""
    st = system.overlay.edge.stats
    return {"interests": st["in_interest"], "data": st["in_data"],
            "nacks": st["in_nack"], "cs_hits": st["cs_hit"]}


def _jobs(system) -> int:
    return sum(len(c.jobs) for c in system.overlay.clusters.values())


def run(device=None, *, arch: str = "lidc-demo", verbose: bool = True) -> Dict[str, Any]:
    """Run the job and its repeat; returns both handles, the jobs the repeat
    spawned, the edge's counts and the virtual and wall seconds of each."""
    say = print if verbose else (lambda *a, **k: None)
    # 1. three H100 clusters join the overlay; each announces its named
    #    capabilities, and there is no controller
    system = build_fleet(n_clusters=3, chips=16, archs=[arch], ckpt_every=10,
                         device=device)
    # 2. the client says what it wants, never where
    job = dict(JOB, arch=arch)
    say("expressing Interest for:", job)
    t0, v0, e0 = time.perf_counter(), system.net.now, edge_counts(system)
    handle = system.client.run_job(job)
    first = {"wall_s": time.perf_counter() - t0, "virtual_s": system.net.now - v0,
             "edge": {k: v - e0[k] for k, v in edge_counts(system).items()}}
    if handle is None:
        raise RuntimeError("no cluster picked the job up")
    if handle.state == "Completed":
        say(f"placed on cluster : {handle.result['cluster']}")
        say(f"final state       : {handle.state}")
        say(f"status polls      : {len(handle.status_history)}")
        say(f"final train loss  : {handle.result['final_loss']:.4f}")
        say(f"result published  : {handle.receipt['result_name']}")
    else:
        say(f"final state       : {handle.state} ({handle.error})")
    # 3. an identical request (the same canonical name) never recomputes:
    #    the network answers from the Content Store / result cache
    jobs_before, e1, v1, t1 = _jobs(system), edge_counts(system), system.net.now, \
        time.perf_counter()
    again = system.client.run_job(job)
    repeat = {"wall_s": time.perf_counter() - t1, "virtual_s": system.net.now - v1,
              "edge": {k: v - e1[k] for k, v in edge_counts(system).items()}}
    new_jobs = _jobs(system) - jobs_before
    say(f"repeat request    : state={again.state if again else None}, "
        f"new jobs spawned={new_jobs} (cache hit)")
    return {"system": system, "handle": handle, "again": again, "new_jobs": new_jobs,
            "first": first, "repeat": repeat}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="train lidc-demo-smoke")
    args = ap.parse_args()
    out = run(args.device, arch="lidc-demo-smoke" if args.smoke else "lidc-demo")
    ok = (out["handle"].state == "Completed" and out["again"] is not None
          and out["again"].state == "Completed" and out["new_jobs"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
