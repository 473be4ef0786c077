"""Elastic map fan-out: a 10,000-task word count with no coordinator.

The port's counterpart of the repo's ``examples/elastic_map.py``, on the
port's task map (``repro_torch.workflow.taskmap``).  Stores a ~40 MiB
corpus in the data lake, then runs ``map_reduce(wordcount,
wordcount-reduce, corpus)``: partition discovery reads the lake manifest
and tiles the 10,000 segments into 10,000 tasks, batched submission fans
them out across 50 clusters with ~80 Interests (not 10,000), a per-cluster
completion monitor coalesces status polls, and speculative re-execution
races any straggler against a second replica; the result cache makes
whichever finishes first the only effective execution.  Everything runs
on the virtual clock, on the host::

    PYTHONPATH=src python -m repro_torch.examples.elastic_map
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

from ..core.names import DATA_PREFIX, Name
from ..workflow.taskmap import TaskMapExecutor, build_taskmap_fleet

__all__ = ["RECORD", "SEGMENT", "TASKS", "run"]

RECORD = b"alpha bravo charlie delta echo foxtrot golf hotel indigo juliet "
SEGMENT = 4096                        # 64 records per segment
TASKS = 10_000


def run(*, tasks: int = TASKS, clusters: int = 50, chips: int = 200,
        verbose: bool = True) -> Dict[str, Any]:
    """The word count over ``tasks`` segments on ``clusters`` clusters, then
    a 256-task map on a fresh 8-cluster fleet with one cluster 10x slow;
    returns both runs' counts."""
    say = print if verbose else (lambda *a, **k: None)
    # 1. the clusters join the overlay; the corpus is segmented into the
    #    shared data lake.  No scheduler, no task queue, no job server.
    system, log = build_taskmap_fleet(n_clusters=clusters, chips=chips,
                                      segment_size=SEGMENT)
    corpus = Name.parse(DATA_PREFIX).append("text", "corpus")
    system.lake.put_bytes(corpus, RECORD * (SEGMENT // len(RECORD)) * tasks)
    system.net.run(until=system.net.now + 5)        # capability gossip

    # 2. one call compiles map(fn, dataset) into named compute tasks
    tm = TaskMapExecutor.for_system(system, batch_size=128)
    run1 = tm.map_reduce("wordcount", "wordcount-reduce", corpus)
    if run1.failed is not None:
        raise RuntimeError(run1.failed)
    words = run1.reduce_result["count"]
    say(f"tasks             : {run1.tasks}")
    say(f"delivery          : {run1.delivery:.3f}")
    say(f"global word count : {words:,}")
    say(f"clusters used     : {len(log.clusters_used())}")
    say(f"virtual makespan  : {run1.makespan:.3f} s")
    say(f"submit Interests  : {tm.submit_interests}  "
        f"({run1.tasks / max(1, tm.submit_interests):.0f} tasks per Interest)")
    say(f"status Interests  : {tm.status_interests}")
    say(f"per-task overhead : "
        f"{(tm.submit_interests + tm.status_interests) / run1.tasks:.4f} Interests/task")
    say(f"executions        : {log.total} (re-executed: {len(log.reexecuted())})")

    # 3. a gray failure on a fresh fleet: one cluster silently runs 10x
    #    slow; the monitor speculates its stragglers toward healthy
    #    clusters, and the result cache absorbs the losers
    gray, gray_log = build_taskmap_fleet(n_clusters=8, chips=32, segment_size=SEGMENT)
    corpus2 = Name.parse(DATA_PREFIX).append("text", "corpus2")
    gray.lake.put_bytes(corpus2, RECORD * (SEGMENT // len(RECORD)) * 256)
    gray.net.run(until=gray.net.now + 5)
    gray.overlay.clusters["tmpod1"].time_dilation = 10.0
    tm2 = TaskMapExecutor.for_system(gray, batch_size=32)
    run2 = tm2.map("wordcount", corpus2, cost=2.0)
    if run2.failed is not None:
        raise RuntimeError(run2.failed)
    say("\nwith a 10x-slow cluster seeded (fresh 8-cluster fleet):")
    say(f"delivery          : {run2.delivery:.3f}")
    say(f"speculated tasks  : {len(run2.speculated)}")
    say(f"speculation wins  : {run2.spec_wins}")
    say(f"executions        : {gray_log.total} for {run2.tasks} tasks "
        f"({gray_log.total / run2.tasks:.3f}x amplification)")
    say(f"virtual makespan  : {run2.makespan:.3f} s "
        "(a 2 s task on the slow cluster holds its chip for 20 s)")
    return {"map_reduce": {"tasks": run1.tasks, "delivery": run1.delivery, "words": words,
                           "clusters_used": len(log.clusters_used()),
                           "makespan": run1.makespan,
                           "submit_interests": tm.submit_interests,
                           "status_interests": tm.status_interests,
                           "executions": log.total, "reexecuted": len(log.reexecuted())},
            "gray": {"tasks": run2.tasks, "delivery": run2.delivery,
                     "speculated": len(run2.speculated), "spec_wins": run2.spec_wins,
                     "executions": gray_log.total, "makespan": run2.makespan}}


def main() -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    out = run()
    return 0 if out["map_reduce"]["delivery"] == 1.0 and out["gray"]["delivery"] == 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
