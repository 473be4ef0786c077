"""Two tenants, one burst, one preemption, one spill: a printed timeline.

The port's counterpart of the repo's ``examples/multitenant_scheduling.py``,
on the port's control plane (``repro_torch.core``).  A 3-cluster fleet runs
two tenants:

* **batch** submits one wide, phased training-style job (low priority,
  checkpoints at every phase boundary), and
* **live** bursts short urgent jobs (prio=5) that preempt the batch job at
  its next checkpoint.

A second wave of live jobs arrives at a cluster that is already full: past
its spill threshold the gateway *re-expresses the Interest upstream* and a
peer cluster answers, all in-band.  The jobs are simulated on the virtual
clock; nothing runs on the card::

    PYTHONPATH=src python -m repro_torch.examples.multitenant_scheduling
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

from ..core.cluster import ComputeCluster, ExecPlan, ExecResult
from ..core.compute_plane import SchedulerConfig
from ..core.matchmaker import ServiceEndpoint
from ..core.names import canonical_job_name
from ..core.overlay import LidcSystem
from ..core.packets import Interest
from ..core.validation import ValidatorRegistry

__all__ = ["run"]


def _sim_executor(log):
    def executor(job, cluster):
        f = job.spec.fields
        dur, phases = float(f.get("d", 1.0)), int(f.get("phases", 0))
        uid = f.get("u", job.job_id)
        net = cluster.net
        log(net, f"{uid:<10} starts on {cluster.name} "
                 f"(chips={job.granted_chips}, prio={job.spec.priority})")
        if phases <= 0:
            return ExecResult(payload={"u": uid}, duration=dur)

        def phase_fn(i):
            return lambda: log(net, f"{uid:<10} checkpoint after phase {i} on {cluster.name}")

        return ExecPlan(phases=[(dur / phases, phase_fn(i)) for i in range(phases)],
                        finalize=lambda: ExecResult(payload={"u": uid}, duration=0.0))
    return executor


def run(*, verbose: bool = True) -> Dict[str, Any]:
    """Run both tenants' jobs to their end; returns the timeline and the
    completed jobs, preemptions and spills."""
    say = print if verbose else (lambda *a, **k: None)
    timeline = []

    def log(net, event):
        timeline.append((net.now, event))

    reg = ValidatorRegistry()
    reg.register("sim", lambda fields, caps: None)
    sys_ = LidcSystem()
    for name in ("pod-a", "pod-b", "pod-c"):
        cluster = ComputeCluster(sys_.net, name, chips=8, lake=sys_.lake, max_queue_depth=8,
                                 scheduler_config=SchedulerConfig(spill_queue_depth=1))
        cluster.add_endpoint(ServiceEndpoint(service="sim.svc", app="sim",
                                             executor=_sim_executor(log)))
        sys_.overlay.add_cluster(cluster, validators=reg)
    sys_.net.run(until=0.2)             # capability gossip converges

    def submit(t, fields, uid):
        def go():
            log(sys_.net, f"{uid:<10} submitted (prio={fields.get('prio', 0)})")
            sys_.client.consumer.express(
                Interest(name=canonical_job_name(fields), lifetime=3.0, must_be_fresh=True),
                on_data=lambda d: log(
                    sys_.net,
                    f"{uid:<10} receipt: {d.json()['state']:<9} @ {d.json()['cluster']}"
                    + (f" (spilled via {d.json()['spilled_via']})"
                       if "spilled_via" in d.json() else "")
                    + (f" eta={d.json()['eta']:.2f}s" if "eta" in d.json() else "")),
                on_fail=lambda r: log(sys_.net, f"{uid:<10} failed: {r}"),
                retries=4)
        sys_.net.schedule(max(0.0, t - sys_.net.now), go)

    # tenant "batch": one wide phased job on the whole of one cluster
    submit(0.30, {"app": "sim", "chips": 8, "d": 4.0, "phases": 8, "u": "batch-1"}, "batch-1")
    # tenant "live": an urgent burst that lands on every cluster; the one
    # sharing a cluster with batch-1 preempts it at the next checkpoint
    for i in range(3):
        submit(1.00 + 0.01 * i, {"app": "sim", "chips": 8, "d": 0.8, "prio": 5,
                                 "u": f"live-{i}"}, f"live-{i}")
    # second wave: by now every cluster is busy; whoever receives these
    # sheds them upstream (spill) or quotes an ETA
    for i in range(3, 5):
        submit(1.30 + 0.01 * i, {"app": "sim", "chips": 4, "d": 0.5, "prio": 5,
                                 "u": f"live-{i}"}, f"live-{i}")
    sys_.net.run()

    say("=== multitenant timeline (virtual seconds) ===")
    for t, event in timeline:
        say(f"  t={t:7.3f}  {event}")
    preemptions = sum(c.scheduler.stats["preemptions"] for c in sys_.overlay.clusters.values())
    spills = sum(gw.spills for gw in sys_.overlay.gateways.values())
    done = sum(c.completed_jobs for c in sys_.overlay.clusters.values())
    say(f"\ncompleted={done} preemptions={preemptions} spills={spills}")
    return {"timeline": timeline, "completed": done, "preemptions": preemptions,
            "spills": spills, "virtual_s": sys_.net.now}


def main() -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    return 0 if run()["completed"] == 6 else 1


if __name__ == "__main__":
    sys.exit(main())
