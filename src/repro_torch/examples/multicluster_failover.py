"""Fault tolerance: a cluster dies mid-training and the job moves, run by
the port on an H100.

The counterpart of the repo's ``examples/multicluster_failover.py``.
Checkpoints are named data-lake objects and jobs are named computations, so
an Interest expressed again after a cluster fails lands on a surviving
cluster, which resumes from the last named checkpoint; no coordinator is
involved.  The same job then runs unbroken through a fresh overlay, and the
two final losses are compared::

    PYTHONPATH=src python -m repro_torch.examples.multicluster_failover
    PYTHONPATH=src python -m repro_torch.examples.multicluster_failover --smoke --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

from ..ckpt.checkpoint import latest_step
from ..core.jobs import JobSpec
from ..runtime.fleet import build_fleet, resilient_run
from .quickstart import edge_counts

__all__ = ["JOB", "run"]

JOB = {"app": "train", "arch": "lidc-demo", "shape": "custom", "chips": 4, "steps": 20,
       "demo": "failover"}


def _fleet(device, arch):
    return build_fleet(n_clusters=2, chips=16, archs=[arch], ckpt_every=5, device=device)


def _running_cluster(system) -> str:
    """The cluster that runs a job now (the first cluster if none does)."""
    for name, cluster in system.overlay.clusters.items():
        if any(j.state.value == "Running" for j in cluster.jobs.values()):
            return name
    return next(iter(system.overlay.clusters))


def run(device=None, *, arch: str = "lidc-demo", kill_after: int = 10,
        verbose: bool = True) -> Dict[str, Any]:
    """Fail the cluster that runs the job right after it checkpoints step
    ``kill_after``, drive the job to completion with ``resilient_run``, then
    run it unbroken in a fresh overlay."""
    say = print if verbose else (lambda *a, **k: None)
    job = dict(JOB, arch=arch)
    spec = JobSpec(app="train", fields={k: v for k, v in job.items() if k != "app"})
    run_name = f"train-{spec.signature()}"

    system = _fleet(device, arch)
    killed: Dict[str, Any] = {}
    put_json = system.lake.put_json

    def hook(name, obj, **kw):
        r = put_json(name, obj, **kw)
        if ("ckpt" in str(name) and "latest" in str(name) and not killed
                and obj.get("step", 0) >= kill_after):
            victim = _running_cluster(system)
            killed.update(cluster=victim, at=system.net.now, step=obj["step"])
            system.overlay.fail_cluster(victim)
            say(f"*** cluster {victim} went dark at virtual t={system.net.now:.3f}s "
                f"(after checkpointing step {obj['step']}) ***")
        return r

    system.lake.put_json = hook
    say(f"submitting 20-step training job {spec.signature()}")
    t0, v0, e0 = time.perf_counter(), system.net.now, edge_counts(system)
    handle, attempts = resilient_run(system, job)
    failover = {"wall_s": time.perf_counter() - t0, "virtual_s": system.net.now - v0,
                "edge": {k: v - e0[k] for k, v in edge_counts(system).items()}}
    if handle is None or handle.state != "Completed":
        raise RuntimeError(f"the job did not complete: {handle and handle.state} "
                           f"({handle and handle.error})")
    say(f"\ncompleted on      : {handle.result['cluster']}")
    say(f"attempts          : {attempts}")
    say(f"resumed from step : {handle.result['resumed_from']}")
    say(f"checkpoint now at : step {latest_step(system.lake, run_name)}")
    say(f"final loss        : {handle.result['final_loss']!r}")

    fresh = _fleet(device, arch)
    t1 = time.perf_counter()
    whole, _ = resilient_run(fresh, job)
    unbroken = {"wall_s": time.perf_counter() - t1, "virtual_s": fresh.net.now}
    if whole is None or whole.state != "Completed":
        raise RuntimeError(f"the unbroken run did not complete: {whole and whole.state}")
    say(f"unbroken run loss : {whole.result['final_loss']!r} "
        f"({'bit-equal' if whole.result['final_loss'] == handle.result['final_loss'] else 'differs'})")
    return {"system": system, "handle": handle, "attempts": attempts, "killed": killed,
            "run_name": run_name, "latest_step": latest_step(system.lake, run_name),
            "unbroken": whole, "failover": failover, "unbroken_run": unbroken}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="train lidc-demo-smoke")
    args = ap.parse_args()
    out = run(args.device, arch="lidc-demo-smoke" if args.smoke else "lidc-demo")
    ok = (out["handle"].result["resumed_from"] == 10
          and out["handle"].result["final_loss"] == out["unbroken"].result["final_loss"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
