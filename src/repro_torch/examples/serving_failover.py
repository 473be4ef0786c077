"""Serving failover: a cluster dies mid-decode, the stream resumes.

The port's counterpart of the repo's ``examples/serving_failover.py``, on
the port's control plane and serving plane (``repro_torch.core``,
``repro_torch.serve.plane``).  An inference session is a *named
computation* (/lidc/serve/<model>/...) and its KV cache is *named data*
(/lidc/data/kv/... and /lidc/data/serve/sess/...).  So when the cluster
that is decoding a session goes dark, the client's retransmitted session
Interest routes to a surviving cluster, which fetches the named KV
checkpoint through the segment pipeline and continues the decode: the
delivered token stream is bit-identical to an uninterrupted run, and no
coordinator is told.  Decode is the plane's model of it (``token_at``), on
the virtual clock; nothing runs on the card::

    PYTHONPATH=src python -m repro_torch.examples.serving_failover
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

from ..core.cluster import ComputeCluster
from ..core.compute_plane import SchedulerConfig
from ..core.overlay import LidcSystem
from ..core.strategy import AdaptiveStrategy
from ..core.validation import default_registry
from ..datalake.kv import prompt_digest, session_ckpt_name
from ..serve.plane import ServeModelSpec, ServingPlane, SessionClient, token_at

__all__ = ["MODEL", "MAX_NEW", "PROMPT", "KILL_AT", "run"]

MODEL = "qwen3-1.7b"
MAX_NEW = 80
PROMPT = list(range(64))
KILL_AT = 1.5          # virtual seconds after the session starts


def run(*, verbose: bool = True) -> Dict[str, Any]:
    """Start a session on three clusters, fail the one decoding it at
    ``KILL_AT`` and drive the stream to its end; returns the survivor, the
    planes' counters, the client's result, the last checkpoint, the oracle's
    stream and the virtual end time."""
    say = print if verbose else (lambda *a, **k: None)
    system = LidcSystem(strategy=AdaptiveStrategy(
        probe_fanout=1, rotate_cold_probes=True, cost_bias=1.0, eta_weight=1.0))
    planes = {}
    for i in range(3):
        cl = ComputeCluster(system.net, f"pod{i}", chips=4, lake=system.lake,
                            max_queue_depth=8,
                            scheduler_config=SchedulerConfig(spill_queue_depth=2))
        # slow decode (50 ms/step) so the kill lands mid-stream
        planes[cl.name] = ServingPlane(cl, ServeModelSpec(model=MODEL, decode_step_s=0.05))
        system.overlay.add_cluster(cl, validators=default_registry(), latency=0.002)
    system.net.run(until=0.25)

    client = SessionClient(system.net, system.overlay.edge, system.lake, stall_timeout=1.5)
    say(f"starting session: {MAX_NEW} tokens of {MODEL}, {len(PROMPT)}-token prompt")
    result = client.start("demo-1", MODEL, PROMPT, max_new=MAX_NEW)
    killed: Dict[str, Any] = {}

    def kill():
        for name, plane in planes.items():
            if plane.stats["sessions"] > 0:
                done = sum(len(t) for t in result.tokens.values())
                killed.update(name=name, at=system.net.now, delivered=done)
                say(f"*** {name} went dark at virtual t={system.net.now:.2f}s "
                    f"with {done}/{MAX_NEW} tokens delivered ***")
                system.overlay.fail_cluster(name)
                return

    system.net.schedule(KILL_AT, kill)
    system.net.run(until=60.0)
    system.net.run()
    if not killed:
        raise RuntimeError("no cluster was serving the session")
    if not result.finished:
        raise RuntimeError(f"the session did not finish ({result.failed})")

    survivor = next(n for n, p in planes.items()
                    if n != killed["name"] and p.stats["resumes"] > 0)
    stats = planes[survivor].stats
    ckpt = system.lake.get_json(session_ckpt_name("demo-1"))
    say(f"\nresumed on        : {survivor}")
    say(f"named KV fetched  : {stats['kv_bytes_fetched'] / 2**20:.1f} MiB "
        f"({stats['kv_fetches']} fetch)")
    say(f"client resubmits  : {result.resubmits} "
        f"(stall -> re-expressed the same canonical session name)")
    say(f"final checkpoint  : tokens_done={ckpt['tokens_done']} on {ckpt['cluster']}")

    want = [token_at(prompt_digest(PROMPT), i) for i in range(MAX_NEW)]
    if result.stream() == want:
        say(f"\nstream check      : {MAX_NEW}/{MAX_NEW} tokens bit-identical "
            f"to an uninterrupted decode")
        say("\nTakeaway: sessions are named computations and KV caches are "
            "named data, so failover\nis just Interest retransmission plus a "
            "named fetch — no session manager, no replay.")
    return {"system": system, "planes": planes, "result": result, "killed": killed,
            "survivor": survivor, "stats": dict(stats), "ckpt": ckpt, "want": want,
            "virtual_s": system.net.now}


def main() -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
    out = run()
    return 0 if out["result"].stream() == out["want"] else 1


if __name__ == "__main__":
    sys.exit(main())
