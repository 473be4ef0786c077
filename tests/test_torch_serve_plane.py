"""The port's named serving plane (``repro_torch.serve.plane``) against the
reference's (``repro.serve.plane``) on the same inputs, and the port's
``serving_failover`` and ``serve_batched`` examples.

Each scenario of ``tests/test_serving_plane.py`` runs on each package: a
streamed session, the serving cluster failed mid-decode and the session
resumed elsewhere from its named KV, a second session reusing a prompt
prefix's named KV blocks computed on another cluster, sessions beyond a
cluster's queue answered busy or spilled, a receipt-only session and a
refused family.  The streams, the planes' counters, the client's results
(TTFT, resubmits, failures), every job's placement and times, the lake's
names, the edge's counters, the clock and the event trace must be
identical.  The session ETA is the plane's structural one on both.
"""

import pytest

from torch_parity import on_both, package, reference_example, renumber

MODEL = "qwen3-1.7b"


def build(p, n=3, *, decode_step_s=0.02, spill_queue_depth=2, chips=4, engine="calendar",
          max_queue_depth=8):
    sys_ = p.overlay.LidcSystem(engine=engine, strategy=p.strategy.AdaptiveStrategy(
        probe_fanout=1, rotate_cold_probes=True, cost_bias=1.0, eta_weight=1.0))
    sys_.net.trace = []
    planes = {}
    for i in range(n):
        cfg = p.compute_plane.SchedulerConfig(spill_queue_depth=spill_queue_depth)
        cl = p.cluster.ComputeCluster(sys_.net, f"pod{i}", chips=chips, lake=sys_.lake,
                                      hbm_gb_per_chip=16.0, max_queue_depth=max_queue_depth,
                                      scheduler_config=cfg)
        planes[cl.name] = p.plane.ServingPlane(
            cl, p.plane.ServeModelSpec(model=MODEL, decode_step_s=decode_step_s))
        sys_.overlay.add_cluster(cl, validators=p.validation.default_registry(),
                                 latency=0.002)
    sys_.net.run(until=0.25)
    return sys_, planes


def session_view(r):
    return (r.sid, r.submitted_at, r.receipt_cluster, r.ttft, r.finished_at,
            sorted(r.tokens.items()), r.resubmits, r.failed)


def system_view(sys_, planes):
    jobs = sorted((c.name, j.job_id, j.state.value, j.started_at, j.finished_at,
                   j.granted_chips, j.preemptions, j.error)
                  for c in sys_.overlay.clusters.values() for j in c.jobs.values())
    gws = {n: (g.cache_shortcuts, g.busy_receipts, g.spills, sorted(g.rejections.items()))
           for n, g in sys_.overlay.gateways.items()}
    return {"planes": {n: dict(pl.stats) for n, pl in planes.items()}, "jobs": jobs,
            "gateways": gws, "lake": sorted(sys_.lake.names()),
            "edge": sorted(sys_.overlay.edge.stats.items()), "now": sys_.net.now,
            "events": sys_.net.events_processed, "trace": sys_.net.trace}


def streamed(p, engine):
    sys_, planes = build(p, engine=engine)
    client = p.plane.SessionClient(sys_.net, sys_.overlay.edge, sys_.lake)
    r = client.start("t-1", MODEL, list(range(70)), max_new=20)
    sys_.net.run()
    return session_view(r), sys_.lake.get_json(p.kv.session_ckpt_name("t-1")), \
        system_view(sys_, planes)


def failover(p, engine):
    sys_, planes = build(p, decode_step_s=0.05, engine=engine)
    client = p.plane.SessionClient(sys_.net, sys_.overlay.edge, sys_.lake, stall_timeout=1.5)
    r = client.start("k-1", MODEL, list(range(64)), max_new=80)
    killed = []

    def kill():
        for name, pl in planes.items():
            if pl.stats["sessions"] > 0:
                killed.append((name, sys_.net.now))
                sys_.overlay.fail_cluster(name)
                return
    sys_.net.schedule(1.5, kill)
    sys_.net.run(until=60.0)
    sys_.net.run()
    return killed, session_view(r), r.stream(), \
        sys_.lake.get_json(p.kv.session_ckpt_name("k-1")), system_view(sys_, planes)


def prefix_reuse(p, engine):
    sys_, planes = build(p, engine=engine)
    client = p.plane.SessionClient(sys_.net, sys_.overlay.edge, sys_.lake)
    system_prompt = list(range(96))
    first = client.start("p-1", MODEL, system_prompt + [1000, 1001], max_new=8)
    sys_.net.run()
    second = client.start("p-2", MODEL, system_prompt + [2000, 2001], max_new=8)
    sys_.net.run()
    return session_view(first), session_view(second), system_view(sys_, planes)


def busy_and_spill(p, engine):
    """Eight sessions at once on two one-chip-per-session clusters whose
    queues hold two: busy receipts, spill, and queued sessions."""
    sys_, planes = build(p, n=2, chips=2, spill_queue_depth=1, max_queue_depth=2,
                         engine=engine)
    client = p.plane.SessionClient(sys_.net, sys_.overlay.edge, sys_.lake, stall_timeout=6.0)
    results = [client.start(f"b-{i}", MODEL, list(range(10 * i, 10 * i + 40)), max_new=12,
                            priority=i % 2)
               for i in range(8)]
    sys_.net.run()
    return [session_view(r) for r in results], system_view(sys_, planes)


def receipt_only_and_refused(p, engine):
    sys_, planes = build(p, n=2, engine=engine)
    client = p.plane.SessionClient(sys_.net, sys_.overlay.edge, sys_.lake)
    zero = client.start("z-1", MODEL, list(range(10)), max_new=0)
    bad = client.start("bad-1", MODEL, list(range(10)), max_new=4, family="moe")
    sys_.net.run()
    return session_view(zero), session_view(bad), system_view(sys_, planes)


SCENARIOS = {"streamed": streamed, "failover": failover, "prefix_reuse": prefix_reuse,
             "busy_and_spill": busy_and_spill,
             "receipt_only_and_refused": receipt_only_and_refused}


@pytest.mark.parametrize("engine", ["heap", "calendar"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_serving_scenarios_match_the_reference(monkeypatch, scenario, engine):
    got = on_both(monkeypatch, SCENARIOS[scenario], engine)
    assert got["port"] == got["reference"]


def test_serving_outcomes_on_the_port():
    """What ``test_serving_plane.py`` asserts of the reference, on the port:
    the oracle's stream after a failover, prefix hits, busy or spill."""
    p = package("port")
    killed, view, stream, ckpt, system = failover(p, "calendar")
    pd = p.kv.prompt_digest(list(range(64)))
    assert killed and view[4] is not None and view[6] >= 1
    assert stream == [p.plane.token_at(pd, i) for i in range(80)]
    assert ckpt["tokens_done"] == 80 and ckpt["cluster"] != killed[0][0]
    survivors = [s for n, s in system["planes"].items() if n != killed[0][0]]
    assert sum(s["resumes"] for s in survivors) >= 1
    assert sum(s["kv_fetches"] for s in survivors) >= 1
    *_, reused = prefix_reuse(p, "calendar")
    assert sum(s["prefix_hits"] for s in reused["planes"].values()) >= 1
    assert sum(s["prefix_blocks_hit"] for s in reused["planes"].values()) >= 3
    sessions, crowded = busy_and_spill(p, "calendar")
    assert all(v[4] is not None for v in sessions)
    assert any(busy or spills for _, busy, spills, _ in crowded["gateways"].values())
    zero, bad, _ = receipt_only_and_refused(p, "calendar")
    assert zero[4] is not None and not zero[5]
    assert bad[4] is None and bad[7] is not None


def test_session_eta_is_structural_on_both(monkeypatch):
    def scenario(p):
        sys_, planes = build(p, n=1)
        cl = next(iter(sys_.overlay.clusters.values()))
        return (cl.scheduler.run_estimate(p.jobs.JobSpec(
                    app="serve", fields={"arch": MODEL, "ptoks": 8000, "max_new": 100})),
                cl.scheduler.run_estimate(p.jobs.JobSpec(app="train", fields={})),
                sorted(str(x) for x in cl.advertised_prefixes()), cl.capabilities())

    got = on_both(monkeypatch, scenario)
    assert got["port"] == got["reference"]
    assert got["port"][0] == pytest.approx(8000 / 8000.0 + 100 * 0.02)


def test_token_at_matches_the_reference():
    ref, port = package("reference").plane, package("port").plane
    for digest in ("", "ab12cd34", package("port").kv.prompt_digest(range(64))):
        for vocab in (2, 32000, 151936):
            assert [port.token_at(digest, i, vocab) for i in range(50)] == \
                [ref.token_at(digest, i, vocab) for i in range(50)]


def test_serve_package_exports_the_engine_and_the_plane():
    import repro_torch.serve as serve
    from repro_torch.serve import ServeEngine, ServingPlane, SessionClient, token_at  # noqa
    from repro_torch.serve.engine import ServeEngine as Engine
    from repro_torch.serve.plane import ServingPlane as Plane

    assert ServeEngine is Engine and ServingPlane is Plane
    assert set(package("reference").plane.__all__) <= set(serve.__all__)


# ----------------------------------------------------------------- examples

def test_serving_failover_example_prints_what_the_reference_prints(capsys):
    from repro_torch.examples import serving_failover

    out = serving_failover.run()
    assert capsys.readouterr().out == reference_example("serving_failover")
    assert out["result"].stream() == out["want"]
    assert out["ckpt"]["tokens_done"] == serving_failover.MAX_NEW


def test_serve_batched_example_matches_the_reference_engine_and_fleet(monkeypatch):
    """``serve_batched --smoke --device cpu``: the engine's counts are the
    reference engine's on the same config and requests, and the six serve
    jobs are placed, timed and answered as the reference's fleet places them
    (the reference's JAX engine behind its executors)."""
    import jax
    import numpy as np

    from repro.configs.base import smoke_of
    from repro.core.strategy import LoadShareStrategy
    from repro.models import bundle_for
    from repro.runtime.fleet import build_fleet
    from repro.serve.engine import ServeEngine
    from repro_torch.examples import serve_batched

    def reference_run():
        cfg = smoke_of("lidc-demo")
        eng = ServeEngine(cfg, bundle_for(cfg).init(cfg, jax.random.PRNGKey(0)),
                          max_batch=4, max_seq=64)
        rng = np.random.default_rng(0)
        for _ in range(serve_batched.REQUESTS):
            eng.submit(list(rng.integers(0, cfg.vocab, 6)), max_new=8)
        done = eng.run()
        system = build_fleet(3, chips=16, archs=["lidc-demo-smoke"],
                             strategy=LoadShareStrategy())
        handles = [system.client.run_job({"app": "serve", "arch": "lidc-demo-smoke",
                                          "requests": 4, "new_tokens": 8, "batch": i})
                   for i in range(serve_batched.JOBS)]
        return ({"requests": len(done), "tokens_out": eng.tokens_out,
                 "decode_steps": eng.decode_steps}, handles, system.net.now)

    def view(handles):
        return [(h.state, h.receipt, h.status_history, h.result) for h in handles]

    renumber(monkeypatch, "reference")
    ref_engine, ref_handles, ref_now = reference_run()
    renumber(monkeypatch, "port")
    out = serve_batched.run("cpu", arch="lidc-demo-smoke", verbose=False)
    assert out["engine"] == ref_engine
    assert view(out["handles"]) == view(ref_handles)
    assert out["virtual_s"] == ref_now
    assert all(h.result["real_compute"] for h in out["handles"])
    assert len(out["clusters"]) >= 2
