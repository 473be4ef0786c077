"""The port's workflows (``repro_torch.workflow``: the DAG model, the engine,
the shard / align / merge applications and the fault injector) against the
reference's (``repro.workflow``) on the same inputs, and the port's
``genomics_workflow`` and ``multitenant_scheduling`` examples.

Each scenario of ``tests/test_workflow.py``, ``test_workflow_faults.py`` and
``test_chaos_faults.py`` runs on each package: the scatter-gather (load
shared, and spread by cold-probe rotation), stages deduplicated within a
workflow, a workflow run twice and served from the cache, a shared
sub-workflow, busy receipts and coalesced status polls on a saturated
cluster, a cluster crash mid-align, a partition that heals, delayed links,
lossy links under a seeded ``FaultInjector``, and every gray fault (flap,
one-way partition, slow node, corruption, duplication, reordering).  The
engine's trace, every stage's status, attempts, cluster and times, the sink
results, the execution log, the injector's trace, the clock and the event
trace must be identical.
"""

import pytest

from torch_parity import on_both, package, reference_example, renumber

DATASET = "/lidc/data/reads/sample"


def blast_spec(p, dataset=DATASET, parts=4, tag="t", name=None):
    return (p.dag.WorkflowSpec(name or f"blast-{tag}")
            .stage("shard", "wf-shard", inputs=[dataset], parts=parts, tag=tag)
            .stage("align", "wf-align", inputs=["@shard"], fanout=parts, tag=tag)
            .stage("merge", "wf-merge", inputs=["@align"], tag=tag))


def fleet(p, n=3, strategy=None, data_bytes=128 * 1024, dataset=DATASET, engine="calendar"):
    system, log = p.apps.build_workflow_fleet(n, chips=4, strategy=strategy, engine=engine)
    system.lake.put_bytes(p.names.Name.parse(dataset),
                          bytes(range(256)) * (data_bytes // 256))
    system.net.trace = []
    return system, log


def workflow_view(wf):
    return [(i, str(s.request_name), str(s.result_name), s.deps, sorted(s.fields.items()))
            for i, s in wf.instances.items()]


def run_view(run):
    stages = {i: (s.status, s.attempts, s.waiting_on, s.receipt, s.cluster, s.from_cache,
                  s.submitted_at, s.completed_at, s.noroute_retries, s.busy_retries)
              for i, s in run.stages.items()}
    return {"trace": run.trace, "stages": stages, "results": run.results,
            "started": run.started_at, "finished": run.finished_at, "failed": run.failed,
            "complete": run.complete, "cache_hits": run.cache_hits,
            "resubmissions": run.resubmissions}


def system_view(system, log):
    return {"log": log.events, "now": system.net.now, "events": system.net.events_processed,
            "trace": system.net.trace, "lake": sorted(system.lake.names()),
            "edge": sorted(system.overlay.edge.stats.items())}


def engine_of(p, system, **kw):
    return p.engine.WorkflowEngine(system.net, system.overlay.edge, **kw)


def scatter_gather(p):
    system, log = fleet(p, strategy=p.strategy.LoadShareStrategy())
    wf = blast_spec(p).compile()
    run = engine_of(p, system).run(wf)
    return workflow_view(wf), run_view(run), system_view(system, log)


def spread(p):
    system, log = fleet(p, 4, strategy=p.strategy.AdaptiveStrategy(
        probe_fanout=1, rotate_cold_probes=True))
    run = engine_of(p, system).run(blast_spec(p).compile())
    return run_view(run), system_view(system, log)


def dedup_within(p):
    system, log = fleet(p, strategy=p.strategy.LoadShareStrategy())
    wf = p.dag.WorkflowSpec("dedup")
    wf.stage("shard", "wf-shard", inputs=[DATASET], parts=2)
    wf.stage("m1", "wf-merge", inputs=["@shard"])
    wf.stage("m2", "wf-merge", inputs=["@shard"])
    compiled = wf.compile()
    run = engine_of(p, system).run(compiled)
    return workflow_view(compiled), run_view(run), system_view(system, log)


def cached_twice(p):
    system, log = fleet(p, strategy=p.strategy.LoadShareStrategy())
    run1 = engine_of(p, system).run(blast_spec(p).compile())
    run2 = engine_of(p, system).run(blast_spec(p).compile())
    return run_view(run1), run_view(run2), system_view(system, log)


def shared_subworkflow(p):
    system, log = fleet(p, strategy=p.strategy.LoadShareStrategy())
    run1 = engine_of(p, system).run(blast_spec(p).compile())
    wf2 = (p.dag.WorkflowSpec("blast-roc")
           .stage("shard", "wf-shard", inputs=[DATASET], parts=4, tag="t")
           .stage("align", "wf-align", inputs=["@shard"], fanout=4, tag="t")
           .stage("merge", "wf-merge", inputs=["@align"], tag="different"))
    run2 = engine_of(p, system).run(wf2.compile())
    return run_view(run1), run_view(run2), system_view(system, log)


def busy_backoff(p):
    system, log = fleet(p, 1)
    cluster = next(iter(system.overlay.clusters.values()))
    cluster.add_endpoint(p.core.ServiceEndpoint(
        service="hog.svc", app="hog",
        executor=lambda job, cl: p.cluster.ExecResult(payload={}, duration=20.0)))
    cluster.submit(p.jobs.JobSpec(app="hog", fields={"chips": cluster.chips}), now=0.0)
    run = engine_of(p, system).run(blast_spec(p, parts=2, tag="busy").compile())
    return run_view(run), system_view(system, log)


def coalesced_polls(p):
    system, log = fleet(p, 1)
    eng = engine_of(p, system)
    run = eng.run(blast_spec(p, parts=6, tag="coal").compile())
    return run_view(run), eng.stage_polls, eng.status_interests, system_view(system, log)


# ---- faults (tests/test_workflow_faults.py's fleet: 6 MiB over 6 clusters)

BIG = "/lidc/data/reads/big"


def fault_build(p, tag, *, seed=7, engine="calendar", n=6, parts=6,
                data_bytes=6 * 2 ** 20):
    system, log = fleet(p, n, strategy=p.strategy.AdaptiveStrategy(
        probe_fanout=1, rotate_cold_probes=True), data_bytes=data_bytes, dataset=BIG,
        engine=engine)
    wf = blast_spec(p, dataset=BIG, parts=parts, tag=tag).compile()
    return system, log, wf, engine_of(p, system), p.faults.FaultInjector(system.net, seed=seed)


def first_align_cluster(log):
    return next(c for _, app, c, _ in log.events if app == "wf-align")


def crash_mid_stage(p):
    system, log, wf, eng, inj = fault_build(p, "t")
    run = eng.start(wf)

    def crash():
        victim = first_align_cluster(log)
        system.overlay.fail_cluster(victim)
        inj.trace.append((round(system.net.now, 9), "crash-cluster", victim))

    system.net.schedule(0.45, crash)
    system.net.run()
    return run_view(run), inj.trace, log.reexecuted(), system_view(system, log)


def partition_heals(p):
    system, log, wf, eng, inj = fault_build(p, "part")
    run = eng.start(wf)

    def cut():
        victim = first_align_cluster(log)
        system.overlay.partition([victim])
        inj.trace.append((round(system.net.now, 9), "partition", victim))
        inj.heal_partition(system.overlay, [victim], at=system.net.now + 8.0)

    system.net.schedule(0.45, cut)
    system.net.run()
    return run_view(run), inj.trace, system_view(system, log)


def delayed_links(p):
    system, log, wf, eng, inj = fault_build(p, "slow")
    faces = [f for pair in system.overlay.links.values() for f in pair]
    inj.delay_link(faces, 0.05, start=0.0)
    run = eng.run(wf)
    return run_view(run), inj.trace, system_view(system, log)


def lossy_links(p, seed, rate):
    system, log, wf, eng, inj = fault_build(p, "lossy", seed=seed)
    faces = [f for pair in system.overlay.links.values() for f in pair]
    inj.lossy_link(faces, rate, start=0.0)
    run = eng.start(wf)
    system.net.run()
    return run_view(run), inj.trace, system_view(system, log)


def gray_fault(p, kind, engine):
    """``tests/test_chaos_faults.py``'s scenario: 4 clusters, 1 MiB, one
    fault class at a time."""
    system, log, wf, eng, inj = fault_build(p, kind, seed=11, engine=engine, n=4, parts=4,
                                            data_bytes=2 ** 20)
    faces = [f for pair in system.overlay.links.values() for f in pair]
    if kind == "flap":
        inj.flap_link(faces[:2], period=0.2, start=0.1, stop=1.3)
    elif kind == "oneway":
        inj.one_way_partition(system.overlay, "wfpod0", at=0.3, heal_at=2.0)
    elif kind == "slow":
        inj.slow_node(system.overlay.clusters["wfpod0"], 4.0, start=0.0, stop=8.0)
    elif kind == "corrupt":
        inj.corrupt_link(faces, 0.15, start=0.0, stop=3.0)
    elif kind == "duplicate":
        inj.duplicate_link(faces, 0.25, start=0.0)
    elif kind == "reorder":
        inj.reorder_link(faces, 0.25, start=0.0)
    system.net.trace = []
    run = eng.start(wf)
    system.net.run()
    return run_view(run), inj.trace, system_view(system, log)


SCENARIOS = {"scatter_gather": scatter_gather, "spread": spread, "dedup_within": dedup_within,
             "cached_twice": cached_twice, "shared_subworkflow": shared_subworkflow,
             "busy_backoff": busy_backoff, "coalesced_polls": coalesced_polls,
             "crash_mid_stage": crash_mid_stage, "partition_heals": partition_heals,
             "delayed_links": delayed_links}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_workflow_scenarios_match_the_reference(monkeypatch, scenario):
    got = on_both(monkeypatch, SCENARIOS[scenario])
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("seed,rate", [(7, 0.25), (13, 0.1)])
def test_lossy_links_match_the_reference(monkeypatch, seed, rate):
    """``FaultInjector`` draws every packet's fate from its one
    ``random.Random(seed)`` in the reference's order, or the traces part."""
    got = on_both(monkeypatch, lossy_links, seed, rate)
    assert got["port"] == got["reference"]
    run, inj_trace, system = got["port"]
    assert run["complete"] and any(kind == "loss-start" for _, kind, _ in inj_trace)


@pytest.mark.parametrize("kind", ["flap", "oneway", "slow", "corrupt", "duplicate", "reorder"])
def test_gray_faults_match_the_reference(monkeypatch, kind):
    got = on_both(monkeypatch, gray_fault, kind, "calendar")
    assert got["port"] == got["reference"]
    assert got["port"][0]["complete"]


def test_gray_fault_replays_on_the_heap_engine(monkeypatch):
    heap = on_both(monkeypatch, gray_fault, "corrupt", "heap")
    assert heap["port"] == heap["reference"]
    calendar = on_both(monkeypatch, gray_fault, "corrupt", "calendar")
    assert heap["port"] == calendar["port"]


def test_workflow_outcomes_on_the_port():
    """What the reference's workflow tests assert of it, on the port."""
    p = package("port")
    _, run, system = scatter_gather(p)
    assert run["complete"] and run["results"]["merge"]["inputs"] == 4
    assert run["results"]["merge"]["total_bytes"] == 128 * 1024
    assert len({sig for *_, sig in system["log"]}) == len(system["log"]) == 6
    first, second, system = cached_twice(p)
    assert len(system["log"]) == 6 and second["cache_hits"] == 6
    run, _, reexecuted, system = crash_mid_stage(p)
    assert run["complete"] and list(reexecuted.values()) == [2]
    run, _, system = partition_heals(p)
    assert run["complete"] and run["resubmissions"] >= 1
    assert len({sig for *_, sig in system["log"]}) == len(system["log"]) == 8
    run, polls, interests, _ = coalesced_polls(p)
    assert run["complete"] and 0 < interests < polls


def test_dag_compilation_and_codec_match_the_reference():
    ref, port = package("reference"), package("port")
    for p in (ref, port):
        with pytest.raises(p.dag.WorkflowError):
            p.dag.WorkflowSpec("cyc").stage("a", "wf-merge", inputs=["@b"]).stage(
                "b", "wf-merge", inputs=["@a"]).compile()
        with pytest.raises(ValueError):
            p.jobs.encode_input_names([p.names.Name(("lidc", "data", "a,b"))])

    def compiled(p):
        urgent = (p.dag.WorkflowSpec("urgent", priority=3)
                  .stage("shard", "wf-shard", inputs=[DATASET], parts=2, tag="p")
                  .stage("align", "wf-align", inputs=["@shard"], fanout=2, tag="p", prio=7)
                  .stage("merge", "wf-merge", inputs=["@align", DATASET], tag="p"))
        chain = p.dag.WorkflowSpec("chain")
        chain.stage("a", "wf-align", fanout=2, inputs=[DATASET])
        chain.stage("b", "wf-align", fanout=2, inputs=["@a"])
        wfs = [urgent.compile(), chain.compile(), blast_spec(p, parts=5).compile()]
        names = [p.names.Name.parse(DATASET), p.names.Name.parse("/lidc/data/results/abc123")]
        enc = p.jobs.encode_input_names(names)
        return ([(workflow_view(w), {k: [i for i in v] for k, v in w.dependents().items()},
                  [str(s.request_name) for s in w.sinks()],
                  {k: str(v) for k, v in w.result_names().items()}) for w in wfs],
                enc, [str(n) for n in p.jobs.decode_input_names(enc)])

    assert compiled(port) == compiled(ref)


# ----------------------------------------------------------------- examples

def test_genomics_workflow_example_matches_the_reference(monkeypatch):
    """The port's example (``--device cpu``) against the reference's steps on
    the reference's fleet, in one process (the blast executor seeds its
    alignment from the salted ``hash((srr, db))``, as the reference's)."""
    from repro.core.names import Name
    from repro.runtime.fleet import build_fleet
    from repro_torch.examples import genomics_workflow

    def reference():
        system = build_fleet(n_clusters=2, chips=16, archs=["lidc-demo"])
        bad = system.client.submit({"app": "blast", "srr": "not-an-srr"})
        rows = []
        for srr, db, mem, cpu in genomics_workflow.TABLE_I:
            h = system.client.run_job({"app": "blast", "srr": srr, "db": db, "mem": mem,
                                       "cpu": cpu})
            rows.append((srr, db, mem, cpu, h.result["run_time_s"], h.result["output_bytes"],
                         h.result["cluster"]))
        rname = Name.parse(h.receipt["result_name"])
        return {"refused": bad is None, "rows": rows, "result_name": str(rname),
                "alignment_score": system.client.fetch(rname).json()["alignment_score"],
                "virtual_s": system.net.now}

    renumber(monkeypatch, "reference")
    want = reference()
    renumber(monkeypatch, "port")
    got = genomics_workflow.run("cpu", verbose=False)
    assert got == want
    assert got["refused"] and len(got["rows"]) == 4


def test_multitenant_scheduling_example_prints_what_the_reference_prints(capsys):
    from repro_torch.examples import multitenant_scheduling

    out = multitenant_scheduling.run()
    assert capsys.readouterr().out == reference_example("multitenant_scheduling")
    assert (out["completed"], out["preemptions"], out["spills"]) == (6, 1, 1)
