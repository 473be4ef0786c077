"""The port's batched task map (``repro_torch.workflow.taskmap``) against the
reference's (``repro.workflow.taskmap``) on the same inputs, and the port's
``elastic_map`` example.

``plan_partitions`` must tile every boundary size into the reference's
partitions.  Each scenario of ``tests/test_taskmap.py`` runs on each
package: a map run exactly once, a map-reduce and its fully cached repeat,
an unsegmented dataset, a speculative duplicate absorbed by the result
cache, speculation racing a time-dilated straggler and with speculation
off, a busy receipt on a full cluster, a batch's cluster crashed and the
batch expressed again; and a map-reduce of 500 tasks over 8 clusters with a
seeded 10x-slow cluster on both event engines.  The runs' partitions,
completion times, speculation and batch records, the reduce result, the
protocol counts (submit and status Interests), the execution log, every
gateway's batch and busy counters, the clock and the event trace must be
identical.
"""

import pytest

from torch_parity import on_both, package, reference_example

RECORD = b"alpha bravo charlie delta echo foxtrot golf hotel indigo juliet "
SEG = 64
BOUNDARY_SIZES = [1, SEG - 1, SEG, SEG + 1, 2 * SEG, 5 * SEG - 1, 5 * SEG, 5 * SEG + 1,
                  17 * SEG + 3, 40 * SEG]


@pytest.mark.parametrize("size", BOUNDARY_SIZES)
def test_plan_partitions_match_the_reference(size):
    ref, port = package("reference").taskmap, package("port").taskmap
    segments = -(-size // SEG) if size > SEG else 1
    for tasks in (None, 1, 3, 7, 64):
        want = ref.plan_partitions(size=size, segments=segments, segment_size=SEG, tasks=tasks)
        got = port.plan_partitions(size=size, segments=segments, segment_size=SEG, tasks=tasks)
        assert [tuple(vars(p).values()) for p in got] == \
            [tuple(vars(p).values()) for p in want]
        assert got[0].byte_lo == 0 and got[-1].byte_hi == size
        assert got[-1].seg_hi == segments


def dataset(p):
    return p.names.Name.parse(p.names.DATA_PREFIX).append("text", "corpus")


def fleet(p, n=3, *, chips=4, segment_size=256, records=64, **kw):
    system, log = p.taskmap.build_taskmap_fleet(n, chips=chips, segment_size=segment_size,
                                                **kw)
    system.lake.put_bytes(dataset(p), RECORD * records)
    system.net.run(until=system.net.now + 5)
    system.net.trace = []
    return system, log


def run_view(run):
    return {"partitions": [tuple(vars(x).values()) for x in run.partitions],
            "template": sorted(run.template.items()), "started": run.started_at,
            "submit_done": run.submit_done_at, "finished": run.finished_at,
            "failed": run.failed, "done": sorted(run.done.items()),
            "cached": sorted(run.cached), "task_durs": sorted(run.task_durs.items()),
            "speculated": sorted(run.speculated.items()), "spec_wins": run.spec_wins,
            "reduce": run.reduce_result, "delivery": run.delivery, "makespan": run.makespan,
            "batches": [(b.lo, b.hi, b.attempts, b.bid, b.cluster, b.noroute_retries,
                         b.busy_retries, b.poll_fails) for b in run.batches]}


def system_view(system, log, tm):
    gws = {n: (g.batch_receipts, g.avoided, g.busy_receipts, g.spills, g.cache_shortcuts,
               sorted(g.rejections.items())) for n, g in system.overlay.gateways.items()}
    return {"log": log.events, "submit": tm.submit_interests, "status": tm.status_interests,
            "single": tm.single_submits, "gateways": gws, "now": system.net.now,
            "events": system.net.events_processed, "trace": system.net.trace,
            "edge": sorted(system.overlay.edge.stats.items())}


def executor(p, system, **kw):
    return p.taskmap.TaskMapExecutor.for_system(system, **kw)


def map_once(p):
    system, log = fleet(p)
    tm = executor(p, system, batch_size=4)
    run = tm.map("wordcount", dataset(p))
    return run_view(run), system_view(system, log, tm)


def map_reduce_twice(p):
    system, log = fleet(p)
    tm = executor(p, system, batch_size=4)
    first = tm.map_reduce("wordcount", "wordcount-reduce", dataset(p))
    second = tm.map_reduce("wordcount", "wordcount-reduce", dataset(p))
    return run_view(first), run_view(second), system_view(system, log, tm)


def unsegmented(p):
    system, log = fleet(p, segment_size=1 << 20, records=8)
    tm = executor(p, system)
    run = tm.map("wordcount", dataset(p))
    return run_view(run), system_view(system, log, tm)


def speculative_absorbed(p):
    system, log = fleet(p, 2, chips=4, records=32)
    system.overlay.clusters["tmpod1"].advertise(chips=0)
    system.net.run(until=system.net.now + 5)
    tm = executor(p, system, batch_size=8, speculation=True, spec_factor=0.4,
                  spec_min_samples=2)
    run = tm.map("wordcount", dataset(p), cost=1.0)
    return run_view(run), system_view(system, log, tm)


def straggler(p, speculation):
    system, log = fleet(p, 2, chips=8, records=64)
    kw = {"spec_factor": 2.0, "spec_min_samples": 2} if speculation else {}
    tm = executor(p, system, batch_size=4, speculation=speculation, **kw)
    system.overlay.clusters["tmpod1"].time_dilation = 10.0
    run = tm.map("wordcount", dataset(p), cost=2.0)
    return run_view(run), system_view(system, log, tm)


def busy_backoff(p):
    system, log = fleet(p, 1, chips=1, records=16, max_queue_depth=0)
    cluster = system.overlay.clusters["tmpod0"]
    cluster.submit(p.jobs.JobSpec(app="tm-map", fields={
        "fn": "wordcount", "part": "0", "segs": "4", "spt": "4", "cost": "2.0",
        "blocker": "1", p.jobs.INPUTS_FIELD: p.jobs.encode_input_names([dataset(p)])}),
        system.net.now)
    tm = executor(p, system, batch_size=4)
    run = tm.map("wordcount", dataset(p), cost=0.01)
    return run_view(run), system_view(system, log, tm)


def crash_recovery(p):
    system, log = fleet(p, 2, chips=8, records=32)
    tm = executor(p, system, batch_size=16, speculation=False)
    run = tm.start_map("wordcount", dataset(p), cost=2.0)
    system.net.run(until=system.net.now + 1.0)
    victims = sorted({b.cluster for b in run.batches if b.cluster is not None})
    system.overlay.fail_cluster(victims[0])
    system.net.run()
    return victims, run_view(run), system_view(system, log, tm)


SCENARIOS = {"map_once": map_once, "map_reduce_twice": map_reduce_twice,
             "unsegmented": unsegmented, "speculative_absorbed": speculative_absorbed,
             "straggler_speculated": lambda p: straggler(p, True),
             "straggler_waited_out": lambda p: straggler(p, False),
             "busy_backoff": busy_backoff, "crash_recovery": crash_recovery}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_taskmap_scenarios_match_the_reference(monkeypatch, scenario):
    got = on_both(monkeypatch, SCENARIOS[scenario])
    assert got["port"] == got["reference"]


def big_map_reduce(p, engine):
    """500 tasks (one 256 B segment each) over 8 clusters of 8 chips, one
    cluster 10x slow; speculation on."""
    system, log = fleet(p, 8, chips=8, records=2000, engine=engine)
    system.overlay.clusters["tmpod3"].time_dilation = 10.0
    tm = executor(p, system, batch_size=32, spec_min_samples=4)
    run = tm.map_reduce("wordcount", "wordcount-reduce", dataset(p), cost=0.5)
    return run_view(run), system_view(system, log, tm)


@pytest.mark.parametrize("engine", ["heap", "calendar"])
def test_map_reduce_of_500_tasks_with_a_slow_cluster_matches_the_reference(monkeypatch,
                                                                            engine):
    got = on_both(monkeypatch, big_map_reduce, engine)
    assert got["port"] == got["reference"]
    run, system = got["port"]
    assert len(run["partitions"]) == 500 and run["delivery"] == 1.0
    assert run["reduce"]["count"] == 2000 * 10
    assert run["speculated"] and run["spec_wins"] >= 1
    assert system["submit"] < 500 and len({c for _, _, c, _ in system["log"]}) == 8


def test_taskmap_outcomes_on_the_port():
    """What ``test_taskmap.py`` asserts of the reference, on the port."""
    p = package("port")
    run, system = map_once(p)
    assert run["delivery"] == 1.0 and len(system["log"]) == len(run["partitions"])
    assert system["submit"] < len(run["partitions"])
    first, second, system = map_reduce_twice(p)
    assert first["reduce"]["count"] == second["reduce"]["count"] == 64 * 10
    assert len(system["log"]) == len(first["partitions"]) + 1
    run, system = speculative_absorbed(p)
    assert run["speculated"] and run["spec_wins"] == 0
    assert len(system["log"]) == len(run["partitions"])
    run, _ = straggler(p, True)
    assert run["spec_wins"] >= 1 and run["makespan"] < 20.0
    run, _ = straggler(p, False)
    assert run["spec_wins"] == 0 and run["makespan"] >= 20.0
    run, system = busy_backoff(p)
    assert run["delivery"] == 1.0 and system["gateways"]["tmpod0"][2] > 0
    victims, run, system = crash_recovery(p)
    assert len(victims) == 1 and run["delivery"] == 1.0


def test_batch_names_and_fields_match_the_reference():
    """The gateway's batch protocol is spoken by both packages alike: the
    batch job name, its fields and ranges, and the avoid field."""
    ref, port = package("reference"), package("port")

    def names(p):
        fields = {"app": "tm-map", "fn": "wordcount",
                  p.jobs.INPUTS_FIELD: p.jobs.encode_input_names([dataset(p)]),
                  "parts": 8, "segs": 8, "spt": 1, "cost": "5.0", p.jobs.AVOID_FIELD: "tmpod1"}
        name = p.names.batch_job_name(fields, 2, 6)
        ranges = p.jobs.compress_ranges([0, 1, 2, 5, 7, 8, 9])
        return (str(name), p.names.batch_fields_of(name), ranges,
                p.jobs.expand_ranges(ranges), p.jobs.AVOID_FIELD, p.names.BATCH_PREFIX)

    assert names(port) == names(ref)


def test_elastic_map_example_prints_what_the_reference_prints(capsys):
    from repro_torch.examples import elastic_map

    out = elastic_map.run()
    assert capsys.readouterr().out == reference_example("elastic_map")
    assert out["map_reduce"]["delivery"] == 1.0 and out["gray"]["spec_wins"] > 0
