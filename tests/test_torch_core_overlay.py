"""The port's overlay (``repro_torch.core``: gateway, cluster, compute plane,
matchmaker, routing, overlay) against the reference's ``repro.core``, with
stub executors that are the same on both sides (fixed durations, payloads
and phases, checkpoints as named lake objects).  Each scenario is run on
each package, and the placements, job states and times, status histories,
receipts, Nack reasons, gateway and scheduler counters and final clock
must be identical: the quickstart and its repeat, a cluster killed mid-job
and the job resumed elsewhere, busy receipts and spill under
``max_queue_depth``, and preemption at a phase boundary.  Also: the port's
clusters are 80 GB a chip by default."""

import itertools
import math
import random

import pytest

import repro.core as R
import repro.core.jobs as RJ
import repro.core.packets as RP
import repro_torch.core as T
import repro_torch.core.jobs as TJ
import repro_torch.core.packets as TP
from repro.core.compute_plane import SchedulerConfig as RSchedulerConfig
from repro_torch.core.compute_plane import SchedulerConfig as TSchedulerConfig

PACKAGES = {"reference": (R, RJ, RP, RSchedulerConfig), "port": (T, TJ, TP, TSchedulerConfig)}
TPU_HBM = 16.0        # both sides at the same chip size where they are compared


@pytest.fixture
def fresh(monkeypatch):
    """Number jobs and Interests from 1 in both packages."""
    def reset(pkg):
        _, jobs, packets, _ = PACKAGES[pkg]
        monkeypatch.setattr(jobs, "_job_seq", itertools.count(1))
        monkeypatch.setattr(packets, "_nonce_counter", itertools.count(1))
    return reset


def stub_train_executor(core, *, ckpt_every=5, step_s=0.25, on_phase=None):
    """A phased train job: ``steps`` steps at ``step_s`` virtual seconds,
    a named checkpoint after each phase, resumed from the lake's latest
    one; its payload is fixed by the spec."""
    def executor(job, cluster):
        steps = job.spec.steps(default=10)
        run = f"train-{job.spec.signature()}"
        latest = core.Name.parse(f"/lidc/data/ckpt/{run}/latest")
        start = (cluster.lake.get_json(latest) or {}).get("step", 0)
        done = {"from": start or None}
        n_phases = max(1, math.ceil(steps / ckpt_every))

        def phase(i):
            end = min((i + 1) * ckpt_every, steps)

            def work():
                if end <= start:
                    return
                cluster.lake.put_json(latest, {"step": end, "run": run})
                if on_phase is not None:
                    on_phase(cluster, end)
            return work

        return core.ExecPlan(
            phases=[(step_s * min(ckpt_every, steps - i * ckpt_every), phase(i))
                    for i in range(n_phases)],
            finalize=lambda: core.ExecResult(
                payload={"app": "train", "arch": job.spec.arch, "steps": steps,
                         "final_loss": 1.0 / steps, "resumed_from": done["from"],
                         "run_name": run},
                duration=0.0))
    return executor


def train_endpoint(core, **kw):
    return core.ServiceEndpoint(service="train-lm.lidck8s.svc.cluster.local", app="train",
                                archs=("lidc-demo",), shapes=("custom",),
                                executor=stub_train_executor(core, **kw))


def _job_view(system):
    return sorted((c.name, j.job_id, j.state.value, j.started_at, j.finished_at,
                   j.granted_chips, j.preemptions, j.error, sorted((j.result or {}).items()))
                  for c in system.overlay.clusters.values() for j in c.jobs.values())


def _handle_view(h):
    if h is None:
        return None
    return (h.receipt, h.status_history, h.result, h.error, h.state)


def _system_view(system):
    gws = {n: (g.cache_shortcuts, g.busy_receipts, g.spills, sorted(g.rejections.items()))
           for n, g in system.overlay.gateways.items()}
    return (_job_view(system), system.net.now, sorted(system.overlay.edge.stats.items()),
            gws, sorted(system.lake.names()), system.net.trace, system.net.events_processed)


def _system(pkg, engine):
    system = PACKAGES[pkg][0].LidcSystem(engine=engine)
    system.net.trace = []
    return system


def quickstart(pkg, engine):
    core = PACKAGES[pkg][0]
    system = _system(pkg, engine)
    for i in range(3):
        system.add_cluster(f"pod{i}", chips=16, latency=0.002 * (i + 1),
                           hbm_gb_per_chip=TPU_HBM, endpoints=[train_endpoint(core)])
    job = {"app": "train", "arch": "lidc-demo", "shape": "custom", "chips": 4, "steps": 15}
    first = system.client.run_job(job)
    again = system.client.run_job(job)
    return _handle_view(first), _handle_view(again), _system_view(system)


def killed_cluster(pkg, engine):
    core = PACKAGES[pkg][0]
    system = _system(pkg, engine)
    killed = []

    def on_phase(cluster, step):
        if step >= 10 and not killed:
            killed.append((cluster.name, system.net.now))
            system.overlay.fail_cluster(cluster.name)

    for i in range(2):
        system.add_cluster(f"pod{i}", chips=16, latency=0.002 * (i + 1),
                           hbm_gb_per_chip=TPU_HBM,
                           endpoints=[train_endpoint(core, on_phase=on_phase)])
    job = {"app": "train", "arch": "lidc-demo", "shape": "custom", "chips": 4,
           "steps": 20, "demo": "failover"}
    handles = []
    for _ in range(4):                     # runtime/fleet.py::resilient_run's loop
        h = system.client.run_job(job, interval=1.0)
        handles.append(_handle_view(h))
        if h is not None and h.state == "Completed":
            break
    assert killed and handles[-1][-1] == "Completed"
    return killed, handles, _system_view(system)


def sim_executor(core, log):
    def executor(job, cluster):
        fields = job.spec.fields
        dur, phases = float(fields.get("d", 1)), int(fields.get("phases", 0))
        uid = fields.get("u", job.job_id)
        if phases <= 0:
            log.append((uid, "run", cluster.name))
            return core.ExecResult(payload={"u": uid}, duration=dur)

        def phase_fn(i):
            def work():
                log.append((uid, f"phase{i}", cluster.name))
            return work

        return core.ExecPlan(phases=[(dur / phases, phase_fn(i)) for i in range(phases)],
                             finalize=lambda: core.ExecResult(payload={"u": uid},
                                                              duration=0.0))
    return executor


def sim_cluster(pkg, system, name, log, *, chips, max_queue_depth, config=None):
    core = PACKAGES[pkg][0]
    cluster = core.ComputeCluster(system.net, name, chips=chips, lake=system.lake,
                                  hbm_gb_per_chip=TPU_HBM, max_queue_depth=max_queue_depth,
                                  scheduler_config=config)
    cluster.add_endpoint(core.ServiceEndpoint(service="sim.lidck8s.svc.cluster.local",
                                              app="sim", executor=sim_executor(core, log)))
    reg = core.ValidatorRegistry()
    reg.register("sim", lambda fields, caps: None)
    system.overlay.add_cluster(cluster, validators=reg)
    return cluster


def _drive(pkg, system, consumer, jobs):
    core = PACKAGES[pkg][0]
    outcomes = {}
    for t, fields, uid, retries in jobs:
        def submit(fields=fields, uid=uid, retries=retries):
            consumer.express(
                core.Interest(name=core.canonical_job_name(fields), lifetime=2.0,
                              must_be_fresh=True),
                on_data=lambda d, uid=uid: outcomes.setdefault(uid, ("receipt", d.json())),
                on_fail=lambda r, uid=uid: outcomes.setdefault(uid, ("fail", r)),
                retries=retries)
        system.net.schedule(max(0.0, t - system.net.now), submit)
    system.net.run()
    nacks = [(str(n.interest.name), n.reason, n.info) for n in consumer.nacks]
    return outcomes, nacks


def busy_and_spill(pkg, seed, engine):
    core, _, _, SchedulerConfig = PACKAGES[pkg]
    system, log = _system(pkg, engine), []
    sim_cluster(pkg, system, "hot", log, chips=4, max_queue_depth=1,
                config=SchedulerConfig(spill_queue_depth=0))
    sim_cluster(pkg, system, "cold", log, chips=4, max_queue_depth=1)
    sim_cluster(pkg, system, "far", log, chips=2, max_queue_depth=1)
    system.net.run(until=0.2)
    rng = random.Random(seed)
    jobs, t = [], 0.3
    for i in range(24):
        t += rng.random() * 0.6
        fields = {"app": "sim", "chips": rng.choice([1, 2, 4]),
                  "d": round(rng.uniform(0.2, 3.0), 3), "u": f"j{seed}-{i}"}
        jobs.append((round(t, 3), fields, fields["u"], rng.choice([0, 1, 2])))
    edge = _drive(pkg, system, system.client.consumer, jobs[:12])
    local = core.LidcClient(system.net, system.overlay.clusters["hot"].node,
                            name="local-client")
    at_hot = _drive(pkg, system, local.consumer,
                    [(system.net.now + 0.1 + t - jobs[12][0], f, u, r)
                     for t, f, u, r in jobs[12:]])
    sched = {n: sorted(c.scheduler.stats.items())
             for n, c in system.overlay.clusters.items()}
    return edge, at_hot, sorted(log), sched, _system_view(system)


def preemption(pkg, engine):
    core = PACKAGES[pkg][0]
    system, log = _system(pkg, engine), []
    sim_cluster(pkg, system, "pod0", log, chips=8, max_queue_depth=4)
    system.net.run(until=0.2)
    jobs = [(0.3, {"app": "sim", "chips": 8, "d": 4.0, "phases": 4, "u": "victim"},
             "victim", 0),
            (0.8, {"app": "sim", "chips": 4, "d": 1.0, "prio": 5, "u": "urgent"},
             "urgent", 0)]
    outcomes = _drive(pkg, system, system.client.consumer, jobs)
    cluster = system.overlay.clusters["pod0"]
    victim = next(j for j in cluster.jobs.values() if j.spec.fields["u"] == "victim")
    assert victim.preemptions == 1 and victim.state.value == "Completed"
    statuses = [core.Name.parse(f"/lidc/status/pod0/{j.job_id}") for j in cluster.jobs.values()]
    answers = [system.client.fetch(n, must_be_fresh=True) for n in statuses]
    return (outcomes, log, sorted(cluster.scheduler.stats.items()),
            [a and a.json() for a in answers], _system_view(system))


SCENARIOS = {"quickstart": quickstart, "killed_cluster": killed_cluster,
             "preemption": preemption}


@pytest.mark.parametrize("engine", ["heap", "calendar"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_overlay_scenarios_match_the_reference(fresh, scenario, engine):
    got = {}
    for pkg in PACKAGES:
        fresh(pkg)
        got[pkg] = SCENARIOS[scenario](pkg, engine)
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("engine", ["heap", "calendar"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_busy_receipts_and_spill_match_the_reference(fresh, seed, engine):
    got = {}
    for pkg in PACKAGES:
        fresh(pkg)
        got[pkg] = busy_and_spill(pkg, seed, engine)
    assert got["port"] == got["reference"]
    edge, at_hot, _, _, view = got["port"]
    gws = view[3]
    # the scenario exercised what it is about
    assert gws["hot"][2] > 0, "nothing spilled"
    assert any(kind == "fail" for kind, _ in {**edge[0], **at_hot[0]}.values()) or \
        sum(g[1] for g in gws.values()) > 0, "nothing was refused"


def test_quickstart_places_repeats_and_caches_as_the_reference(fresh):
    fresh("port")
    first, again, view = quickstart("port", "calendar")
    assert first[-1] == again[-1] == "Completed"
    assert again[0]["job_id"] == first[0]["job_id"]
    assert len(view[0]) == 1                           # the repeat spawned no job
    assert sum(g[0] for g in view[3].values()) + dict(view[2])["cs_hit"] >= 1


def test_port_clusters_are_80_gb_a_chip_by_default():
    """A job the port's memory model sizes at ~40 GB a chip (zamba2-2.7b's
    train_4k cell on 8 chips) is admitted by a port cluster built with the
    defaults; at the reference's 16 GB a chip it is refused."""
    from repro_torch.core.matchmaker import HBM_GB_PER_CHIP, MatchError, Matchmaker
    from repro_torch.runtime.executors import HBM_GB_PER_CHIP as EXEC_HBM
    from repro_torch.runtime.executors import memory_model

    assert HBM_GB_PER_CHIP == EXEC_HBM == 80.0
    fields = {"arch": "zamba2-2.7b", "shape": "train_4k", "chips": 8, "steps": 5}
    spec = T.JobSpec("train", fields)
    assert 35e9 < memory_model(spec, 8) < 45e9
    ep = T.ServiceEndpoint(service="train-lm.lidck8s.svc.cluster.local", app="train",
                           archs=("zamba2-2.7b",), shapes=("train_4k",),
                           executor=stub_train_executor(T))
    assert Matchmaker(memory_model).match(spec, [ep], free_chips=8)[1] == 8
    with pytest.raises(MatchError):
        Matchmaker(memory_model, hbm_gb_per_chip=16.0).match(spec, [ep], free_chips=8)

    system = T.LidcSystem()
    cluster = system.add_cluster("h100", chips=8, endpoints=[ep], memory_model=memory_model)
    assert cluster.hbm_gb_per_chip == 80.0
    assert T.ComputeCluster(system.net, "bare", chips=1).hbm_gb_per_chip == 80.0
    handle = system.client.run_job({"app": "train", **fields})
    assert handle is not None and handle.state == "Completed"
    assert handle.result["cluster"] == "h100"
