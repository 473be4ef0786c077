"""The port's demand-driven replication (``repro_torch.datalake.replication``)
against the reference's (``repro.datalake.replication``) on the same inputs,
and the port's ``hot_dataset_replication`` example.

The scenarios are ``tests/test_replication.py``'s: a hot object pulled,
served and audited; demand that stays hot without a replication storm; a
byte budget that forces cold-first eviction; a transfer cut by a blackout
that resumes from its persisted segments; a WAN partition whose parked
pulls drain after it heals; three hot datasets under seeded link churn on
both event engines; a replica advertised by gossip that steers a ring's
readers, and its withdrawal.  Each runs on each package, and the manager's
counters, its replicas, the audit, the origin's egress, the edge's
counters and producers, the clock and the event trace must be identical.
"""

import pytest

from torch_parity import on_both, package, reference_example


class Plane:
    """client -- edge -- origin over a slow WAN hop; the manager on the edge."""

    def __init__(self, p, *, engine="calendar", segment=4096, wan_latency=0.02,
                 edge_cs_bytes=1 << 20, policy=None):
        F = p.forwarder
        self.p = p
        self.data = p.names.Name.parse("/lidc/data")
        self.net = F.Network(engine=engine)
        self.net.trace = []
        self.origin = F.Forwarder(self.net, "origin")
        self.edge = F.Forwarder(self.net, "edge", cs_capacity_bytes=edge_cs_bytes)
        self.client = F.Forwarder(self.net, "client", cs_capacity_bytes=4096)
        self.fe, self.fo = F.link(self.net, self.edge, self.origin, wan_latency)
        fc, _ = F.link(self.net, self.client, self.edge, 0.001)
        self.edge.register_route(self.data, self.fe)
        self.client.register_route(self.data, fc)
        self.lake = p.datalake.DataLake(segment_size=segment)
        self.lake.attach(self.origin)
        self.policy = policy or p.replication.ReplicationPolicy(
            hot_rate=3.0, budget_bytes=1 << 20, interval=0.25, retry_base=0.25,
            retry_cap=1.0)
        self.mgr = p.replication.ReplicationManager(self.net, self.edge,
                                                    policy=self.policy).start()

    def publish(self, name, nbytes, fill=7):
        n = self.p.names.Name.parse(name)
        self.lake.put_bytes(n, bytes([fill]) * nbytes)
        return n

    def heat(self, name, t=0.0, times=4):
        for _ in range(times):
            self.mgr.demand.observe(name, t)

    def view(self):
        return {"stats": self.mgr.stats(), "audit": self.mgr.audit(self.lake),
                "replicas": sorted((k, r.nbytes, r.segments, r.installed_at)
                                   for k, r in self.mgr.replicas.items()),
                "origin_tx": self.fo.tx_data_bytes, "edge": sorted(self.edge.stats.items()),
                "producers": sorted(self.edge._producers), "now": self.net.now,
                "events": self.net.events_processed, "trace": self.net.trace}


def hot_object(p):
    pl = Plane(p)
    name = pl.publish("/lidc/data/ds0/blob", 40960)
    pl.heat(name)
    pl.net.run(until=10.0)
    before = pl.view()
    f = p.fetch.fetch(pl.net, pl.client, name, verify_key=pl.lake.key)
    pl.net.run()
    return before, f.result == bytes([7]) * 40960, pl.view()


def no_storm(p):
    pl = Plane(p)
    name = pl.publish("/lidc/data/ds0/blob", 65536)
    for t in range(8):
        pl.heat(name, t=0.1 * t)
    pl.net.run(until=15.0)
    return pl.view()


def budget_eviction(p):
    size = 32768
    pol = p.replication.ReplicationPolicy(hot_rate=3.0, interval=0.25, cooldown=0.5,
                                          budget_bytes=int(2.5 * size))
    pl = Plane(p, policy=pol)
    names = [pl.publish(f"/lidc/data/ds{i}/blob", size, fill=i) for i in range(4)]
    for i, n in enumerate(names):
        pl.net.schedule(2.0 * i, lambda n=n: pl.heat(n, pl.net.now, times=6))
    pl.net.run(until=20.0)
    return pl.view()


def crash_resume(p):
    pl = Plane(p, segment=1024)
    name = pl.publish("/lidc/data/ds0/blob", 65536)
    pl.heat(name)
    inj = p.faults.FaultInjector(pl.net, seed=1)
    box = inj.blackout([pl.fe, pl.fo], at=0.4, heal_at=3.0)
    pl.mgr.alive = lambda: box[0]
    pl.net.run(until=30.0)
    return pl.view(), inj.trace


def partition_heal(p):
    pl = Plane(p, segment=1024)
    name = pl.publish("/lidc/data/ds0/blob", 32768)
    pl.heat(name)
    inj = p.faults.FaultInjector(pl.net, seed=1)
    inj.blackout([pl.fe, pl.fo], at=0.3, heal_at=6.0)
    queue_seen = []

    def probe():
        st = pl.mgr.stats()
        queue_seen.append(st["retry_queue"] + st["in_flight"])
        if pl.net.now < 5.5:
            pl.net.schedule(0.5, probe, daemon=True)

    pl.net.schedule(2.0, probe, daemon=True)
    pl.net.run(until=30.0)
    return pl.view(), queue_seen, inj.trace


def churn(p, engine):
    pl = Plane(p, engine=engine, segment=1024)
    names = [pl.publish(f"/lidc/data/ds{i}/blob", 16384, fill=i) for i in range(3)]
    for i, n in enumerate(names):
        pl.net.schedule(0.5 * i, lambda n=n: pl.heat(n, pl.net.now, times=5))
    inj = p.faults.FaultInjector(pl.net, seed=3)
    box = inj.churn([pl.fe, pl.fo], period=2.0, down=0.8, start=0.6, stop=6.0)
    pl.mgr.alive = lambda: box[0]
    pl.net.run(until=40.0)
    return pl.view(), inj.trace


def gossip_steers_readers(p):
    F = p.forwarder
    data = p.names.Name.parse("/lidc/data")
    net = F.Network()
    net.trace = []
    mesh = p.overlay.MeshTopology(net, 5, "ring", seed=2)
    lake = p.datalake.DataLake(segment_size=2048)
    lake.attach(mesh.nodes[0])
    mesh.agents[0].originate(data)
    mesh.converge(timeout=20.0)
    name = p.names.Name.parse("/lidc/data/ds0/blob")
    lake.put_bytes(name, b"\5" * 16384)
    mgr = p.replication.ReplicationManager(
        net, mesh.nodes[2], agent=mesh.agents[2],
        policy=p.replication.ReplicationPolicy(hot_rate=3.0, budget_bytes=1 << 20)).start()
    for _ in range(4):
        mgr.demand.observe(name, net.now)
    net.run(until=30.0)
    installed = mgr.stats()
    prefix, hops = mesh.nodes[3].fib.lookup(name)
    routed = (str(prefix), [h.face_id for h in hops], mesh.faces[(3, 2)].face_id)
    tx0 = sum(f.tx_data_bytes for (i, _), f in mesh.faces.items() if i == 0)
    f = p.fetch.fetch(net, mesh.nodes[3], name, verify_key=lake.key)
    net.run()
    tx1 = sum(f.tx_data_bytes for (i, _), f in mesh.faces.items() if i == 0)
    mgr.stop()
    mgr._evict(name.components)
    net.run(until=net.now + 15.0)
    prefix2, _ = mesh.nodes[3].fib.lookup(name)
    return (installed, mgr.stats(), routed, f.result == b"\5" * 16384, tx1 - tx0, str(prefix2),
            net.now, net.events_processed, net.trace)


SCENARIOS = {"hot_object": hot_object, "no_storm": no_storm,
             "budget_eviction": budget_eviction, "crash_resume": crash_resume,
             "partition_heal": partition_heal, "gossip_steers_readers": gossip_steers_readers}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_replication_scenarios_match_the_reference(monkeypatch, scenario):
    got = on_both(monkeypatch, SCENARIOS[scenario])
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("engine", ["heap", "calendar"])
def test_churn_replay_matches_the_reference_on_each_engine(monkeypatch, engine):
    got = on_both(monkeypatch, churn, engine)
    assert got["port"] == got["reference"]
    view, _ = got["port"]
    assert len(view["trace"]) > 100
    assert view["stats"]["replicas"] == 3 and view["audit"] == []


def test_replication_outcomes_on_the_port():
    """What ``test_replication.py`` asserts of the reference, on the port."""
    p = package("port")
    before, read_ok, after = hot_object(p)
    assert before["stats"]["replicas"] == 1 and before["audit"] == [] and read_ok
    assert after["origin_tx"] == before["origin_tx"]
    storm = no_storm(p)
    assert storm["stats"]["transfers_started"] == 1
    assert storm["origin_tx"] <= 65536 * 1.05 + 4096
    tight = budget_eviction(p)
    assert tight["stats"]["max_bytes_used"] <= int(2.5 * 32768)
    assert tight["stats"]["evictions"] >= 1 and tight["audit"] == []
    resumed, _ = crash_resume(p)
    assert 1 <= resumed["stats"]["segments_resumed"] < 64
    healed, queue_seen, _ = partition_heal(p)
    assert max(queue_seen) >= 1 and healed["stats"]["replicas"] == 1
    stats, evicted, (prefix, hops, toward), read, origin_tx, prefix2, *_ = \
        gossip_steers_readers(p)
    assert stats["replicas"] == 1 and evicted["replicas"] == 0 and hops == [toward] and read and origin_tx == 0
    assert prefix2 in ("None", "/lidc/data")


def test_demand_tracker_is_the_port_cores():
    p = package("port")
    assert p.replication.DemandTracker is p.demand.DemandTracker
    assert set(p.replication.__all__) == set(package("reference").replication.__all__)
    assert set(p.datalake.__all__) == set(package("reference").datalake.__all__)
    net = p.forwarder.Network()
    mgr = p.replication.ReplicationManager(net, p.forwarder.Forwarder(net, "n"))
    assert mgr.demand.exclude_keys == (("lidc", "data", "results"), ("lidc", "data", "serve"))


def test_hot_dataset_replication_example_prints_what_the_reference_prints(capsys):
    from repro_torch.examples import hot_dataset_replication as ex

    out = ex.run()
    assert capsys.readouterr().out == reference_example("hot_dataset_replication")
    assert out["delivered"] == ex.READS_PER_WAVE * 2 and out["audit"] == []
