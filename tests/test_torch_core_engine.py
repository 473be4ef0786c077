"""The port's event engine, forwarders and routing (``repro_torch.core``)
against the reference's ``repro.core``: ``tests/test_engine.py``'s seeded
mesh scenario, rebuilt on each package, gives the identical ``(time, seq)``
trace, final clock, deliveries and event count on both engines, for ring,
tree and random meshes; also with lossy links (the injector's ``loss_rng``
draws in the same order), adaptive strategies, and a node that dies and
heals."""

import itertools
import random

import pytest

import repro.core as R
import repro.core.packets as RP
import repro_torch.core as T
import repro_torch.core.packets as TP

PACKAGES = {"reference": (R, RP), "port": (T, TP)}


def _run_mesh_scenario(monkeypatch, pkg, engine, kind, seed, variant):
    """``tests/test_engine.py::_run_mesh_scenario`` on ``pkg``'s classes,
    with ``variant`` adding faults or strategies; returns the behaviour
    capture."""
    core, packets = PACKAGES[pkg]
    # both packages number their Interests from 1
    monkeypatch.setattr(packets, "_nonce_counter", itertools.count(1))
    net = core.Network(engine=engine)
    net.trace = []
    factory = (lambda i: core.AdaptiveStrategy()) if variant == "adaptive" else None
    mesh = core.MeshTopology(net, 9, kind, seed=seed, strategy_factory=factory)
    prefixes = []
    for i in range(6):
        prefix = core.Name.parse("/svc").append(f"p{i}")
        mesh.attach_producer(
            i, prefix,
            lambda interest, publish, now: core.Data(
                name=interest.name, content=b"x", created_at=now, freshness=30.0))
        prefixes.append(prefix)
    net.run(until=2.0)                              # converge on the virtual clock
    if variant == "lossy":
        for n, key in enumerate(sorted(mesh.faces)):
            face = mesh.faces[key]
            face.loss, face.loss_rng = 0.15, random.Random(seed * 100 + n)
    rng = random.Random(seed + 1)
    consumer = mesh.consumer_at(8)
    delivered, failed = [], []
    for i in range(40):
        p = prefixes[rng.randrange(len(prefixes))]

        def express(name=p.append(f"j{i}")):
            consumer.express(
                core.Interest(name=name, lifetime=1.0, hop_limit=32),
                on_data=lambda d: delivered.append(str(d.name)),
                on_fail=lambda reason, name=str(name): failed.append((name, reason)),
                retries=2)

        net.schedule(i * 0.03, express)
    if variant == "churn":
        net.schedule(0.3, lambda: mesh.fail_node(4))
        net.schedule(2.5, lambda: mesh.heal_node(4))
    net.run()                                       # drain to quiescence
    stats = [sorted(node.stats.items()) for node in mesh.nodes]
    drops = sum(face.drops for face in mesh.faces.values())
    return net.trace, net.now, delivered, failed, net.events_processed, stats, drops


@pytest.mark.parametrize("variant", ["plain", "lossy", "adaptive", "churn"])
@pytest.mark.parametrize("kind", ["ring", "tree", "random"])
def test_mesh_scenarios_match_the_reference_on_both_engines(monkeypatch, kind, variant):
    caps = {(pkg, engine): _run_mesh_scenario(monkeypatch, pkg, engine, kind, 3, variant)
            for pkg in PACKAGES for engine in ("heap", "calendar")}
    want = caps[("reference", "heap")]
    for key, cap in caps.items():
        assert cap == want, key
    if variant == "plain":
        assert len(want[2]) == 40
    if variant == "lossy":
        assert want[6] > 0                          # the faults really ran


def test_random_schedule_matches_the_reference():
    """Randomized delays and nested re-scheduling run in the same (time,
    seq) order on the port's engines as on the reference's."""
    traces = {}
    for pkg in PACKAGES:
        core = PACKAGES[pkg][0]
        for engine in ("heap", "calendar"):
            rng = random.Random(7)
            net = core.Network(engine=engine)
            net.trace = []
            executed = []

            def fire(depth=0, net=net, rng=rng, executed=executed):
                executed.append(net.now)
                if depth < 3 and rng.random() < 0.5:
                    delay = (rng.uniform(0, 0.004) if rng.random() < 0.8
                             else rng.uniform(0.5, 3.0))
                    net.schedule(delay, lambda d=depth: fire(d + 1))

            for _ in range(200):
                net.schedule(rng.uniform(0, 5.0), fire)
            net.run()
            traces[(pkg, engine)] = (net.trace, executed, net.now)
    assert len({repr(v) for v in traces.values()}) == 1
