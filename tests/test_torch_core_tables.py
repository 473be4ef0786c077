"""The port's forwarding tables (``repro_torch.core.tables``) against the
reference's ``repro.core.tables`` on the same generated operations: the
trie FIB's longest-prefix match (and the ``LinearFib`` oracle), PIT
aggregation, loop suppression and expiry, Content Store eviction order and
matching, and the RIB's best routes."""

import random

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core.names as N
import repro.core.packets as P
import repro.core.tables as T
import repro_torch.core.names as TN
import repro_torch.core.packets as TP
import repro_torch.core.tables as TT

SETTINGS = settings(max_examples=120, deadline=None, derandomize=True, database=None,
                    suppress_health_check=[HealthCheck.too_slow])

_comp = st.sampled_from(["a", "b", "c", "lidc", "compute", "data", "x=1", "seg=0"])
_name = st.lists(_comp, min_size=0, max_size=5).map(lambda cs: "/" + "/".join(cs))


def _hops(hops):
    return sorted((h.face_id, h.cost) for h in hops)


@SETTINGS
@given(ops=st.lists(st.tuples(st.sampled_from(["reg", "unreg", "unreg_face", "drop_face",
                                               "sync"]),
                              _name, st.integers(1, 5), st.floats(0.5, 9.0)),
                    max_size=40),
       probes=st.lists(_name, min_size=1, max_size=12))
def test_fib_longest_prefix_match_matches_the_reference(ops, probes):
    fibs = [T.Fib(), T.LinearFib(), TT.Fib(), TT.LinearFib()]
    names = [N.Name, N.Name, TN.Name, TN.Name]
    for op, uri, face, cost in ops:
        for fib, Name in zip(fibs, names):
            prefix = Name.parse(uri)
            if op == "reg":
                fib.register(prefix, face, cost)
            elif op == "unreg":
                fib.unregister(prefix)
            elif op == "unreg_face":
                fib.unregister(prefix, face)
            elif op == "drop_face":
                fib.remove_face(face)
            else:
                fib.sync_prefix(prefix, {face: cost, face + 1: cost / 2})
    for uri in probes:
        got = []
        for fib, Name in zip(fibs, names):
            match, hops = fib.lookup(Name.parse(uri))
            got.append((None if match is None else str(match), _hops(hops)))
        assert got[0] == got[1] == got[2] == got[3], uri
    assert sorted(map(str, fibs[0].prefixes())) == sorted(map(str, fibs[2].prefixes()))
    assert len(fibs[0]) == len(fibs[2])


def _pit_run(pkg_names, pkg_packets, pkg_tables, script):
    Name, Interest, Pit = pkg_names.Name, pkg_packets.Interest, pkg_tables.Pit
    pit, log = Pit(), []
    for op, uri, t, face, nonce, life in script:
        if op == "insert":
            entry, new, dup = pit.insert(Interest(name=Name.parse(uri), nonce=nonce,
                                                  lifetime=life), face, t)
            log.append(("insert", new, dup, entry.expiry, sorted(entry.in_faces)))
        elif op == "satisfy":
            log.append(("satisfy", sorted((str(e.name), sorted(e.in_faces))
                                          for e in pit.satisfy(Name.parse(uri)))))
        else:
            log.append(("expire", pit.expires_by(t), pit.next_expiry(),
                        [str(e.name) for e in pit.expire(t)]))
        log.append(len(pit))
    return log


@SETTINGS
@given(steps=st.lists(st.tuples(st.sampled_from(["insert", "insert", "satisfy", "expire"]),
                                _name, st.floats(0.0, 3.0), st.integers(1, 4),
                                st.integers(1, 6), st.floats(0.1, 2.0)),
                      max_size=60))
def test_pit_aggregation_and_expiry_match_the_reference(steps):
    script, now = [], 0.0
    for op, uri, dt, face, nonce, life in steps:
        now += dt / 4
        script.append((op, uri, now, face, nonce, life))
    assert _pit_run(N, P, T, script) == _pit_run(TN, TP, TT, script)


def _cs_run(pkg_names, pkg_packets, pkg_tables, script, capacity, capacity_bytes):
    Name, Interest, Data = pkg_names.Name, pkg_packets.Interest, pkg_packets.Data
    cs, log = pkg_tables.ContentStore(capacity=capacity, capacity_bytes=capacity_bytes), []
    for op, uri, t, size, fresh, prefix in script:
        name = Name.parse(uri)
        if op == "insert":
            cs.insert(Data(name=name, content=b"x" * size, freshness=fresh, created_at=t))
        elif op == "match":
            hit = cs.match(Interest(name=name, can_be_prefix=prefix, must_be_fresh=fresh > 1),
                           t)
            log.append(None if hit is None else str(hit.name))
        else:
            log.append(cs.evict_prefix(name))
        log.append((len(cs), cs.bytes_stored, cs.evictions))
    log.append(sorted(str(Name(k)) for k in cs._store))
    log.append(list(map(tuple, cs._store)))            # the LRU order itself
    log.append((cs.hits, cs.misses, cs.prefix_hit_rates()))
    return log


@SETTINGS
@given(steps=st.lists(st.tuples(st.sampled_from(["insert", "insert", "match", "evict"]),
                                _name, st.floats(0.0, 2.0), st.integers(0, 40),
                                st.floats(0.0, 3.0), st.booleans()),
                      max_size=60),
       capacity=st.integers(1, 8), capacity_bytes=st.one_of(st.none(), st.integers(10, 120)))
def test_content_store_eviction_and_matching_match_the_reference(steps, capacity,
                                                                 capacity_bytes):
    script, now = [], 0.0
    for op, uri, dt, size, fresh, prefix in steps:
        now += dt
        script.append((op, uri, now, size, fresh, prefix))
    assert _cs_run(N, P, T, script, capacity, capacity_bytes) == \
        _cs_run(TN, TP, TT, script, capacity, capacity_bytes)


def _rib_run(pkg_names, pkg_tables, seed):
    rng = random.Random(seed)
    Name, Rib, RibRoute = pkg_names.Name, pkg_tables.Rib, pkg_tables.RibRoute
    rib, log = Rib(), []
    prefixes = ["/lidc/compute", "/lidc/compute/train", "/lidc/data", "/svc/p1"]
    for step in range(80):
        now = step * 0.5
        prefix = Name.parse(rng.choice(prefixes))
        op = rng.random()
        if op < 0.55:
            origin = rng.choice(["pod0", "pod1", "pod2"])
            route = RibRoute(origin=origin, face_id=rng.randrange(1, 4),
                             seq=rng.randrange(1, 10), cost=rng.randrange(1, 6),
                             path=(origin,), expires_at=now + rng.uniform(0.5, 6))
            log.append(rib.upsert(prefix, route))
        elif op < 0.7:
            log.append(rib.remove(prefix, origin=rng.choice(["pod0", "pod1", None])))
        elif op < 0.8:
            log.append(sorted(rib.remove_face(rng.randrange(1, 4))))
        else:
            log.append(sorted(rib.expire(now)))
        log.append(sorted((str(p), sorted(rib.nexthops(p).items())) for p in rib.prefixes()))
        log.append(rib.next_expiry())
    return log


def test_rib_best_routes_match_the_reference():
    for seed in range(6):
        assert _rib_run(N, T, seed) == _rib_run(TN, TT, seed)
