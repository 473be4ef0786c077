"""The multi-cluster compute overlay + a client-side facade.

Clusters join the overlay by *advertising name prefixes through the
routing protocol* (:mod:`repro_torch.core.routing`, the analog of NLSR in the
paper's NDN testbed): the generic ``/lidc/compute/<app>`` plus refined
per-arch prefixes, their status namespace, and — if they host a lake —
the data namespace, each advertisement carrying the cluster's capability
record (chips, free chips, queue depth).  Joining requires **zero route
pre-configuration**: the cluster's gateway gossips to whatever node it is
linked to, and the overlay converges hop-by-hop.  Leaving withdraws the
routes in-band; dying is detected by hello/carrier failure.  No central
controller — and, since this refactor, no omniscient route installer —
exists anywhere in this file; the global BFS survives only as the test
oracle (:meth:`MeshTopology.oracle_distances`).

:class:`LidcSystem` wires network + clusters + lake + client together for
examples, tests and benchmarks.

The port's copy of ``repro/core/overlay.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

from .cluster import ComputeCluster
from .forwarder import Consumer, Face, Forwarder, Network, link
from .gateway import Gateway
from .matchmaker import HBM_GB_PER_CHIP
from .names import Name, canonical_job_name
from .packets import Data, Interest
from .routing import RoutingAgent, RoutingConfig
from .strategy import BestRouteStrategy, Strategy

__all__ = ["Overlay", "MeshTopology", "LidcClient", "LidcSystem"]


class Overlay:
    """A star/partial-mesh overlay rooted at an edge router.

    The edge router is *not* a controller: it holds no job state and is
    never told any routes — it learns them from the clusters' in-band
    advertisements, exactly like any NDN router running the protocol.
    """

    def __init__(self, net: Network, strategy: Optional[Strategy] = None,
                 routing: Optional[RoutingConfig] = None):
        self.net = net
        self.routing_cfg = routing or RoutingConfig()
        self.edge = Forwarder(net, "edge", strategy=strategy or BestRouteStrategy())
        self.edge_agent = RoutingAgent(self.edge, self.routing_cfg)
        self.edge_agent.start()
        self.links: Dict[str, Tuple[Face, Face]] = {}
        self.clusters: Dict[str, ComputeCluster] = {}
        self.gateways: Dict[str, Gateway] = {}
        self.agents: Dict[str, RoutingAgent] = {}

    # -- membership ----------------------------------------------------------
    def announced_prefixes(self, cluster: ComputeCluster) -> List[Name]:
        """What the cluster advertises — derived from its capability
        record (see :meth:`ComputeCluster.advertised_prefixes`), not from
        a static endpoint list held by the overlay."""
        return cluster.advertised_prefixes()

    def add_cluster(self, cluster: ComputeCluster, *, latency: float = 0.002,
                    validators=None, legacy_nack: bool = False) -> Gateway:
        """Join: link the gateway node; the cluster *advertises* its
        prefixes and capability record through the protocol.  Nothing is
        written into the edge's FIB from here.  ``legacy_nack`` restores
        the historical bare ``no-capacity`` Nack on saturation instead of
        the ETA-carrying busy receipt."""
        gw = Gateway(cluster, validators=validators, legacy_nack=legacy_nack)
        edge_face, gw_face = link(self.net, self.edge, cluster.node, latency)
        self.links[cluster.name] = (edge_face, gw_face)
        self.clusters[cluster.name] = cluster
        self.gateways[cluster.name] = gw
        agent = RoutingAgent(cluster.node, self.routing_cfg,
                             name=cluster.name)
        self.agents[cluster.name] = agent
        # refreshes re-sample the record so free_chips/queue_depth gossip live
        agent.caps_provider = cluster.capability_record
        self.edge_agent.add_neighbor(edge_face)
        agent.add_neighbor(gw_face)
        agent.start()
        self._advertise_cluster(cluster, agent)
        cluster.on_caps_changed = (
            lambda c=cluster, a=agent: self._advertise_cluster(c, a))
        return gw

    def _advertise_cluster(self, cluster: ComputeCluster,
                           agent: RoutingAgent) -> None:
        """(Re-)originate the cluster's advertisements from its current
        capability record; prefixes it no longer serves (e.g. it
        advertised its chips down to zero) are withdrawn in-band."""
        caps = cluster.capability_record()
        wanted = {str(p): p for p in cluster.advertised_prefixes()}
        for prefix_s in [p for p in agent.origins if p not in wanted]:
            agent.withdraw(Name.parse(prefix_s))
        for prefix in wanted.values():
            agent.originate(prefix, caps=caps)

    def remove_cluster(self, name: str) -> None:
        """Graceful leave: withdraw routes in-band, then drop the link."""
        cluster = self.clusters.pop(name, None)
        self.gateways.pop(name, None)
        agent = self.agents.pop(name, None)
        if cluster is None:
            return
        if agent is not None:
            agent.withdraw_all()
            agent.flush_now()   # withdrawals hit the wire before the cut
            agent.stop()        # no zombie heartbeat after removal
        cluster.on_caps_changed = None
        edge_face, gw_face = self.links.pop(name)
        edge_face.down = gw_face.down = True
        self.edge_agent.remove_neighbor(edge_face.face_id)

    def fail_cluster(self, name: str) -> None:
        """Abrupt failure: the cluster goes dark *without* withdrawing
        routes — the hard case the decentralized design must survive.
        Until the edge's routing agent notices the dead carrier at its
        next heartbeat and purges the routes locally, only timeouts/NACK
        absence reveal the failure; no withdrawal is ever sent.
        """
        cluster = self.clusters[name]
        cluster.fail()
        edge_face, _ = self.links[name]
        edge_face.down = True   # packets toward the dead cluster vanish

    def heal_cluster(self, name: str) -> None:
        cluster = self.clusters[name]
        cluster.restore()
        edge_face, _ = self.links[name]
        edge_face.down = False

    def partition(self, names: Iterable[str]) -> None:
        """Overlay partition: the named clusters stay *alive* (jobs keep
        running, state is kept) but both link directions are cut — the
        fault-injection hook for split-brain scenarios.  No withdrawal is
        sent (exactly like :meth:`fail_cluster`, but with the cluster's
        clock still ticking): timeouts reveal the cut first, then each
        side's routing agent detects the dead carrier at its next
        heartbeat and purges its own routes; healing resyncs in-band."""
        for name in names:
            edge_face, gw_face = self.links[name]
            edge_face.down = gw_face.down = True

    def heal_partition(self, names: Iterable[str]) -> None:
        """Reconnect clusters cut by :meth:`partition`."""
        for name in names:
            edge_face, gw_face = self.links[name]
            edge_face.down = gw_face.down = False


# ---------------------------------------------------------------------------
# Multi-hop mesh topologies (the 100-cluster scale story)
# ---------------------------------------------------------------------------

class MeshTopology:
    """N forwarders wired into a ring / tree / random mesh — a dumb link
    fabric plus one :class:`~repro_torch.core.routing.RoutingAgent` per node.

    The star :class:`Overlay` above models one edge router; this models the
    *multi-organization* deployments the paper targets — every node is an
    independent NDN forwarder, producers announce prefixes from arbitrary
    nodes, and routes disseminate **hop-by-hop through the routing
    protocol**: no function in this class writes another node's FIB.
    Equal-cost next hops (and near-equal detours, within the protocol's
    multipath slack) all appear in the derived FIBs, so strategies see
    real multipath and failover choices.

    Churn is first-class: :meth:`leave` gracefully withdraws a node's
    announcements in-band, :meth:`fail_node` makes it go dark (neighbors
    detect the dead link and send triggered updates — the hard case),
    :meth:`heal_node` brings it back (hello resync), and :meth:`add_node`
    grows the mesh mid-run.  :meth:`converge` drives the virtual clock
    until the derived FIBs agree with the retained global-BFS **oracle**
    (:meth:`oracle_distances`) — the oracle verifies the protocol, it
    never installs anything.
    """

    KINDS = ("ring", "tree", "random")

    def __init__(self, net: Network, n: int, kind: str = "ring", *,
                 seed: int = 0, extra_edges: Optional[int] = None,
                 latency: float = 0.001,
                 strategy_factory: Optional[Callable[[int], Strategy]] = None,
                 routing: Optional[RoutingConfig] = None):
        if kind not in self.KINDS:
            raise ValueError(f"unknown topology kind {kind!r}; want {self.KINDS}")
        self.net = net
        self.kind = kind
        self.latency = latency
        self.routing_cfg = routing or RoutingConfig()
        self._strategy_factory = strategy_factory
        self.nodes: List[Forwarder] = []
        self.agents: List[RoutingAgent] = []
        self.adjacency: Dict[int, Set[int]] = {}
        self.down: Set[int] = set()
        # (i, j) -> the face on node i that leads to node j
        self.faces: Dict[Tuple[int, int], Face] = {}
        # origin -> prefixes its local producers serve (drives re-announce)
        self._producer_prefixes: Dict[int, List[Name]] = {}
        self._bfs_cache: Dict[int, Dict[int, int]] = {}
        for _ in range(n):
            self.add_node()
        rng = random.Random(seed)
        if kind == "ring":
            for i in range(n):
                self.connect(i, (i + 1) % n)
        elif kind == "tree":
            for i in range(1, n):
                self.connect(i, (i - 1) // 2)
        else:  # random: spanning tree + extra chords, deterministic by seed
            for i in range(1, n):
                self.connect(i, rng.randrange(i))
            chords = n // 3 if extra_edges is None else extra_edges
            for _ in range(chords):
                a, b = rng.randrange(n), rng.randrange(n)
                if a != b:
                    self.connect(a, b)

    # -- construction / membership ------------------------------------------
    def add_node(self, name: Optional[str] = None) -> int:
        idx = len(self.nodes)
        strategy = (self._strategy_factory(idx)
                    if self._strategy_factory is not None else None)
        node = Forwarder(self.net, name or f"mesh{idx}", strategy=strategy)
        self.nodes.append(node)
        agent = RoutingAgent(node, self.routing_cfg)
        agent.start()
        self.agents.append(agent)
        self.adjacency[idx] = set()
        self._bfs_cache.clear()
        return idx

    def connect(self, i: int, j: int) -> None:
        if j in self.adjacency[i] or i == j:
            return
        fa, fb = link(self.net, self.nodes[i], self.nodes[j], self.latency)
        self.faces[(i, j)] = fa
        self.faces[(j, i)] = fb
        self.agents[i].add_neighbor(fa)
        self.agents[j].add_neighbor(fb)
        self.adjacency[i].add(j)
        self.adjacency[j].add(i)
        self._bfs_cache.clear()

    # -- announcements (protocol origination; nothing global) ----------------
    def announce(self, origin: int, prefix: Name,
                 caps: Optional[Dict[str, Any]] = None) -> None:
        """Originate ``prefix`` at ``origin`` — dissemination is entirely
        the routing protocol's job from here."""
        if origin in self.down:
            return
        self.agents[origin].originate(prefix, caps=caps)

    def withdraw(self, origin: int, prefix: Name) -> None:
        """Withdraw one origin's announcement in-band (anycast twins
        announced elsewhere are untouched — per-origin sequence-gated
        withdrawals cannot sever another origin's routes)."""
        self.agents[origin].withdraw(prefix)
        served = self._producer_prefixes.get(origin)
        if served and prefix in served:
            served.remove(prefix)

    def attach_producer(self, origin: int, prefix: Name, handler) -> None:
        """Producer app at a node: local handler + protocol announcement."""
        self.nodes[origin].attach_producer(prefix, handler)
        self._producer_prefixes.setdefault(origin, []).append(prefix)
        self.announce(origin, prefix)

    def consumer_at(self, idx: int, name: str = "consumer") -> Consumer:
        return Consumer(self.net, self.nodes[idx], name=name)

    def refresh_routes(self) -> None:
        """Compatibility shim for callers that used to force global
        re-convergence: every *alive* node runs one local failure-detect +
        re-originate + flush round immediately instead of waiting for its
        next heartbeat.  Still strictly neighbor-to-neighbor."""
        for idx, agent in enumerate(self.agents):
            if idx not in self.down:
                agent.poke()

    def converge(self, *, timeout: float = 30.0, step: float = 0.05) -> float:
        """Drive the virtual clock until the protocol's derived FIBs agree
        with the BFS oracle (or ``timeout`` virtual seconds elapse).
        Returns the virtual time spent; raises if convergence never came.
        """
        deadline = self.net.now + timeout
        t0 = self.net.now
        while True:
            if self.is_converged():
                return self.net.now - t0
            if self.net.now >= deadline:
                raise TimeoutError(
                    f"routing did not converge within {timeout}s "
                    f"(virtual); divergent state remains")
            self.net.run(until=min(self.net.now + step, deadline))

    # -- the retained global-BFS oracle (verification only) ------------------
    def oracle_distances(self, origin: int) -> Dict[int, int]:
        """Hop distances from ``origin`` over currently-alive nodes.  This
        is the old global-BFS installer demoted to a *test oracle*: the
        property tests and the convergence benchmark compare the
        protocol's derived FIBs against it; nothing forwards with it."""
        cached = self._bfs_cache.get(origin)
        if cached is not None:
            return cached
        dist: Dict[int, int] = {origin: 0}
        q = deque([origin])
        while q:
            u = q.popleft()
            for v in self.adjacency[u]:
                if v not in dist and v not in self.down:
                    dist[v] = dist[u] + 1
                    q.append(v)
        self._bfs_cache[origin] = dist
        return dist

    def announced(self) -> Dict[Tuple[str, ...], List[int]]:
        """prefix key -> alive origins currently announcing it."""
        out: Dict[Tuple[str, ...], List[int]] = {}
        for origin, prefixes in self._producer_prefixes.items():
            if origin in self.down:
                continue
            for p in prefixes:
                if str(p) in self.agents[origin].origins:
                    out.setdefault(p.components, []).append(origin)
        return out

    def is_converged(self) -> bool:
        """Does every alive node's FIB agree with the oracle on both
        *reachability* and *shortest-path cost* for every announcement?

        Assumes announcements carry no capability cost (the mesh tests and
        benchmarks announce bare prefixes), so FIB cost == hop distance.
        """
        announced = self.announced()
        # oracle maps fetched once per key per call — the check runs every
        # convergence step over every node, so the inner loops below stay
        # allocation-free (raw keys, no per-probe Name construction)
        dist_maps = {key: [self.oracle_distances(o) for o in origins]
                     for key, origins in announced.items()}
        for u in range(len(self.nodes)):
            if u in self.down:
                continue
            node = self.nodes[u]
            fib = node.fib
            faces = node.faces
            for key, maps in dist_maps.items():
                want = None
                for m in maps:
                    d = m.get(u)
                    if d is not None and (want is None or d < want):
                        want = d
                hops = fib.nexthops_by_key(key)
                if want is None or want == 0:
                    if want == 0:
                        continue    # the origin node itself: FIB content free
                    # unreachable: no usable route may remain — a nexthop
                    # through a live face is stale
                    for h in hops.values():
                        if not faces[h.face_id].down:
                            return False
                else:
                    have = None
                    for h in hops.values():
                        if have is None or h.cost < have:
                            have = h.cost
                    if have != float(want):
                        return False
            # and nothing *extra*: prefixes nobody announces must be gone
            for key in fib.keys():
                if key not in dist_maps:
                    for h in fib.nexthops_by_key(key).values():
                        if not faces[h.face_id].down:
                            return False
        return True

    # -- churn ----------------------------------------------------------------
    def leave(self, idx: int) -> None:
        """Graceful leave: flood withdrawals in-band, then drop the links.
        The departed node's agent retires (no zombie heartbeat); unlike
        :meth:`fail_node`, a leave is permanent."""
        self.agents[idx].withdraw_all()
        self.agents[idx].flush_now()    # withdrawals leave before the cut
        self.agents[idx].stop()
        self._producer_prefixes.pop(idx, None)
        self.fail_node(idx)

    def fail_node(self, idx: int) -> None:
        """Node goes dark without withdrawing routes (the hard case):
        neighbors find out via carrier/hello failure detection and send
        triggered updates — there is no oracle to clean up after it."""
        self.down.add(idx)
        self._bfs_cache.clear()
        for j in self.adjacency[idx]:
            self.faces[(idx, j)].down = True
            self.faces[(j, idx)].down = True

    def heal_node(self, idx: int) -> None:
        self.down.discard(idx)
        self._bfs_cache.clear()
        for j in self.adjacency[idx]:
            if j in self.down:
                continue        # the far end is still dark — keep the link cut
            self.faces[(idx, j)].down = False
            self.faces[(j, idx)].down = False

    def __len__(self) -> int:
        return len(self.nodes)


# ---------------------------------------------------------------------------
# Client facade
# ---------------------------------------------------------------------------

@dataclass
class JobHandle:
    request_name: Name
    receipt: Dict[str, Any]
    status_history: List[Dict[str, Any]] = field(default_factory=list)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None

    @property
    def job_id(self) -> Optional[str]:
        return self.receipt.get("job_id")

    @property
    def state(self) -> str:
        if self.status_history:
            return self.status_history[-1]["state"]
        return self.receipt.get("state", "Unknown")


class LidcClient:
    """The paper's sample client application (§IV.A): submit → poll → fetch."""

    def __init__(self, net: Network, attach_to: Forwarder, name: str = "client"):
        self.net = net
        self.consumer = Consumer(net, attach_to, name=name)

    # -- one-shot name fetch -------------------------------------------------
    def fetch(self, name: Name, **kw) -> Optional[Data]:
        box = self.consumer.get(name, **kw)
        return box.get("data")

    # -- job workflow ----------------------------------------------------------
    def submit(self, fields: Dict[str, Any], retries: int = 3,
               lifetime: float = 4.0) -> Optional[JobHandle]:
        """Express a compute Interest; returns a handle with the receipt."""
        name = canonical_job_name(fields)
        box: Dict[str, Any] = {}
        self.consumer.express(
            Interest(name=name, lifetime=lifetime, must_be_fresh=True),
            on_data=lambda d: box.__setitem__("data", d),
            on_fail=lambda r: box.__setitem__("error", r),
            retries=retries)
        self.net.run()
        if "data" not in box:
            return None
        return JobHandle(request_name=name, receipt=box["data"].json())

    def poll_until_done(self, handle: JobHandle, *, interval: float = 0.5,
                        max_polls: int = 10_000,
                        on_poll: Optional[Callable[[Dict[str, Any]], None]] = None
                        ) -> JobHandle:
        """Poll /lidc/status/<cluster>/<job_id> until Completed/Failed.

        Polling rides the virtual clock: each poll is scheduled ``interval``
        seconds after the previous answer, so job "run time" elapses on the
        network's clock, not wall time.
        """
        status_name = Name.parse(handle.receipt["status_name"])
        if handle.receipt.get("state") == "Completed":   # cache shortcut
            handle.status_history.append(
                {"state": "Completed", "job_id": handle.job_id,
                 "result_name": handle.receipt["result_name"]})
            return handle
        state = {"polls": 0, "done": False}

        def poll() -> None:
            if state["done"] or state["polls"] >= max_polls:
                return
            state["polls"] += 1
            self.consumer.express(
                Interest(name=status_name, must_be_fresh=True, lifetime=2.0),
                on_data=on_answer,
                on_fail=on_fail,
                retries=1)

        def on_answer(d: Data) -> None:
            payload = d.json()
            handle.status_history.append(payload)
            if on_poll:
                on_poll(payload)
            if payload["state"] in ("Completed", "Failed"):
                state["done"] = True
                if payload["state"] == "Failed":
                    handle.error = payload.get("error")
            else:
                self.net.schedule(interval, poll)

        def on_fail(reason: str) -> None:
            handle.error = reason
            state["done"] = True

        poll()
        self.net.run()
        return handle

    def fetch_result(self, handle: JobHandle) -> Optional[Dict[str, Any]]:
        rname = Name.parse(handle.receipt["result_name"])
        d = self.fetch(rname)
        if d is None:
            return None
        handle.result = d.json()
        return handle.result

    def run_job(self, fields: Dict[str, Any], **poll_kw
                ) -> Optional[JobHandle]:
        """submit → poll → fetch, the full paper workflow (Fig. 5)."""
        handle = self.submit(fields)
        if handle is None:
            return None
        self.poll_until_done(handle, **poll_kw)
        if handle.state == "Completed":
            self.fetch_result(handle)
        return handle


# ---------------------------------------------------------------------------
# Whole-system facade
# ---------------------------------------------------------------------------

class LidcSystem:
    """Network + overlay + shared data lake + one client, pre-wired.

    Clusters added here need **zero route pre-configuration**: each one
    advertises its prefixes + capability record through the routing
    protocol and the edge learns them in-band.
    """

    def __init__(self, strategy: Optional[Strategy] = None,
                 routing: Optional[RoutingConfig] = None,
                 engine: str = "calendar"):
        from ..datalake.lake import DataLake
        self.net = Network(engine=engine)
        self.overlay = Overlay(self.net, strategy=strategy, routing=routing)
        self.lake = DataLake()
        self.client = LidcClient(self.net, self.overlay.edge)

    def add_cluster(self, name: str, *, chips: int = 8, endpoints=(),
                    latency: float = 0.002, hbm_gb_per_chip: float = HBM_GB_PER_CHIP,
                    memory_model=None, validators=None,
                    max_queue_depth: int = 0, scheduler_config=None,
                    legacy_nack: bool = False) -> ComputeCluster:
        cluster = ComputeCluster(self.net, name, chips=chips,
                                 hbm_gb_per_chip=hbm_gb_per_chip,
                                 lake=self.lake, memory_model=memory_model,
                                 max_queue_depth=max_queue_depth,
                                 scheduler_config=scheduler_config)
        for e in endpoints:
            cluster.add_endpoint(e)
        self.overlay.add_cluster(cluster, latency=latency,
                                 validators=validators,
                                 legacy_nack=legacy_nack)
        return cluster
