"""Deterministic fault injection on the virtual-clock simulation.

A :class:`FaultInjector` schedules failures at exact virtual times — link
loss and delay windows, cluster crash mid-stage, overlay partition and
heal — and records everything it does in its own trace.  All randomness
(per-packet loss decisions) comes from one ``random.Random(seed)`` owned
by the injector and consumed in event order, so **a fixed seed yields an
identical event trace across runs**: the property the end-to-end workflow
tests assert, and the reason faults live on the virtual clock rather than
in wall-time monkeypatching.

The injector only uses public hooks: ``Face.loss``/``Face.jitter``
(forwarder), ``Overlay.fail_cluster``/``heal_cluster``/``partition``/
``heal_partition`` (overlay).

The port's copy of ``repro/workflow/faults.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

from ..core.forwarder import Face, Network
from ..core.overlay import Overlay

__all__ = ["FaultInjector"]


@dataclass
class FaultInjector:
    net: Network
    seed: int = 0
    trace: List[Tuple[float, str, str]] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)

    # ------------------------------------------------------------ plumbing
    def _at(self, at: float, kind: str, target: str, fn) -> None:
        def fire() -> None:
            fn()
            self.trace.append((round(self.net.now, 9), kind, target))

        self.net.schedule(max(0.0, at - self.net.now), fire)

    # ------------------------------------------------------------ clusters
    def crash_cluster(self, overlay: Overlay, name: str, at: float) -> None:
        """Cluster goes dark mid-whatever (routes stay — the hard case)."""
        self._at(at, "crash-cluster", name,
                 lambda: overlay.fail_cluster(name))

    def heal_cluster(self, overlay: Overlay, name: str, at: float) -> None:
        self._at(at, "heal-cluster", name,
                 lambda: overlay.heal_cluster(name))

    def partition(self, overlay: Overlay, names: Sequence[str], at: float
                  ) -> None:
        """Cut the named clusters off the overlay; they stay alive."""
        frozen = tuple(names)
        self._at(at, "partition", ",".join(frozen),
                 lambda: overlay.partition(frozen))

    def heal_partition(self, overlay: Overlay, names: Sequence[str],
                       at: float) -> None:
        frozen = tuple(names)
        self._at(at, "heal-partition", ",".join(frozen),
                 lambda: overlay.heal_partition(frozen))

    # ---------------------------------------------------------------- links
    def lossy_link(self, faces: Sequence[Face], rate: float, *,
                   start: float, stop: Optional[float] = None) -> None:
        """Drop each packet on the faces with probability ``rate``.

        Decisions are drawn from the injector's seeded RNG in event order —
        deterministic under a fixed seed."""
        faces = tuple(faces)
        label = f"rate={rate}"

        def begin() -> None:
            for f in faces:
                f.loss = rate
                f.loss_rng = self.rng

        self._at(start, "loss-start", label, begin)
        if stop is not None:
            def end() -> None:
                for f in faces:
                    f.loss = 0.0

            self._at(stop, "loss-stop", label, end)

    def delay_link(self, faces: Sequence[Face], extra: float, *,
                   start: float, stop: Optional[float] = None) -> None:
        """Add ``extra`` seconds of latency to every packet on the faces."""
        faces = tuple(faces)
        label = f"extra={extra}"

        def begin() -> None:
            for f in faces:
                f.jitter = extra

        self._at(start, "delay-start", label, begin)
        if stop is not None:
            def end() -> None:
                for f in faces:
                    f.jitter = 0.0

            self._at(stop, "delay-stop", label, end)

    # ---------------------------------------------------------- gray faults
    def flap_link(self, faces: Sequence[Face], period: float, *,
                  start: float, stop: float, duty: float = 0.5) -> None:
        """Square-wave the faces up/down: down for ``duty * period``, up
        for the rest, phase anchored at ``start`` — fully deterministic
        (no RNG), so two runs flap at identical virtual instants.  The
        link always ends *up* at ``stop``."""
        faces = tuple(faces)
        label = f"period={period}"

        def set_down(flag: bool) -> None:
            for f in faces:
                f.down = flag

        t = start
        while t < stop:
            self._at(t, "flap-down", label, lambda: set_down(True))
            up_at = min(t + duty * period, stop)
            self._at(up_at, "flap-up", label, lambda: set_down(False))
            t += period
        self._at(stop, "flap-end", label, lambda: set_down(False))

    def one_way_partition(self, overlay: Overlay, name: str, *,
                          at: float, heal_at: Optional[float] = None,
                          direction: str = "egress") -> None:
        """Asymmetric partition of a cluster's overlay link: only one
        direction goes dark.  ``egress`` kills the gateway->edge side (the
        cluster can hear but not answer); ``ingress`` kills edge->gateway
        (it answers questions it never receives — i.e. none)."""
        if direction not in ("egress", "ingress"):
            raise ValueError(f"direction must be egress|ingress, "
                             f"got {direction!r}")

        def pick() -> Face:
            edge_face, gw_face = overlay.links[name]
            return gw_face if direction == "egress" else edge_face

        label = f"{name}:{direction}"
        self._at(at, "oneway-partition", label,
                 lambda: setattr(pick(), "down", True))
        if heal_at is not None:
            self._at(heal_at, "oneway-heal", label,
                     lambda: setattr(pick(), "down", False))

    def slow_node(self, cluster: Any, factor: float, *,
                  start: float, stop: Optional[float] = None) -> None:
        """Gray slow node: every ExecPlan phase / job on the cluster takes
        ``factor``x its nominal duration, while the scheduler's ETAs stay
        optimistic until its completion model observes the stretch."""
        label = f"{cluster.name}:x{factor}"
        self._at(start, "slow-node", label,
                 lambda: setattr(cluster, "time_dilation", factor))
        if stop is not None:
            self._at(stop, "slow-node-heal", label,
                     lambda: setattr(cluster, "time_dilation", 1.0))

    def corrupt_link(self, faces: Sequence[Face], rate: float, *,
                     start: float, stop: Optional[float] = None) -> None:
        """Flip one payload byte of Data packets with probability ``rate``
        — the corruption MUST be caught by HMAC verification downstream
        (CS admission gate + consumer checks), never silently served."""
        self._gray_rate(faces, "corrupt", rate, start, stop)

    def duplicate_link(self, faces: Sequence[Face], rate: float, *,
                       start: float, stop: Optional[float] = None) -> None:
        """Deliver packets twice with probability ``rate`` (the twin rides
        one reorder-window behind) — PIT nonce dedup and idempotent
        consumers must absorb it."""
        self._gray_rate(faces, "duplicate", rate, start, stop)

    def reorder_link(self, faces: Sequence[Face], rate: float, *,
                     delay: float = 0.005, start: float,
                     stop: Optional[float] = None) -> None:
        """Hold back packets ``delay`` seconds with probability ``rate``
        so they land behind their successors."""
        faces = tuple(faces)

        def begin() -> None:
            for f in faces:
                f.reorder_delay = delay

        self._at(start, "reorder-delay", f"delay={delay}", begin)
        self._gray_rate(faces, "reorder", rate, start, stop)

    def blackout(self, faces: Sequence[Face], *, at: float, heal_at: float,
                 flag: Optional[List[bool]] = None) -> List[bool]:
        """Crash-like blackout for a bare (non-overlay) node: every face
        drops packets both ways between ``at`` and ``heal_at``, and the
        returned liveness box reads ``[False]`` while dark.  Wire the box
        into a :class:`~repro_torch.datalake.replication.ReplicationManager` as
        ``alive=lambda: box[0]`` to model the manager process dying with
        its node: in-flight transfers fail, the durable retry queue holds
        on the virtual clock, and resumes drain after heal.  Fully
        deterministic — no RNG."""
        faces = tuple(faces)
        box = flag if flag is not None else [True]
        label = f"faces={len(faces)}"

        def set_dark(dark: bool) -> None:
            box[0] = not dark
            for f in faces:
                f.down = dark

        self._at(at, "blackout", label, lambda: set_dark(True))
        self._at(heal_at, "blackout-heal", label, lambda: set_dark(False))
        return box

    def churn(self, faces: Sequence[Face], *, period: float, down: float,
              start: float, stop: float,
              flag: Optional[List[bool]] = None) -> List[bool]:
        """Repeated :meth:`blackout` cycles — crash/heal churn, phase
        anchored at ``start`` like :meth:`flap_link`; always ends healed
        at ``stop``."""
        box = flag if flag is not None else [True]
        t = start
        while t < stop:
            self.blackout(faces, at=t, heal_at=min(t + down, stop), flag=box)
            t += period
        return box

    def _gray_rate(self, faces: Sequence[Face], attr: str, rate: float,
                   start: float, stop: Optional[float]) -> None:
        """Shared arm/disarm plumbing for the per-packet gray faults; the
        per-packet decisions draw from the injector's seeded RNG in event
        order, same contract as :meth:`lossy_link`."""
        faces = tuple(faces)
        label = f"rate={rate}"

        def begin() -> None:
            for f in faces:
                setattr(f, attr, rate)
                f.fault_rng = self.rng

        self._at(start, f"{attr}-start", label, begin)
        if stop is not None:
            def end() -> None:
                for f in faces:
                    setattr(f, attr, 0.0)

            self._at(stop, f"{attr}-stop", label, end)
