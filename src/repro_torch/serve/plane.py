"""The named inference serving plane: sessions as compute Interests.

This module turns the compute plane into an inference service with
the paper's location-independence property end to end:

* A **session** is an ordinary compute Interest under the model-rooted
  namespace ``/lidc/serve/<model>/sid=…&p=<prompt digest>&…``.  The
  ETA-aware :class:`~repro_torch.core.strategy.AdaptiveStrategy` places it on
  whichever advertising cluster predicts the earliest completion; busy
  receipts, decentralized spill and priority preemption apply to
  sessions exactly as to batch jobs, because a session *is* a job — the
  executor returns an :class:`~repro_torch.core.cluster.ExecPlan` whose phases
  are **chunk boundaries** (first phase = prefill + first token, later
  phases = ``chunk_tokens`` decode steps).
* **Streaming** is named Data: the executor publishes each token chunk
  under ``/lidc/data/serve/sess/<sid>/chunk=i`` and the client polls
  chunk names through the forwarder — Content Stores cache chunks, PIT
  aggregates concurrent watchers, and no connection state exists
  anywhere.
* **KV/prefix state** is named Data too (:mod:`repro_torch.datalake.kv`):
  every chunk boundary republishes the session's resume checkpoint and
  declared-size KV stub, and the first boundary publishes the prompt's
  chained prefix blocks.  A second session sharing a prompt prefix —
  on *any* cluster — skips the cached span's prefill and pays only the
  (analytic) KV transfer.  A mid-stream cluster kill loses at most the
  in-flight chunk: the client's stall detector re-expresses the session
  Interest, routing (carrier detection withdrew the dead cluster) lands
  it elsewhere, and the executor there resumes decode from the named
  checkpoint — fetching the session KV through the segment
  pipeline.

Decode itself is modeled: tokens come from the deterministic
:func:`token_at`, so a resumed stream is bit-identical to an unbroken
one and benchmarks can *verify* failover instead of trusting it.  (The
real-engine analog — greedy decode surviving a KV checkpoint/restore —
is held by ``tests/test_torch_serve_engine.py`` on
:class:`repro_torch.serve.engine.ServeEngine`.)  This module never imports
JAX: the plane runs on the virtual clock at benchmark scale.

The port's copy of ``repro/serve/plane.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.cluster import ComputeCluster, ExecPlan, ExecResult
from ..core.forwarder import Consumer, Forwarder, Network
from ..core.jobs import PROMPT_FIELD, SESSION_FIELD
from ..core.matchmaker import ServiceEndpoint
from ..core.names import serve_session_name
from ..core.packets import Interest, verify_trusted
from ..core.resilience import SESSION_EXPRESS, SESSION_RESUBMIT, RetryPolicy
from ..datalake.fetch import SegmentFetcher
from ..datalake.kv import (chunk_name, longest_cached_prefix, prompt_name,
                           publish_prefix_blocks, publish_prompt,
                           publish_session_kv, session_ckpt_name,
                           session_kv_name)

__all__ = ["ServeModelSpec", "ServingPlane", "SessionClient", "token_at"]


def token_at(prompt_digest: str, i: int, vocab: int = 32000) -> int:
    """The deterministic decode stand-in: token ``i`` of the stream for a
    given prompt.  A pure function of (prompt, position) — exactly the
    property greedy decoding has — so any two clusters decoding the same
    session agree token-for-token, and failover tests can assert the
    resumed stream equals the unbroken one."""
    h = hashlib.sha256(f"{prompt_digest}:{i}".encode()).digest()
    return int.from_bytes(h[:4], "big") % vocab


@dataclass
class ServeModelSpec:
    """Cost model of one served model on one cluster's hardware."""

    model: str                       # routing unit: /lidc/serve/<model>
    family: str = "dense"            # advertised; validated against engine
    chips: int = 1                   # chips one session occupies
    prefill_tok_s: float = 8000.0    # prompt tokens prefillable per second
    decode_step_s: float = 0.02      # seconds per generated token
    chunk_tokens: int = 8            # tokens per streamed chunk (phase)
    block_tokens: int = 32           # tokens per hashed KV prefix block
    kv_bytes_per_token: float = 131072.0   # declared KV size (analytic)
    kv_fetch_bytes_s: float = 4e9    # cross-cluster KV transfer bandwidth


class ServingPlane:
    """Install inference serving on a cluster: one named serve endpoint
    per model + the structural session-ETA estimator."""

    def __init__(self, cluster: ComputeCluster, spec: ServeModelSpec):
        self.cluster = cluster
        self.spec = spec
        self.stats: Dict[str, float] = {
            "sessions": 0, "resumes": 0, "tokens_out": 0, "chunks": 0,
            "prefix_hits": 0, "prefix_blocks_hit": 0,
            "prefix_blocks_published": 0, "kv_fetches": 0,
            "kv_bytes_fetched": 0.0,
        }
        self._fetch_consumer: Optional[Consumer] = None
        cluster.add_endpoint(ServiceEndpoint(
            service=f"serve-{spec.model}.lidck8s.svc.cluster.local",
            app="serve", archs=(spec.model,), families=(spec.family,),
            min_chips=1, max_chips=max(1, spec.chips),
            executor=self._execute))
        # sessions' run times are structural (prefill + max_new decode
        # steps) — plug the exact predictor into the scheduler so session
        # ETAs are right from the first request, no learning lag
        cluster.scheduler.cfg.run_estimator = self._estimate

    # ------------------------------------------------------------ estimate
    def _estimate(self, spec) -> Optional[float]:
        if spec.app != "serve":
            return None
        f = spec.fields
        ptoks = int(f.get("ptoks", 0))
        max_new = int(f.get("max_new", 16))
        return (ptoks / self.spec.prefill_tok_s
                + max_new * self.spec.decode_step_s)

    # ------------------------------------------------------------- execute
    def _execute(self, job, cluster: ComputeCluster):
        s = self.spec
        f = job.spec.fields
        sid = str(f.get(SESSION_FIELD, job.job_id))
        pdig = str(f.get(PROMPT_FIELD, ""))
        max_new = int(f.get("max_new", 16))
        lake = cluster.lake
        assert lake is not None, "serving requires a data lake"
        self.stats["sessions"] += 1

        prompt_obj = lake.get_json(prompt_name(pdig))
        if prompt_obj is None:
            raise ValueError(f"prompt {pdig!r} not in the lake")
        prompt: List[int] = list(prompt_obj["tokens"])

        if max_new <= 0:
            return ExecResult(payload={"sid": sid, "tokens_out": 0,
                                       "chunks": 0}, duration=1e-6)

        # chunk layout: chunk 0 is the single first token (TTFT), later
        # chunks carry chunk_tokens each
        bounds = [1]
        while sum(bounds) < max_new:
            bounds.append(min(s.chunk_tokens, max_new - sum(bounds)))

        # resume: completed chunks are named in the lake (the checkpoint
        # the previous cluster republished at every boundary)
        start_chunk = 0
        ckpt = lake.get_json(session_ckpt_name(sid))
        if ckpt is not None:
            start_chunk = int(ckpt.get("chunks_done", 0))
        resumed = 0 < start_chunk < len(bounds)

        # phase-0 cost: resume pays the named-KV transfer; a fresh session
        # pays prefill minus whatever prompt prefix is already named in
        # the lake (computed anywhere), plus that span's KV transfer
        if resumed:
            self.stats["resumes"] += 1
            kv_bytes = (len(prompt) + sum(bounds[:start_chunk])) \
                * s.kv_bytes_per_token
            lead_in = kv_bytes / s.kv_fetch_bytes_s
            self._fetch_session_kv(sid, kv_bytes)
        else:
            cached_toks, cached_blocks = longest_cached_prefix(
                lake, s.model, prompt, block_tokens=s.block_tokens)
            if cached_blocks:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_blocks_hit"] += cached_blocks
            lead_in = ((len(prompt) - cached_toks) / s.prefill_tok_s
                       + cached_toks * s.kv_bytes_per_token
                       / s.kv_fetch_bytes_s)

        done_before = sum(bounds[:start_chunk])

        def chunk_fn(i: int, first_done: int, ntok: int):
            def work() -> None:
                toks = [token_at(pdig, first_done + j) for j in range(ntok)]
                lake.put_json(chunk_name(sid, i), {
                    "sid": sid, "chunk": i, "tokens": toks,
                    "cluster": cluster.name})
                total = first_done + ntok
                publish_session_kv(
                    lake, sid, model=s.model, tokens_done=total,
                    kv_bytes=(len(prompt) + total) * s.kv_bytes_per_token)
                lake.put_json(session_ckpt_name(sid), {
                    "sid": sid, "chunks_done": i + 1, "tokens_done": total,
                    "kv": str(session_kv_name(sid)), "cluster": cluster.name})
                if i == 0:
                    self.stats["prefix_blocks_published"] += \
                        publish_prefix_blocks(
                            lake, s.model, prompt,
                            block_tokens=s.block_tokens,
                            kv_bytes_per_token=s.kv_bytes_per_token)
                self.stats["chunks"] += 1
                self.stats["tokens_out"] += ntok
            return work

        phases = []
        done = done_before
        for i in range(start_chunk, len(bounds)):
            ntok = bounds[i]
            dur = ntok * s.decode_step_s + (lead_in if i == start_chunk
                                            else 0.0)
            phases.append((dur, chunk_fn(i, done, ntok)))
            done += ntok

        return ExecPlan(
            phases=phases,
            finalize=lambda: ExecResult(
                payload={"sid": sid, "tokens_out": max_new,
                         "chunks": len(bounds)}, duration=0.0))

    def _fetch_session_kv(self, sid: str, kv_bytes: float) -> None:
        """Pull the (declared-size) session KV through the segment
        pipeline — the stub is real named Data crossing real forwarders
        (and parking in Content Stores); the bytes it *declares* are what
        the resume phase's analytic lead-in charges for."""
        if self._fetch_consumer is None:
            self._fetch_consumer = Consumer(
                self.cluster.net, self.cluster.node,
                name=f"{self.cluster.name}-kv-fetch")

        def on_complete(blob: bytes) -> None:
            self.stats["kv_fetches"] += 1
            self.stats["kv_bytes_fetched"] += kv_bytes

        SegmentFetcher(self.cluster.net, self.cluster.node,
                       session_kv_name(sid),
                       consumer=self._fetch_consumer,
                       on_complete=on_complete,
                       on_error=lambda r: None).start()


# ---------------------------------------------------------------------------
# the client side: express a session, watch its named chunk stream
# ---------------------------------------------------------------------------

@dataclass
class SessionResult:
    sid: str
    submitted_at: float
    receipt_cluster: Optional[str] = None
    ttft: Optional[float] = None           # first streamed token latency
    finished_at: Optional[float] = None
    tokens: Dict[int, List[int]] = field(default_factory=dict)  # chunk->toks
    resubmits: int = 0
    failed: Optional[str] = None

    @property
    def finished(self) -> bool:
        return self.finished_at is not None

    def stream(self) -> List[int]:
        out: List[int] = []
        for i in sorted(self.tokens):
            out.extend(self.tokens[i])
        return out


class SessionClient:
    """Express inference sessions and consume their named token streams.

    The client owns the failover loop: if the chunk stream stalls past
    ``stall_timeout`` (the serving cluster died, or the session was
    preempted and spilled), it re-expresses the *same* canonical session
    Interest — a fresh nonce routes around withdrawn prefixes, the next
    cluster's gateway dedupes or resumes, and the stream continues.
    Chunks are deduped by index, so an overlap between the dying and the
    resuming cluster is harmless (tokens are deterministic)."""

    def __init__(self, net: Network, node: Forwarder, lake, *,
                 name: str = "serve-client", lifetime: float = 2.0,
                 poll_interval: float = 0.05, stall_timeout: float = 3.0,
                 max_resubmits: int = SESSION_RESUBMIT.max_retries,
                 express_policy: RetryPolicy = SESSION_EXPRESS):
        self.net = net
        self.node = node
        self.lake = lake
        self.consumer = Consumer(net, node, name=name)
        self.lifetime = lifetime
        self.poll_interval = poll_interval
        self.stall_timeout = stall_timeout
        self.max_resubmits = max_resubmits
        self.express_policy = express_policy
        self.sessions: Dict[str, SessionResult] = {}

    # ----------------------------------------------------------------- api
    def start(self, sid: str, model: str, prompt: List[int], *,
              max_new: int = 16, priority: int = 0, family: str = "dense",
              extra_fields: Optional[Dict[str, Any]] = None) -> SessionResult:
        pdig = publish_prompt(self.lake, prompt)
        fields: Dict[str, Any] = {SESSION_FIELD: sid, PROMPT_FIELD: pdig,
                                  "ptoks": len(prompt), "max_new": max_new,
                                  "family": family}
        if priority:
            fields["prio"] = priority
        fields.update(extra_fields or {})
        name = serve_session_name(model, fields)
        res = SessionResult(sid=sid, submitted_at=self.net.now)
        self.sessions[sid] = res
        self._express(name, res, receipt_only=max_new <= 0)
        if max_new <= 0:
            return res     # receipt-only session: nothing streams
        self._poll(name, res, max_new, idx=0, last_progress=self.net.now)
        return res

    # ----------------------------------------------------------- internals
    def _express(self, name, res: SessionResult,
                 receipt_only: bool = False) -> None:
        def on_receipt(d) -> None:
            if verify_trusted(d) is False:
                # corrupted receipt caught by the HMAC: a streaming
                # session recovers via the chunk poll/stall loop; a
                # receipt-only session must re-express itself
                if (receipt_only and not res.finished
                        and res.resubmits < self.max_resubmits):
                    res.resubmits += 1
                    self.net.schedule(1.1,
                                      lambda: self._express(name, res,
                                                            receipt_only=True))
                return
            payload = d.json()
            res.receipt_cluster = payload.get("cluster")
            if not receipt_only or res.finished:
                return
            if payload.get("state") == "Completed":
                # a max_new=0 session finishes at its Completed receipt
                res.finished_at = self.net.now
            elif res.resubmits < self.max_resubmits:
                # still Pending/Running: re-express until the gateway's
                # result cache answers Completed.  Pending receipts carry
                # ~1 s freshness, so wait it out — a faster re-poll would
                # only be echoed the same receipt by a Content Store
                res.resubmits += 1
                self.net.schedule(1.1,
                                  lambda: self._express(name, res,
                                                        receipt_only=True))

        def on_fail(reason: str) -> None:
            if res.receipt_cluster is None and not res.finished:
                res.failed = reason

        self.consumer.express(
            Interest(name=name, lifetime=self.lifetime, must_be_fresh=True),
            on_data=on_receipt, on_fail=on_fail,
            retries=self.express_policy.max_retries)

    def _poll(self, name, res: SessionResult, max_new: int, *,
              idx: int, last_progress: float) -> None:
        if res.finished:
            return
        cname = chunk_name(res.sid, idx)

        def on_chunk(d) -> None:
            if res.finished:
                return
            if verify_trusted(d) is False:
                # a byte-flipped chunk must never enter the stream; treat
                # it as a miss so the poll loop re-expresses this index
                # (the CS admission gate keeps the garbage uncached, so
                # the retry reaches verified bytes)
                on_miss("corrupt-chunk")
                return
            payload = d.json()
            if idx not in res.tokens:
                res.tokens[idx] = list(payload.get("tokens", ()))
                if res.ttft is None:
                    res.ttft = self.net.now - res.submitted_at
            got = sum(len(v) for v in res.tokens.values())
            if got >= max_new:
                res.finished_at = self.net.now
                return
            self._poll(name, res, max_new, idx=idx + 1,
                       last_progress=self.net.now)

        def on_miss(reason: str) -> None:
            if res.finished:
                return
            now = self.net.now
            stalled = now - last_progress > self.stall_timeout
            if stalled and res.resubmits < self.max_resubmits:
                # the stream died (cluster kill / preemption starvation):
                # re-express the canonical session Interest; routing has
                # withdrawn the dead cluster, so it lands elsewhere and
                # resumes from the named KV checkpoint
                res.resubmits += 1
                self._express(name, res)
                self.net.schedule(
                    self.poll_interval,
                    lambda: self._poll(name, res, max_new, idx=idx,
                                       last_progress=now))
                return
            if stalled:
                res.failed = res.failed or f"stalled:{reason}"
                return
            self.net.schedule(
                self.poll_interval,
                lambda: self._poll(name, res, max_new, idx=idx,
                                   last_progress=last_progress))

        self.consumer.express(
            Interest(name=cname, lifetime=self.lifetime),
            on_data=on_chunk, on_fail=on_miss, retries=0)
