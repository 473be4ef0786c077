"""Serving engine: prefill + decode with continuous batching, ported from
``repro/serve/engine.py`` with the same semantics.

Slots hold independent sequences; each decode step advances every slot by
one token at its own cache position (the per-slot ``index`` path of
``layers.attention_decode``).  New requests are prefilled one at a time
into free slots, in priority order, without stopping the decode loop.  Free
slots keep index 0 and are decoded harmlessly with the rest of the batch.

A request's decode state exports as a named KV checkpoint
(:meth:`ServeEngine.kv_checkpoint`, numpy arrays in the JAX engine's format)
and restores into a fresh engine (:meth:`ServeEngine.restore`), of either
framework; greedy decode then continues bit-identically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device, spans
from ..configs.base import ArchConfig
from ..models.model import bundle_for

__all__ = ["Request", "ServeEngine", "UnsupportedFamilyError",
           "SUPPORTED_FAMILIES"]

# model families the continuous-batching engine can decode (the vlm family
# runs on the dense decoder), as the JAX engine's
SUPPORTED_FAMILIES = ("dense", "vlm")


class UnsupportedFamilyError(ValueError):
    """The engine cannot serve this model family (e.g. moe/hybrid)."""

    def __init__(self, family: str):
        self.family = family
        super().__init__(
            f"continuous batching engine supports families "
            f"{SUPPORTED_FAMILIES}, not {family!r}")


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    eos: Optional[int] = None
    priority: int = 0
    out: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0                 # host clock at submit
    admitted_at: Optional[float] = None       # host clock as its prefill starts
    first_token_at: Optional[float] = None    # host clock at the first token


class ServeEngine:
    """Continuous-batching server.  ``params`` is the port's model; it is
    moved to ``device`` (CUDA unless the caller names another device)."""

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 4,
                 max_seq: int = 256, device=None):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise UnsupportedFamilyError(cfg.family)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self._bundle = bundle_for(cfg)
        self.cache = self._bundle.init_cache(cfg, max_batch, max_seq, device=self.device)
        # vectorized per-slot positions
        self.cache["index"] = torch.zeros((max_batch,), dtype=torch.int32,
                                          device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.last_tokens = np.zeros((max_batch, 1), np.int32)
        self.queue: List[Request] = []
        self._rid = 0
        self.decode_steps = 0
        self.tokens_out = 0
        self.prefill_s = 0.0     # host seconds in prefill, first token included
        self.decode_s = 0.0      # host seconds in decode steps

    # -- API -----------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16,
               eos: Optional[int] = None, priority: int = 0) -> Request:
        self._rid += 1
        req = Request(rid=self._rid, prompt=list(prompt), max_new=max_new,
                      eos=eos, priority=priority, submitted_at=time.perf_counter())
        if max_new <= 0:
            # nothing to decode: finished at submission, never takes a slot
            req.done = True
            return req
        self.queue.append(req)
        return req

    def run(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            with (spans.span("engine.iteration", queued=len(self.queue), busy=self._busy())
                  if spans.on else spans.OFF):
                with spans.span("engine.admit") if spans.on else spans.OFF:
                    done.extend(self._admit())
                done.extend(self.step())
            steps += 1
        return done

    # -- internals --------------------------------------------------------------
    def _busy(self) -> int:
        return sum(s is not None for s in self.slots)

    def _admit(self) -> List[Request]:
        """Fill free slots from the queue in priority order (stable within
        a class).  Returns requests that finished *at prefill* (max_new
        reached or EOS on the first token) — their slot frees immediately,
        so a queued request can take it the same step."""
        finished: List[Request] = []
        for i in range(self.max_batch):
            while self.slots[i] is None and self.queue:
                self.queue.sort(key=lambda r: (-r.priority, r.rid))
                req = self.queue.pop(0)
                self._prefill_into_slot(i, req)
                if req.done:
                    finished.append(req)
        return finished

    @torch.no_grad()
    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        t0 = req.admitted_at = time.perf_counter()
        toks = torch.tensor([req.prompt], dtype=torch.int32, device=self.device)
        logits, c1 = self._bundle.prefill(self.cfg, self.params, toks,
                                          max_seq=self.max_seq)
        # copy the single-row cache into the slot
        self.cache["k"][:, slot] = c1["k"][:, 0]
        self.cache["v"][:, slot] = c1["v"][:, 0]
        self.cache["index"][slot] = len(req.prompt)
        t_sync = time.perf_counter() if spans.on else 0.0
        nxt = int(torch.argmax(logits[0, -1]))
        req.first_token_at = time.perf_counter()
        self.prefill_s += req.first_token_at - t0
        if spans.on:
            p = spans.record("engine.prefill", t0, req.first_token_at, rid=req.rid, slot=slot,
                             tokens=len(req.prompt))
            spans.record("engine.sync", t_sync, req.first_token_at, parent=p)
        req.out.append(nxt)
        self.tokens_out += 1
        self.last_tokens[slot, 0] = nxt
        self.slots[slot] = req
        if (len(req.out) >= req.max_new or len(req.prompt) >= self.max_seq
                or (req.eos is not None and nxt == req.eos)):
            # budget exhausted (or EOS) on the prefill token itself, or a
            # prompt that filled the cache, leaving no position for the
            # next token's key: the request never enters the decode loop
            # and its slot is free for the next queued request this very
            # step
            req.done = True
            self.slots[slot] = None
            self.cache["index"][slot] = 0

    @torch.no_grad()
    def step(self) -> List[Request]:
        """One decode step for all active slots."""
        if not any(s is not None for s in self.slots):
            return []
        t0 = time.perf_counter()
        tokens = torch.from_numpy(self.last_tokens).to(self.device)
        logits, self.cache = self._bundle.decode_step(self.cfg, self.params,
                                                      self.cache, tokens)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        t_sync = time.perf_counter() if spans.on else 0.0
        nxt = nxt.cpu().numpy()
        t1 = time.perf_counter()
        self.decode_s += t1 - t0
        self.decode_steps += 1
        if spans.on:
            p = spans.record("engine.decode", t0, t1, busy=self._busy())
            spans.record("engine.sync", t_sync, t1, parent=p)
        finished: List[Request] = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            self.tokens_out += 1
            self.last_tokens[i, 0] = tok
            full = len(req.prompt) + len(req.out) >= self.max_seq - 1
            if (len(req.out) >= req.max_new or full
                    or (req.eos is not None and tok == req.eos)):
                req.done = True
                finished.append(req)
                self.slots[i] = None
                self.cache["index"][i] = 0
        return finished

    # -- named KV checkpoint / restore ----------------------------------------
    def kv_checkpoint(self, req: Request) -> Dict[str, Any]:
        """Export a live request's decode state for publication as named
        Data: the used span of its per-slot KV cache (numpy, f32 for a
        bf16 cache, as the JAX checkpoint keys carry bf16) plus the token
        context."""
        slot = self.slots.index(req)
        used = int(self.cache["index"][slot])

        def span(t: torch.Tensor) -> np.ndarray:
            t = t[:, slot, :used]
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

        return {
            "k": span(self.cache["k"]),
            "v": span(self.cache["v"]),
            "prompt": list(req.prompt),
            "out": list(req.out),
            "max_new": req.max_new,
            "eos": req.eos,
            "priority": req.priority,
        }

    def restore(self, state: Dict[str, Any]) -> Request:
        """Re-create a checkpointed request in a free slot of this engine.

        The imported KV covers ``prompt + out[:-1]`` (the cache index at
        checkpoint time); the last emitted token is re-fed as the decode
        input, exactly as it would have been on the original cluster.
        """
        try:
            slot = self.slots.index(None)
        except ValueError:
            raise RuntimeError("no free slot to restore into") from None
        k = np.asarray(state["k"], dtype=np.float32)
        used = k.shape[1]
        if used > self.max_seq:
            raise ValueError(f"checkpoint spans {used} > max_seq={self.max_seq}")
        self._rid += 1
        req = Request(rid=self._rid, prompt=list(state["prompt"]),
                      max_new=int(state["max_new"]), eos=state.get("eos"),
                      priority=int(state.get("priority", 0)),
                      out=list(state["out"]), submitted_at=time.perf_counter())
        for name, arr in (("k", k), ("v", np.asarray(state["v"], dtype=np.float32))):
            self.cache[name][:, slot, :used] = torch.tensor(
                arr, device=self.device, dtype=self.cache[name].dtype)
        self.cache["index"][slot] = used
        self.last_tokens[slot, 0] = int(req.out[-1])
        self.slots[slot] = req
        return req
