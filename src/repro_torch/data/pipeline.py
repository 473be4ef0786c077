"""Token data pipeline, ported from ``repro/data/pipeline.py``.

Named datasets live in the data lake (``/lidc/data/datasets/<name>``); the
pipeline yields numpy batches from a lake-resident corpus or a deterministic
synthetic stream, the same bytes as the reference's for the same seed, and
can prefetch them onto the device on a host thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..lake import lake_name

__all__ = ["SyntheticLM", "LakeCorpus", "Prefetcher", "make_pipeline"]


class SyntheticLM:
    """Deterministic synthetic LM stream: a noisy order-2 Markov chain so
    the loss actually *decreases* under training."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.rng = np.random.default_rng(seed)
        # a small alphabet embedded in the model vocab keeps the stream
        # learnable within tens of steps while exercising the full output
        # projection
        self.alphabet = int(min(64, cfg.vocab))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        v = self.alphabet
        B, S = self.batch, self.seq
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = self.rng.integers(0, v, B)
        noise = self.rng.random((B, S))
        rand = self.rng.integers(0, v, (B, S))
        for t in range(1, S + 1):
            det = (toks[:, t - 1] * 3 + 7) % v
            toks[:, t] = np.where(noise[:, t - 1] < 0.9, det, rand[:, t - 1])
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.family == "encdec":
            batch["frames"] = self.rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
        return batch


class LakeCorpus:
    """Token corpus stored as a named lake object; sliding-window batches."""

    def __init__(self, lake, name, cfg: ArchConfig, batch: int, seq: int, seed: int = 0):
        blob = lake.get_arrays(lake_name(name))
        if blob is None:
            raise FileNotFoundError(f"dataset {name} not in lake")
        self.tokens = blob["tokens"].astype(np.int32) % cfg.vocab
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = self.tokens.size - self.seq - 1
        starts = self.rng.integers(0, max(n, 1), self.batch)
        rows = np.stack([self.tokens[s:s + self.seq + 1] for s in starts])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class Prefetcher:
    """Host-thread prefetch of the next ``depth`` batches.  With a CUDA
    ``device`` each array is pinned and copied to the device without
    blocking the host (the copy is ordered on the stream before any kernel
    that later reads it); with another device, tensors land there."""

    def __init__(self, source: Iterator, depth: int = 2,
                 device: Optional[torch.device] = None):
        self.source = source
        self.device = device
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _place(self, item: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, x in item.items():
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device is not None and self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            elif self.device is not None:
                t = t.to(self.device)
            out[k] = t
        return out

    def _fill(self):
        for item in self.source:
            if self._stop.is_set():
                return
            self.q.put(self._place(item) if self.device is not None else item)
        self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        """Stop the thread: it ends at its next batch (the queue is drained
        so that a full queue does not hold it)."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()


def make_pipeline(cfg: ArchConfig, shape: ShapeConfig, *, lake=None,
                  dataset: Optional[str] = None, seed: int = 0, prefetch: int = 0,
                  device: Optional[torch.device] = None):
    if lake is not None and dataset is not None:
        src: Iterator = LakeCorpus(lake, dataset, cfg, shape.global_batch, shape.seq_len, seed)
    else:
        src = SyntheticLM(cfg, shape.global_batch, shape.seq_len, seed)
    if prefetch > 0:
        return Prefetcher(src, depth=prefetch, device=device)
    return src
