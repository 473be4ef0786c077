"""Executors: the code a cluster runs when the overlay places a job on it,
ported from ``repro/runtime/executors.py`` with the same phases, durations
and payload keys.

* ``train``: real training through ``run_training`` for configs at most
  ``real_param_limit`` parameters, phased with named checkpoints (a cluster
  that dies mid-job loses at most one phase); above the limit the job is
  simulated, its virtual duration from the cost model.
* ``serve``: batched decoding through ``ServeEngine`` for the families the
  engine decodes and configs within the limit; other jobs are simulated.
* ``blast``: the paper's Table-I genomics workload, a small Smith-Waterman
  alignment in numpy on the host, its run time scaled to the dataset.

The virtual durations follow the roofline of one NVIDIA H100 SXM. The
constants below are assumptions taken from NVIDIA's data sheet (dense bf16
tensor-core peak, HBM3 bandwidth and size at the 700 W power limit), as the
reference's are TPU v5e assumptions; ``ASSUMED_MFU`` is the reference's.

Two keywords bind the executors to their host.  ``device`` is where real
work runs: the card unless the caller says ``"cpu"``.  ``plan_type`` and
``result_type`` are the classes the executors build: a reference cluster
tells a phased plan from a result by ``isinstance`` against its own
``ExecPlan``, so a host that adds the port's endpoints to a reference
overlay passes the reference's classes.  By default they are the port's
copies (``runtime/protocol.py``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np

from .. import resolve_device
from ..core.matchmaker import HBM_GB_PER_CHIP  # HBM3, GB
from ..configs.base import ArchConfig, ShapeConfig, get_config, get_shape, registry, smoke_of
from ..models.model import (PORTED_FAMILIES, bundle_for, memory_estimate, model_flops,
                            param_count)
from ..serve.engine import SUPPORTED_FAMILIES, ServeEngine
from ..train.trainer import run_training
from .protocol import ExecPlan, ExecResult

__all__ = ["PEAK_FLOPS", "HBM_BW", "HBM_GB_PER_CHIP", "ASSUMED_MFU",
           "REAL_PARAM_LIMIT", "SERVE_SHAPE", "roofline_step_time", "memory_model",
           "make_train_executor", "make_serve_executor", "blast_executor",
           "smith_waterman"]

# NVIDIA H100 SXM (data sheet, dense, 700 W): assumptions of the cost model
PEAK_FLOPS = 989e12      # bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12         # HBM3, bytes/s
ASSUMED_MFU = 0.4        # the reference's assumption

# the reference's _REAL_TRAIN_PARAM_LIMIT: real compute at or below this
REAL_PARAM_LIMIT = 50_000_000


def roofline_step_time(cfg: ArchConfig, shape: ShapeConfig, chips: int) -> float:
    """Virtual seconds per step from the analytic roofline (cost model)."""
    flops = model_flops(cfg, shape)
    compute = flops / (chips * PEAK_FLOPS * ASSUMED_MFU)
    # memory term: weights + cache traffic once per step
    bytes_ = 2.0 * param_count(cfg, active_only=shape.kind == "decode")
    if shape.kind == "decode":
        bytes_ += 4.0 * cfg.n_kv_heads * cfg.hd * shape.seq_len \
            * shape.global_batch * cfg.n_layers
    memory = bytes_ / (chips * HBM_BW)
    return max(compute, memory, 1e-6)


# the shape the serve executor runs a job at by default: 4 slots of 64
# positions (``max_seq``, ``max_batch``)
SERVE_SHAPE = ShapeConfig("serve", "decode", 64, 4)


def memory_model(spec, chips: int) -> Optional[float]:
    """Matchmaker admission: estimated bytes per chip for a job; ``None``
    where the reference gives none (no arch, an unknown arch or shape) and
    for a family the port does not run.  A job without a shape is sized as
    the reference sizes it (its 256 x 4096 train cell), except a serve job,
    which is sized at the shape the serve executor runs it at: the
    reference's size would keep it off a one-card cluster."""
    arch, shp = spec.arch, spec.shape
    if arch is None:
        return None
    try:
        cfg = get_config(arch)
        if shp:
            shape = get_shape(shp)
        elif spec.app == "serve":
            shape = SERVE_SHAPE
        else:
            shape = ShapeConfig("d", "train", 4096, 256)
    except (KeyError, ModuleNotFoundError):
        return None
    if cfg.family not in PORTED_FAMILIES:
        return None
    return memory_estimate(cfg, shape, chips)


def _resolve_arch(name: str) -> ArchConfig:
    """The config a job's arch names, resolved as the reference resolves it:
    a smoke name matches the first registry arch that starts with its base
    or whose first ``-``-separated token starts it, so ``qwen3-1.7b-smoke``
    names ``qwen3-moe-smoke``."""
    if name.endswith("-smoke") or "smoke" in name:
        base = name.replace("-smoke", "")
        for arch_id in registry():
            if arch_id.startswith(base) or base.startswith(arch_id.split("-")[0]):
                return smoke_of(arch_id)
        raise KeyError(name)
    return get_config(name)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_train_executor(*, ckpt_every: int = 10, batch: int = 4, seq: int = 32,
                        device=None, plan_type=ExecPlan, result_type=ExecResult,
                        real_param_limit: int = REAL_PARAM_LIMIT) -> Callable:
    device = resolve_device(device)

    def executor(job, cluster):
        cfg = _resolve_arch(job.spec.arch)
        steps = job.spec.steps(default=10)
        chips = max(job.granted_chips, 1)
        shape_name = job.spec.shape or "train_4k"
        try:
            shape = get_shape(shape_name)
        except KeyError:
            shape = ShapeConfig(shape_name, "train", seq, batch)
        step_time = roofline_step_time(cfg, shape, chips)
        run_name = f"train-{job.spec.signature()}"
        real = param_count(cfg) <= real_param_limit
        lake = cluster.lake

        n_phases = max(1, math.ceil(steps / ckpt_every))
        losses: Dict[str, Any] = {"history": []}

        def phase_fn(phase_idx: int) -> Callable[[], None]:
            end_step = min((phase_idx + 1) * ckpt_every, steps)

            def work() -> None:
                if not real or lake is None:
                    return  # simulated job: time passes, no compute
                # the trainer sizes its schedule from ``steps``, so a job's
                # schedule depends on its phasing, as in the reference
                res = run_training(cfg, steps=end_step, batch=batch, seq=seq,
                                   lake=lake, run_name=run_name,
                                   ckpt_every=ckpt_every, seed=0, device=device)
                losses["history"].extend(res.losses)
                if res.final_loss is not None:
                    losses["final"] = res.final_loss
                if res.resumed_from is not None:
                    losses.setdefault("resumed_from", res.resumed_from)

            return work

        phases = [(step_time * min(ckpt_every, steps - i * ckpt_every), phase_fn(i))
                  for i in range(n_phases)]

        def finalize():
            payload = {
                "app": "train", "arch": cfg.arch_id, "steps": steps,
                "chips": chips, "step_time_s": step_time,
                "real_compute": real,
                "run_name": run_name,
            }
            if losses.get("final") is not None:
                payload["final_loss"] = losses["final"]
                payload["resumed_from"] = losses.get("resumed_from")
            payload["output_bytes"] = 4 * int(param_count(cfg))
            return result_type(payload=payload, duration=0.0)

        return plan_type(phases=phases, finalize=finalize)

    return executor


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def make_serve_executor(*, max_batch: int = SERVE_SHAPE.global_batch,
                        max_seq: int = SERVE_SHAPE.seq_len, device=None,
                        result_type=ExecResult,
                        real_param_limit: int = REAL_PARAM_LIMIT) -> Callable:
    device = resolve_device(device)

    def executor(job, cluster):
        cfg = _resolve_arch(job.spec.arch)
        n_requests = int(job.spec.fields.get("requests", 4))
        new_tokens = int(job.spec.fields.get("new_tokens", 8))
        chips = max(job.granted_chips, 1)
        shape = ShapeConfig("serve", "decode", max_seq, max_batch)
        step_time = roofline_step_time(cfg, shape, chips)
        real = param_count(cfg) <= real_param_limit and cfg.family in SUPPORTED_FAMILIES
        if real:
            params = bundle_for(cfg).init(cfg, 0, device=device)
            eng = ServeEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                              device=device)
            rng = np.random.default_rng(0)
            for _ in range(n_requests):
                eng.submit(list(rng.integers(0, cfg.vocab, 8)), max_new=new_tokens)
            eng.run()
            tokens = eng.tokens_out
        else:
            tokens = n_requests * new_tokens
        duration = step_time * max(tokens // max_batch, 1)
        return result_type(payload={"app": "serve", "arch": cfg.arch_id,
                                    "requests": n_requests,
                                    "tokens_out": tokens,
                                    "real_compute": real,
                                    "output_bytes": 4 * tokens},
                           duration=duration)

    return executor


# ---------------------------------------------------------------------------
# blast (the paper's own workload, Table I)
# ---------------------------------------------------------------------------

# (srr, db) -> (base run time seconds, output bytes); from the paper's Table I
_TABLE1 = {
    ("SRR2931415", "human"): (8 * 3600 + 9 * 60 + 50, 941 * 2 ** 20),
    ("SRR5139395", "human"): (24 * 3600 + 16 * 60 + 12, int(2.71 * 2 ** 30)),
}


def smith_waterman(a: np.ndarray, b: np.ndarray) -> int:
    """A tiny real alignment (the computation behind the numbers): the best
    local score, match +2, mismatch and gap -1."""
    n, m = len(a), len(b)
    H = np.zeros((n + 1, m + 1), np.int32)
    best = 0
    for i in range(1, n + 1):
        match = np.where(b == a[i - 1], 2, -1)
        for j in range(1, m + 1):
            h = max(0, H[i - 1, j - 1] + match[j - 1], H[i - 1, j] - 1, H[i, j - 1] - 1)
            H[i, j] = h
            best = max(best, h)
    return int(best)


def blast_executor(job, cluster) -> ExecResult:
    srr = str(job.spec.fields.get("srr"))
    db = str(job.spec.fields.get("db", "human"))
    mem = float(job.spec.fields.get("mem", 4))
    cpu = float(job.spec.fields.get("cpu", 2))
    base_time, out_bytes = _TABLE1.get((srr, db), (3600.0, 100 * 2 ** 20))
    # the paper's finding: cpu/mem variation barely moves the run time
    # (I/O-bound); a 2% sensitivity, as Table I's deltas
    duration = base_time * (1.0 - 0.01 * math.log2(max(cpu / 2, 1))
                            - 0.01 * math.log2(max(mem / 4, 1)))
    # seeded from the salted string hash, as in the reference: the score
    # is the same within one process, not across processes
    rng = np.random.default_rng(abs(hash((srr, db))) % 2 ** 31)
    score = smith_waterman(rng.integers(0, 4, 64), rng.integers(0, 4, 64))
    return ExecResult(payload={"app": "blast", "srr": srr, "db": db,
                               "mem": mem, "cpu": cpu,
                               "alignment_score": score,
                               "run_time_s": duration,
                               "output_bytes": out_bytes},
                      duration=duration)
