"""The training driver, ported from ``repro/train/trainer.py``: data ->
steps -> named checkpoints -> results.

``run_training`` runs on the card unless ``device="cpu"`` is passed; with
no card and no device it raises.  It resumes from the latest named
checkpoint of ``run_name`` in the lake, which may have been written by the
reference's trainer (the arrays are the same).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import resolve_device
from ..ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs.base import ArchConfig, ShapeConfig
from ..data.pipeline import make_pipeline
from ..optim.adamw import AdamW
from ..optim.schedule import warmup_cosine
from .step import make_train_state, make_train_step, train_state_shape

__all__ = ["TrainResult", "run_training"]


@dataclass
class TrainResult:
    run: str
    steps_done: int
    losses: List[float] = field(default_factory=list)
    resumed_from: Optional[int] = None
    wall_time: float = 0.0
    # the train state after the last step (the reference returns none: its
    # state was donated to the jitted step)
    state: Optional[Dict[str, Any]] = field(default=None, repr=False)

    @property
    def final_loss(self) -> Optional[float]:
        return self.losses[-1] if self.losses else None


def run_training(cfg: ArchConfig, *, steps: int, batch: int = 8, seq: int = 64,
                 lake=None, run_name: str = "run", ckpt_every: int = 0, seed: int = 0,
                 lr: float = 3e-3, remat: str = "none", microbatch: int = 1,
                 dataset: Optional[str] = None,
                 on_step: Optional[Callable[[int, float], None]] = None,
                 stop_flag: Optional[Callable[[], bool]] = None,
                 device=None) -> TrainResult:
    """Train for ``steps`` optimizer steps, checkpointing into the lake every
    ``ckpt_every`` steps and at the end.  Resumes from the latest named
    checkpoint of ``run_name`` if one exists."""
    t0 = time.time()
    device = resolve_device(device)
    shape = ShapeConfig("custom", "train", seq, batch)
    optimizer = AdamW(lr=warmup_cosine(lr, max(steps // 20, 2), steps))

    resumed_from = None
    start_step = 0
    last = latest_step(lake, run_name) if lake is not None and ckpt_every > 0 else None
    if last is not None and last > 0:
        state, start_step = restore_checkpoint(lake, run_name,
                                               train_state_shape(cfg, optimizer),
                                               device=device)
        resumed_from = start_step
    else:
        state = make_train_state(cfg, seed, optimizer, device=device)

    step_fn = make_train_step(cfg, optimizer, remat=remat, microbatch=microbatch)
    it = iter(make_pipeline(cfg, shape, lake=lake, dataset=dataset, seed=seed))

    result = TrainResult(run=run_name, steps_done=start_step, resumed_from=resumed_from)
    for step in range(start_step, steps):
        if stop_flag is not None and stop_flag():
            break
        batch_dev = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        state, metrics = step_fn(state, batch_dev)
        loss = float(metrics["loss"])
        result.losses.append(loss)
        result.steps_done = step + 1
        if on_step is not None:
            on_step(step, loss)
        if lake is not None and ckpt_every > 0 and (step + 1) % ckpt_every == 0:
            save_checkpoint(lake, run_name, step + 1, state, meta={"loss": loss})
    # the last state, unless the loop has just saved it (the reference saves
    # it twice; one copy of a large state is enough host memory)
    if (lake is not None and ckpt_every > 0 and result.steps_done > start_step
            and result.steps_done % ckpt_every):
        save_checkpoint(lake, run_name, result.steps_done, state,
                        meta={"loss": result.final_loss})
    result.state = state
    result.wall_time = time.time() - t0
    return result
