"""Faults planted under the timed path, to show that the check of
``correct`` fails them.  Used by ``calibrate.py`` on the card and by the
tests on the CPU; a benchmark run never plants one.

- ``state_unchanged``: serving writes no new state into the cache (the
  family's part); training returns the optimizer state and parameters
  unchanged.
- ``half_batch``: a decode step computes only the first half of the slots
  (the rest get token 0; the family's part); a training step takes the
  mean loss over the first half of the rows.
- ``answer_altered``: every request's third served token is replaced
  where the engine produces it; one leaf's update (the family's
  ``MOVED_TWICE``) is applied twice.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Callable, Iterator, Optional

__all__ = ["FAULTS", "patched", "planted", "wrap_train_step"]

FAULTS = ("state_unchanged", "half_batch", "answer_altered")
ALTERED_TOKEN = 3         # the served token of every request that is replaced


@contextmanager
def patched(obj, attr: str, value) -> Iterator[None]:
    """``obj.attr`` set to ``value`` for the body's duration."""
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


@contextmanager
def planted(family, fault: Optional[str]) -> Iterator[None]:
    """Plant a serving-side fault in the port for the body's duration: the
    family's part (``family.planted``) and the part every family shares
    (the training faults are applied by ``wrap_train_step``)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    with family.planted(fault), _shared(fault):
        yield


def _shared(fault: str):
    """AdamW's update returning its state unchanged, or the engine's served
    token altered; nothing for ``half_batch``."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.serve import engine
    if fault == "state_unchanged":
        def update(self, grads, state, params):
            return state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}
        return patched(adamw.AdamW, "update", update)
    if fault == "answer_altered":
        real_step = engine.ServeEngine.step

        def step(self):
            done = real_step(self)
            for i, req in enumerate(self.slots):
                if req is not None and len(req.out) == ALTERED_TOKEN:
                    req.out[-1] = (req.out[-1] + 1) % self.cfg.vocab
                    self.last_tokens[i, 0] = req.out[-1]
            for req in done:
                if len(req.out) == ALTERED_TOKEN:
                    req.out[-1] = (req.out[-1] + 1) % self.cfg.vocab
            return done
        return patched(engine.ServeEngine, "step", step)
    return nullcontext()


def wrap_train_step(family, fault: Optional[str], step_fn: Callable) -> Callable:
    """The training step with a training fault planted around it."""
    if fault == "half_batch":
        return lambda state, batch: step_fn(
            state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    if fault == "answer_altered":
        def altered(state, batch):
            import torch
            leaf = dict(state["params"].named_parameters())[family.MOVED_TWICE]
            before = leaf.detach().clone()
            out = step_fn(state, batch)
            with torch.no_grad():
                leaf.add_(leaf - before)
            return out
        return altered
    return step_fn
