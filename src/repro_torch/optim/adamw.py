"""AdamW, ported from ``repro/optim/adamw.py``.

The moments mirror the parameters: one f32 tensor per parameter, keyed by
the parameter's name in the model (``blocks.3.attn.wq``).  The update is the
reference's, op for op, in f32: a global-norm clip of the gradients (summed
in f32), bias correction with the learning rate read at the incremented
step, decoupled weight decay on parameters of two or more dims only, and
the new parameter rounded once to its dtype.  The dims counted are those
of the reference's array, which stacks the layers of a module list along
leading dims: a block's norm weight, ``(d,)`` here, is ``(L, d)`` there and
decays; the final norm's does not.  Unlike the reference, which
returns new arrays, ``update`` writes the parameters and the moments in
place (it saves a copy of the whole train state per step) and returns the
new step.

``update`` dispatches as ``kernels/ops.py`` does: plain CUDA tensors go to
the fused kernel (``kernels/adamw.py``, three launches a step for all the
leaves), which launches or raises; CPU tensors and DTensors (whose norm
needs the mesh's reduction) take ``plain_update``, the leaf-by-leaf loop.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..kernels import adamw as fused

__all__ = ["AdamW", "AdamWState", "reference_dims"]

Moments = Dict[str, torch.Tensor]


def reference_dims(name: str, p: torch.Tensor) -> int:
    """The dims of ``p``'s array in the reference's parameter tree: its own,
    plus one for each module-list index in its name (``blocks.3.norm1.w``
    is a row of the stacked ``blocks/norm1/w``)."""
    return p.dim() + sum(part.isdigit() for part in name.split("."))


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-dim int32, on the parameters' device
    m: Moments
    v: Moments


class AdamW(NamedTuple):
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: nn.Module) -> AdamWState:
        named = list(params.named_parameters())
        device = named[0][1].device
        # laid out as the parameter (a DTensor's moments are DTensors of its
        # placements)
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,  # noqa: E731
                                           memory_format=torch.contiguous_format)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          m={n: zeros(p) for n, p in named},
                          v={n: zeros(p) for n, p in named})

    def decays(self, named: Sequence[Tuple[str, torch.Tensor]]) -> List[bool]:
        """Whether each named parameter takes the weight decay."""
        return [self.weight_decay > 0 and reference_dims(n, p) >= 2 for n, p in named]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState, params: nn.Module
               ) -> Tuple[AdamWState, Dict[str, torch.Tensor]]:
        """One step with ``grads`` in the order of ``params.named_parameters()``.
        Returns the new state (the moments updated in place) and the metrics
        {"grad_norm", "lr"}, 0-dim tensors."""
        named = list(params.named_parameters())
        leaves = [p for _, p in named]
        if not fused.takes(leaves):
            return self.plain_update(grads, state, params)
        step = state.step + 1
        lr = self.lr(step)
        gnorm = fused.adamw_update(leaves, list(grads), [state.m[n] for n, _ in named],
                                   [state.v[n] for n, _ in named], self.decays(named), step,
                                   lr, b1=self.b1, b2=self.b2, eps=self.eps,
                                   weight_decay=self.weight_decay, grad_clip=self.grad_clip)
        return AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}

    @torch.no_grad()
    def plain_update(self, grads: Sequence[torch.Tensor], state: AdamWState, params: nn.Module
                     ) -> Tuple[AdamWState, Dict[str, torch.Tensor]]:
        """``update`` leaf by leaf in eager ops: the plain version of the
        fused kernel, and the path of CPU tensors and DTensors."""
        named = list(params.named_parameters())
        step = state.step + 1
        gsq = torch.stack([torch.sum(torch.square(g.float())) for g in grads]).sum()
        gnorm = torch.sqrt(gsq)
        scale = (torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
                 if self.grad_clip > 0 else 1.0)
        stepf = step.float()
        c1 = 1.0 - torch.pow(self.b1, stepf)
        c2 = 1.0 - torch.pow(self.b2, stepf)
        lr = self.lr(step)
        for (name, p), g, decays in zip(named, grads, self.decays(named)):
            g = g.float() * scale
            m = self.b1 * state.m[name] + (1 - self.b1) * g
            v = self.b2 * state.v[name] + (1 - self.b2) * g * g
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if decays:
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)                # rounded once to p's dtype
            state.m[name].copy_(m)
            state.v[name].copy_(v)
        return AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
