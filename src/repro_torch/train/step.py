"""Train and serve steps over a model bundle, ported from
``repro/train/step.py``.

The train step is loss -> gradients -> (optionally compressed) reduce ->
AdamW, with the reference's remat policies and microbatch accumulation in
f32.  It runs eagerly: there is no ``jit``, and the parameters and moments
are updated in place.  The serve steps are the entry point through which the
JAX package serves the families its ``ServeEngine`` does not take (MoE,
hybrid, xLSTM, the encoder-decoder).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import spans
from ..collectives import pmean
from ..configs.base import ArchConfig
from ..models.model import bundle_for, model_module
from ..models.sharding import is_dtensor
from ..models.transformer import dtype_of
from ..optim.adamw import AdamW
from ..optim.compress import compressed_psum_pod

__all__ = ["make_train_state", "train_state_shape", "make_train_step", "make_prefill",
           "make_serve_step"]

State = Dict[str, Any]   # {"params": the model, "opt": AdamWState}
Batch = Dict[str, torch.Tensor]


def make_train_state(cfg: ArchConfig, seed: int, optimizer: AdamW, *,
                     device=None) -> State:
    """Random parameters (``bundle.init`` with ``seed``), requiring grad, and
    zeroed f32 moments, on ``device`` (the card unless told otherwise)."""
    params = bundle_for(cfg).init(cfg, seed, device=device)
    params.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params)}


def train_state_shape(cfg: ArchConfig, optimizer: AdamW) -> State:
    """The train state on the meta device: every shape and dtype, no storage
    (the reference's ``eval_shape`` of it)."""
    params = model_module(cfg).Model(cfg, device="meta", dtype=dtype_of(cfg))
    params.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params)}


def _split_microbatches(batch: Batch, n: int) -> List[Batch]:
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    return [{k: x[i * (B // n):(i + 1) * (B // n)] for k, x in batch.items()}
            for i in range(n)]


def _compressed_over_pods(g: torch.Tensor, p: torch.Tensor, pod, mesh) -> torch.Tensor:
    """``compressed_psum_pod`` of a DTensor gradient of the global mean loss
    (the dry run's train step), rank by rank: each rank's pod part (a
    partial sum over ``pod``, or a replicated gradient read as n equal
    parts) of the whole gradient, gathered over the other mesh dims, is
    scaled to the gradient of the pod's own mean loss as the reference's
    per-pod step computes it, then summed over the pods in int8 (the
    reference's sum of the pods' gradients), and laid out as the parameter
    again.  Whole, because the reference quantizes the pod's whole gradient
    (one int8 scale for all of it, one for each pod's chunk of it); each
    rank's shard alone would be rounded by other scales."""
    from torch.distributed.tensor import Replicate

    from ..kernels.sharded import local_region
    i = list(mesh.mesh_dim_names).index("pod")
    partial = g.placements[i].is_partial()
    scale = mesh.size(i) if partial else 1
    inp = [Replicate()] * mesh.ndim
    inp[i] = g.placements[i] if partial else Replicate()
    whole = local_region(lambda gl: compressed_psum_pod(gl * scale, pod), mesh, (inp,),
                         [Replicate()] * mesh.ndim)(g)
    return whole.redistribute(mesh, p.placements)


def make_train_step(cfg: ArchConfig, optimizer: AdamW, *, remat: str = "none",
                    microbatch: int = 1, compress_pods: bool = False,
                    mesh=None) -> Callable[[State, Batch], Tuple[State, Dict]]:
    """``train_step(state, batch)`` -> (state, {"loss", "grad_norm", "lr"},
    0-dim tensors).  With ``microbatch`` > 1 the batch is split along its
    first dim and the gradients are summed in f32, then averaged, as the
    reference's scan does.

    With ``compress_pods``, ``mesh`` (a ``DeviceMesh``) has a ``pod`` axis
    and each of its ranks is one pod holding the replicated state and its
    shard of the batch: the pod's gradients go through
    ``optim.compress.compressed_psum_pod`` over ``pod`` and its loss is
    averaged over ``pod``, then AdamW runs on every pod alike.  As in the
    reference (``repro/train/step.py:72-95``) the gradients are the *sum*
    over pods while the loss is their mean."""
    bundle = bundle_for(cfg)

    def loss_and_grads(params, batch: Batch):
        leaves = list(params.parameters())
        with spans.span("train.forward") if spans.on else spans.OFF:
            loss = bundle.loss_fn(cfg, params, batch, remat=remat)
        # autograd launches the backward's kernels from threads of its own
        with spans.span("train.backward") if spans.on else spans.OFF:
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def grads_of(params, batch: Batch):
        if microbatch <= 1:
            return loss_and_grads(params, batch)
        tot_loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        tot_g: Optional[List[torch.Tensor]] = None
        for mb in _split_microbatches(batch, microbatch):
            loss, grads = loss_and_grads(params, mb)
            if tot_g is None:
                tot_g = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                         for g in grads]
            tot_g = [a + g.float() for a, g in zip(tot_g, grads)]
            tot_loss = tot_loss + loss
        inv = 1.0 / microbatch
        return tot_loss * inv, [g * inv for g in tot_g]

    if not compress_pods:
        grad_fn = grads_of
    else:
        if mesh is None or "pod" not in mesh.mesh_dim_names:
            raise ValueError("compress_pods needs a mesh with a 'pod' axis")
        pod = mesh.get_group("pod")

        def grad_fn(params, batch: Batch):
            loss, grads = grads_of(params, batch)
            if is_dtensor(loss):
                return loss, [_compressed_over_pods(g, p, pod, mesh)
                              for g, p in zip(grads, params.parameters())]
            return (pmean(loss, [pod]),
                    [compressed_psum_pod(g, pod) for g in grads])

    def train_step(state: State, batch: Batch) -> Tuple[State, Dict[str, torch.Tensor]]:
        loss, grads = grad_fn(state["params"], batch)
        with spans.span("train.optimizer") if spans.on else spans.OFF:
            opt, metrics = optimizer.update(grads, state["opt"], state["params"])
        return {"params": state["params"], "opt": opt}, {"loss": loss, **metrics}

    return train_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill(cfg: ArchConfig) -> Callable:
    """``prefill(params, {"tokens": (B, S)}, max_seq=None)`` -> (last-position
    logits (B, 1, V), cache); the encoder-decoder takes ``{"frames": (B, F,
    D), "tokens": (B, S)}``."""
    bundle = bundle_for(cfg)

    def prefill(params, inputs: Dict[str, torch.Tensor], max_seq: Optional[int] = None):
        if cfg.family == "encdec":
            return bundle.prefill(cfg, params, inputs, max_seq=max_seq)
        return bundle.prefill(cfg, params, inputs["tokens"], max_seq=max_seq)

    return prefill


def make_serve_step(cfg: ArchConfig) -> Callable:
    """``serve_step(params, cache, tokens (B, 1))`` -> (logits (B, 1, V),
    cache)."""
    bundle = bundle_for(cfg)

    def serve_step(params, cache, tokens: torch.Tensor):
        return bundle.decode_step(cfg, params, cache, tokens)

    return serve_step
