"""Pipeline parallelism (GPipe schedule) for the dense transformer, ported
from ``repro/runtime/pipeline.py``.

The layers are split into stages over the ``pipe`` axis of a
``DeviceMesh``, one stage a rank; microbatches flow through the stages in
the classic (n_micro + n_stages - 1)-tick schedule, each hand-off a
``ppermute(i -> i+1)`` and, in the backward pass, its reverse.  Activations
are held for every microbatch until the backward pass (GPipe memory).

The reference writes the stage as one ``shard_map`` body that every stage
runs on every tick, masked where it has no microbatch, and lets autodiff
transpose it.  Here each stage computes only its own microbatches (stage
0 embeds, the last stage takes the loss) and the backward schedule is
written out, tick by tick, in one ``autograd.Function``: the loss and the
gradients are the reference's.  The same loss and gradients as the
sequential model: ``tests/test_torch_pipeline.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

from ..collectives import ppermute
from ..configs.base import ArchConfig
from ..models import layers as L
from ..models import transformer as T

__all__ = ["make_pp_mesh", "make_pp_loss_fn", "stage_layers"]


def make_pp_mesh(n_stages: int, extra_axes: Tuple[Tuple[str, int], ...] = (), *,
                 device=None):
    """A ``DeviceMesh`` ("pipe", *extra axes) over the default process group
    (which the caller starts), on ``device``'s type: the card unless told
    otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    from .. import resolve_device
    shape = (n_stages,) + tuple(n for _, n in extra_axes)
    names = ("pipe",) + tuple(a for a, _ in extra_axes)
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def stage_layers(cfg: ArchConfig, mesh, n_stages: int) -> range:
    """The layers of this rank's stage."""
    l_per = cfg.n_layers // n_stages
    sid = mesh.get_local_rank("pipe")
    return range(sid * l_per, (sid + 1) * l_per)


class _Stage:
    """What the schedule needs besides tensors: the config, the ``pipe``
    group, this stage's index and blocks, the replicated weights."""

    def __init__(self, cfg, group, n_stages, n_micro, sid, params, layers):
        self.cfg, self.group, self.S, self.M, self.sid = cfg, group, n_stages, n_micro, sid
        self.params = params
        self.blocks = [params.blocks[i] for i in layers]
        self.shared = [params.embed.table, params.final_norm.w]
        if not cfg.tie_embeddings:
            self.shared.append(params.lm_head.w)

    def leaves(self) -> List[torch.Tensor]:
        return self.shared + [p for b in self.blocks for p in b.parameters()]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st: _Stage, tokens, labels, *leaves):
        cfg, S, M, s = st.cfg, st.S, st.M, st.sid
        B, n = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} microbatches")
        toks = tokens.reshape(M, B // M, n)
        lbls = labels.reshape(M, B // M, n)
        table = st.params.embed.table
        # what a stage that sends nothing hands to the collective
        blank = torch.empty((B // M, n, cfg.d_model), dtype=table.dtype, device=table.device)
        grad = any(ctx.needs_input_grad)
        x_in: Dict[int, torch.Tensor] = {}
        out: Dict[int, torch.Tensor] = {}     # each microbatch's output, or its loss
        recv = blank
        loss_sum = torch.zeros((), dtype=torch.float32, device=table.device)
        with torch.set_grad_enabled(grad):
            for t in range(M + S - 1):
                mb = t - s
                if 0 <= mb < M:
                    if s == 0:
                        x = L.embed_lookup(st.params.embed, toks[mb])
                    else:
                        x = x_in[mb] = recv.detach().requires_grad_(grad)
                    for blk in st.blocks:
                        x = T.block_fwd(cfg, blk, x)
                    if s == S - 1:
                        xn = L.rms_norm(st.params.final_norm.w, x, cfg.norm_eps)
                        out[mb] = L.cross_entropy_loss(xn @ T._out_proj(cfg, st.params),
                                                       lbls[mb])
                        loss_sum = loss_sum + out[mb].detach()
                    else:
                        out[mb] = x
                if t < M + S - 2:   # each active stage's output, one stage down
                    perm = [(j, j + 1) for j in range(S - 1) if 0 <= t - j < M]
                    send = out[mb].detach() if (s, s + 1) in perm else blank
                    recv = ppermute(send, st.group, perm)
        # the loss is the last stage's; every stage returns it
        dist.all_reduce(loss_sum, group=st.group)
        ctx.st, ctx.x_in, ctx.out, ctx.blank = st, x_in, out, blank
        return loss_sum / M

    @staticmethod
    def backward(ctx, g_loss):
        st, x_in, out = ctx.st, ctx.x_in, ctx.out
        S, M, s = st.S, st.M, st.sid
        leaves = st.leaves()
        acc: List[Any] = [None] * len(leaves)
        g_recv = None
        for t in reversed(range(M + S - 1)):
            mb = t - s
            g_x = ctx.blank
            if 0 <= mb < M:
                g_out = g_loss / M if s == S - 1 else g_recv
                inputs = ([x_in.pop(mb)] if s > 0 else []) + leaves
                gs = list(torch.autograd.grad(out.pop(mb), inputs, g_out, allow_unused=True))
                if s > 0:
                    g_x = gs.pop(0)
                acc = [a if g is None else (g if a is None else a + g)
                       for a, g in zip(acc, gs)]
            if t > 0:       # each active stage's input gradient, one stage up
                perm = [(j, j - 1) for j in range(1, S) if 0 <= t - j < M]
                g_recv = ppermute(g_x, st.group, perm)
        # the replicated weights: each stage's part, summed over the stages
        n_sh = len(st.shared)
        shared = [torch.zeros_like(p) if a is None else a for p, a in zip(st.shared, acc)]
        flat = torch.cat([a.reshape(-1) for a in shared])
        dist.all_reduce(flat, group=st.group)
        shared = [f.view_as(p) for f, p in zip(flat.split([p.numel() for p in st.shared]),
                                               st.shared)]
        return (None, None, None, *shared, *acc[n_sh:])


def make_pp_loss_fn(cfg: ArchConfig, mesh, *, n_stages: int, n_micro: int):
    """``loss_fn(params, batch)`` running the GPipe schedule over the
    ``pipe`` axis of ``mesh``: the mean next-token loss of ``batch``
    ({"tokens", "labels"}, (B, S), the same on every stage), returned on
    every stage.  ``params`` is the model; a stage reads only its own blocks
    (``stage_layers``) and the replicated embedding, final norm and output
    weights.  Its gradient reaches those: each block's from its stage, the
    replicated weights' summed over the stages (only stage 0 and the last
    contribute; tied embeddings get both).  The last stage's loss per
    microbatch is the final norm, ``out_proj`` and the plain cross-entropy,
    and the loss is their sum over ``n_micro``."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into {n_stages} stages")
    if mesh.size(list(mesh.mesh_dim_names).index("pipe")) != n_stages:
        raise ValueError(f"the mesh's pipe axis is not {n_stages} stages")
    group = mesh.get_group("pipe")
    layers = stage_layers(cfg, mesh, n_stages)

    def loss_fn(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        st = _Stage(cfg, group, n_stages, n_micro, mesh.get_local_rank("pipe"), params,
                    layers)
        return _GPipe.apply(st, batch["tokens"], batch["labels"], *st.leaves())

    return loss_fn
