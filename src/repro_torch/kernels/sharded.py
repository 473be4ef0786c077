"""The kernels' calls on DTensors: each runs rank by rank.

DTensor has no sharding strategy for the kernels' ops, so ``ops`` sends a
call on DTensors here.  Each call is a ``local_map`` region (the
counterpart of the reference's ``shard_map``): its inputs are
redistributed to placements under which every rank's shards are one whole
kernel call, the kernel runs on them through ``ops`` (the card's op, or the
plain version on the CPU, as on one device), and its outputs are DTensors
again.  A mesh dim that splits what one call must see whole is replicated
first.  Where the reference's layout splits a decode cache over its head
dim (``gqa_axes``) or its positions (long-context caches), the region
exchanges head-dim slices for whole heads, or merges the ranks' partial
results by their log-sum-exps, so that the kernel still runs on every
rank.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["attention", "decode_attention", "ssd_state_scan", "local_region"]


def local_region(fn, mesh, in_placements, out_placements, in_grad_placements=None):
    """``fn`` on each rank's shards: inputs redistributed to
    ``in_placements`` (None for a non-tensor argument), outputs laid out as
    ``out_placements``."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def _kv_slice(H: int, K: int, n: int) -> bool:
    """Whether a rank's H / n query heads meet whole KV heads of their own
    (H / n a multiple of the group, or the group a multiple of H / n)."""
    G, Hl = H // K, H // n
    return H % n == 0 and (Hl % G == 0 or G % Hl == 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
              ) -> torch.Tensor:
    """GQA attention on DTensors q (B,S,H,hd), k/v (B,T,K,hd).  Per mesh
    dim: a batch shard stays; a head shard of q stays with k/v's (both
    split) or with each rank's own KV heads cut from replicated k/v (the
    reference's "kv repeated inside the attention"), whose gradients are then
    partial sums; anything else is replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from . import ops
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    qp, kp, gp = [], [], []
    cut = None                       # the mesh dim whose ranks cut k/v's heads
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if a.is_shard(0):
            qp.append(Shard(0)), kp.append(Shard(0)), gp.append(Shard(0))
        elif a.is_shard(2) and b.is_shard(2) and K % n == 0 and H % n == 0:
            qp.append(Shard(2)), kp.append(Shard(2)), gp.append(Shard(2))
        elif a.is_shard(2) and cut is None and _kv_slice(H, K, n):
            cut = i
            qp.append(Shard(2)), kp.append(Replicate()), gp.append(Partial())
        else:
            qp.append(Replicate()), kp.append(Replicate()), gp.append(Replicate())

    def run(ql, kl, vl):
        if cut is not None:
            G, Hl = H // K, H // mesh.size(cut)
            c = mesh.get_local_rank(cut)
            lo, hi = c * Hl // G, ((c + 1) * Hl - 1) // G + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return ops.attention(ql, kl, vl, causal=causal)

    return local_region(run, mesh, (qp, kp, kp), qp, (qp, gp, gp))(q, k, v)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     length) -> torch.Tensor:
    """One-token decode on DTensors q (B,1,H,hd), cache (B,Smax,K,hd) and a
    length (a 0-dim or (B,) tensor), the kernel on every rank.  Per mesh
    dim: a batch shard stays, and so does a KV-head shard (q's heads with
    the cache's).  A head-dim split of q and the cache (the reference's
    layout where the KV heads do not divide the mesh dim) becomes, by one
    all-to-all each, every rank's query heads and the whole KV heads they
    read (``_head_plan``): a rank's share of the cache and no more.  A split of the
    cache's positions stays: each rank attends to the positions it holds
    and the ranks' outputs are merged by their log-sum-exps (a max and a
    sum all-reduce), as the kernel's cluster merges its spans.  Anything
    else is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    from . import ops
    mesh = q.device_mesh
    H, K, hd, Smax = q.shape[2], cache_k.shape[2], q.shape[3], cache_k.shape[1]
    qp, cp, lp, op = [], [], [], []
    heads = any(b.is_shard(2) for b in cache_k.placements)
    hd_dim = None                  # the mesh dim whose ranks hold slices of the head dim
    seq: List[int] = []            # the mesh dims that split the cache's positions
    for i, (a, b) in enumerate(zip(q.placements, cache_k.placements)):
        n = mesh.size(i)
        if b.is_shard(0):
            qp.append(Shard(0)), cp.append(Shard(0)), op.append(Shard(0))
            lp.append(Shard(0) if length.dim() else Replicate())
        elif b.is_shard(2) and K % n == 0 and H % n == 0:
            qp.append(Shard(2)), cp.append(Shard(2)), lp.append(Replicate()), op.append(Shard(2))
        elif (b.is_shard(3) and hd_dim is None and not heads and hd % n == 0
              and _head_plan(H, K, n) is not None):
            hd_dim = i
            qp.append(Shard(3)), cp.append(Shard(3)), lp.append(Replicate())
            op.append(Shard(2) if _head_plan(H, K, n)[1] else Replicate())
        elif b.is_shard(1):
            seq.append(i)
            qp.append(Replicate()), cp.append(Shard(1)), lp.append(Replicate())
            op.append(Replicate())
        else:
            qp.append(Replicate()), cp.append(Replicate()), lp.append(Replicate())
            op.append(Replicate())
    parts = 1
    for i in seq:
        parts *= mesh.size(i)
    if Smax % parts:               # uneven position shards: gather them
        for i in seq:
            cp[i] = Replicate()
        seq = []

    def run(ql, kl, vl, ll):
        if hd_dim is not None:
            ql, kl, vl = _whole_heads(mesh, hd_dim, ql, kl, vl)
        if not seq:
            o = ops.decode_attention(ql, kl, vl, ll)
        else:
            at = 0                 # this rank's first position
            for i in seq:
                at = at * mesh.size(i) + mesh.get_local_rank(i)
            o, lse = ops.decode_attention_lse(ql, kl, vl, ll - at * kl.shape[1])
            o = _merge_positions(mesh, seq, o, lse)
        if hd_dim is not None and not _head_plan(H, K, mesh.size(hd_dim))[1]:
            o = _gather_shared(mesh, hd_dim, o, K)
        return o

    return local_region(run, mesh, (qp, cp, cp, lp), op)(q, cache_k, cache_v, length)


def _head_plan(H: int, K: int, n: int):
    """Which heads each of n ranks takes when a decode's head dim is split
    over them: ([(first query head, query heads, first KV head, KV heads)
    for each rank], whether the ranks' query heads are distinct), or None.
    Distinct where the ranks' H / n query heads meet whole KV heads of
    their own (``_kv_slice``); else, where n / K ranks can share each KV
    head, each takes the whole group of its KV head (the group's work done
    n / K times, the output gathered)."""
    G = H // K
    if _kv_slice(H, K, n):
        Hr = H // n
        return [(c * Hr, Hr, c * Hr // G, max(1, Hr // G)) for c in range(n)], True
    if n % K == 0:
        r = n // K
        return [(c // r * G, G, c // r, 1) for c in range(n)], False
    return None


def _whole_heads(mesh, dim: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B,1,H,hd/n) and k/v (B,S,K,hd/n), split over the head dim on mesh
    dim ``dim`` of n ranks -> this rank's query heads of ``_head_plan``
    whole, (B,1,Hr,hd), and the KV heads they read whole, (B,S,nkv,hd):
    one all-to-all each, rank j sending rank c its head-dim slice of c's
    heads."""
    from torch.distributed._functional_collectives import all_to_all_single
    n = mesh.size(dim)
    plan, _ = _head_plan(q.shape[2], k.shape[2], n)

    def exchange(parts: List[torch.Tensor]) -> torch.Tensor:
        # parts[c] goes to rank c; returns (n, ...): slice j from rank j
        x = torch.stack(parts).contiguous()
        y = all_to_all_single(x, None, None, (mesh, dim))
        return y.movedim(0, -2).flatten(-2)           # slices side by side: whole heads

    qw = exchange([q[:, :, h0:h0 + nh] for h0, nh, _, _ in plan])
    kw, vw = (exchange([t[:, :, k0:k0 + nk] for _, _, k0, nk in plan]) for t in (k, v))
    return qw, kw, vw


def _gather_shared(mesh, dim: int, o: torch.Tensor, K: int) -> torch.Tensor:
    """The whole (B,1,H,hd) output from each rank's (B,1,G,hd), where n / K
    ranks at a time took the same KV head's group (``_head_plan``)."""
    from torch.distributed._functional_collectives import all_gather_tensor
    n = mesh.size(dim)
    every = all_gather_tensor(o.contiguous(), 0, (mesh, dim)).unflatten(0, (n, -1))
    return every[::n // K].movedim(0, 2).flatten(2, 3)   # (K, B,1,G,hd) -> (B,1,K G,hd)


def _merge_positions(mesh, dims: List[int], o: torch.Tensor, lse: torch.Tensor
                     ) -> torch.Tensor:
    """The decode output over every rank's positions from each rank's o
    (B,1,H,hd) and lse (B,H) over its own: sum_r o_r e^(lse_r - M) /
    sum_r e^(lse_r - M), M the ranks' largest lse."""
    from torch.distributed._functional_collectives import all_reduce
    m = lse
    for i in dims:
        m = all_reduce(m, "max", (mesh, i))
    w = torch.exp(lse - m)[:, None, :, None]          # (B,1,H,1)
    both = torch.cat([o.float() * w, w], dim=-1)
    for i in dims:
        both = all_reduce(both, "sum", (mesh, i))
    return (both[..., :-1] / both[..., -1:]).to(o.dtype)


def ssd_state_scan(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk scan on DTensors states (B,C,H,P,N), decays (B,C,H),
    init (B,H,P,N): every (b, h, p, n) walks its chunks on its own, so
    shards of B and H (and of P, N) stay; the chunk dim is gathered."""
    from torch.distributed.tensor import Replicate, Shard

    from . import ops
    mesh = chunk_states.device_mesh
    sp: List = []
    ap: List = []
    fp: List = []
    for p in chunk_states.placements:
        d = p.dim if p.is_shard() else None
        if d in (0, 2, 3, 4):
            sp.append(Shard(d))
            ap.append(Shard(d) if d in (0, 2) else Replicate())
            fp.append(Shard(d if d == 0 else d - 1))
        else:
            sp.append(Replicate()), ap.append(Replicate()), fp.append(Replicate())
    args, ins = [chunk_states, chunk_decays], [sp, ap]
    if init_state is not None:
        args.append(init_state), ins.append(fp)
    return local_region(lambda *a: ops.ssd_state_scan(*a), mesh, tuple(ins),
                        (sp, fp))(*args)
