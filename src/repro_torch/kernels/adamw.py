"""Wrapper of the fused AdamW kernel (``csrc/adamw.cu``).

``adamw_update`` runs one AdamW step over every leaf of a model in three
launches: the gradients' sums of squares by chunk, their fixed-order sum
into the clip's scale and the bias corrections, and the update of p, m and
v, each element read and written once.  It replaces no TPU kernel (the
reference's AdamW is plain JAX) but the plain version's ~22 eager f32 ops a
leaf (``optim/adamw.py::AdamW.plain_update``), whose arithmetic it keeps op
for op.

The work list (``work_list``) is built on the host once per parameter set:
a row per leaf (the p, m and v pointers, the element count, the decay
flag), leaves grouped by their (p, g) dtype pair, and chunks of ``CHUNK``
elements, each inside one leaf.  It is cached under the pointers it holds
and built again when one changes (a checkpoint restored into new tensors).
Each step uploads only the gradients' pointers, asynchronously from pinned
memory: nothing here waits on the device.

The launch is the registered op ``repro_torch::adamw_update``, which
mutates p, m and v; its fake implementation launches nothing, so meta
tensors (the dry run's) take the op and get the norm's shape.  The op takes
plain CUDA tensors; ``takes`` says whether a leaf list is one (a DTensor's
norm needs its mesh's reduction and a CPU tensor has no kernel: both take
the plain version).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.sharding import is_dtensor
from ._build import library

__all__ = ["CHUNK", "adamw_update", "takes", "work_list", "WorkList"]

CHUNK = 1 << 15          # elements per block of the two chunked passes: csrc/adamw.cu's kChunk
_KIND = {torch.float32: 0, torch.bfloat16: 1}


class Group(NamedTuple):
    pdtype: torch.dtype
    gdtype: torch.dtype
    first: int           # its first chunk in the work list
    count: int           # its chunks


class WorkList(NamedTuple):
    order: List[int]                 # leaf indices, grouped by dtype pair: the table's rows
    numel: List[int]                 # per leaf, in the caller's order
    decay: List[bool]
    chunks: List[Tuple[int, int]]    # (table row, chunk of that row's leaf)
    groups: List[Group]

    @property
    def elements(self) -> int:
        return sum(self.numel)


def _kind(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _KIND:
        raise ValueError(f"{what} has dtype {t.dtype}; the AdamW kernel takes float32 and "
                         f"bfloat16")
    return _KIND[t.dtype]


def _pairs(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           decay: Sequence[bool]) -> List[Tuple[torch.dtype, torch.dtype]]:
    """Each leaf's (p, g) dtype pair; raises on a dtype or a size the
    kernel does not take."""
    if not len(params) == len(grads) == len(decay):
        raise ValueError(f"{len(params)} parameters, {len(grads)} gradients, "
                         f"{len(decay)} decay flags")
    pairs = []
    for i, (p, g) in enumerate(zip(params, grads)):
        _kind(p, f"parameter {i}")
        _kind(g, f"gradient {i}")
        if g.numel() != p.numel():
            raise ValueError(f"gradient {i} has {g.numel()} elements, its parameter "
                             f"{p.numel()}")
        pairs.append((p.dtype, g.dtype))
    return pairs


def work_list(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              decay: Sequence[bool]) -> WorkList:
    """The leaves grouped by (p, g) dtype pair, in their order within a
    group, and each leaf cut into chunks of ``CHUNK`` elements (its last one
    shorter).  Reads shapes and dtypes only: meta tensors will do."""
    pairs = _pairs(params, grads, decay)
    numel = [p.numel() for p in params]
    order: List[int] = []
    chunks: List[Tuple[int, int]] = []
    groups: List[Group] = []
    for pair in dict.fromkeys(pairs):                 # in order of first appearance
        first = len(chunks)
        for i, pi in enumerate(pairs):
            if pi == pair:
                chunks += [(len(order), c) for c in range(-(-numel[i] // CHUNK))]
                order.append(i)
        if len(chunks) > first:
            groups.append(Group(*pair, first, len(chunks) - first))
    return WorkList(order, numel, [bool(d) for d in decay], chunks, groups)


def takes(leaves: Sequence[torch.Tensor]) -> bool:
    """Whether AdamW over ``leaves`` goes to the kernel: plain tensors on a
    CUDA device (or meta tensors, which take the op and launch nothing).
    A DTensor and a CPU tensor take the plain version."""
    if not leaves or any(is_dtensor(t) for t in leaves):
        return False
    return leaves[0].is_cuda or leaves[0].is_meta


def _pinned_to(rows, dtype, device) -> torch.Tensor:
    """``rows`` on ``device``, copied from pinned memory without waiting."""
    host = torch.tensor(rows, dtype=dtype, pin_memory=True)
    return host.to(device, non_blocking=True)


class _Plan:
    """A work list on the device: the table, the chunks, the gradients'
    pointer slots and the partial sums."""

    def __init__(self, wl: WorkList, params, m, v, device):
        self.wl = wl
        self.table = _pinned_to([[params[i].data_ptr(), m[i].data_ptr(), v[i].data_ptr(),
                                  wl.numel[i], int(wl.decay[i])] for i in wl.order],
                                torch.int64, device)
        self.chunks = _pinned_to(wl.chunks or [(0, 0)], torch.int32, device)
        self.gptr = torch.empty(len(wl.order), dtype=torch.int64, device=device)
        self.partials = torch.empty(max(len(wl.chunks), 1), dtype=torch.float32,
                                    device=device)


_latest: Tuple[Optional[tuple], Optional[_Plan]] = (None, None)   # a plan under its key


def _check_state(i: int, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, device) -> None:
    for what, t in (("parameter", p), ("first moment", m), ("second moment", v)):
        if t.device != device:
            raise ValueError(f"{what} {i} is on {t.device}, the leaves on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} {i} is not contiguous: the kernel updates it in place")
    for what, t in (("first moment", m), ("second moment", v)):
        if t.dtype != torch.float32 or t.numel() != p.numel():
            raise ValueError(f"{what} {i} must be float32 of {p.numel()} elements, got "
                             f"{t.dtype} of {t.numel()}")


def _plan(params, grads, m, v, decay, device) -> _Plan:
    """The work list of these leaves on the device: the one kept if its key
    (every pointer, size, dtype and decay flag) is theirs, else a new one,
    kept in its place."""
    global _latest
    key = (device, tuple((p.data_ptr(), a.data_ptr(), b.data_ptr(), p.numel(), p.dtype,
                          g.dtype, d) for p, g, a, b, d in zip(params, grads, m, v, decay)))
    if _latest[0] != key:
        for i, (p, a, b) in enumerate(zip(params, m, v)):
            _check_state(i, p, a, b, device)
        _latest = (key, _Plan(work_list(params, grads, decay), params, m, v, device))
    return _latest[1]


def _launch(params: List[torch.Tensor], grads: List[torch.Tensor], m: List[torch.Tensor],
            v: List[torch.Tensor], decay: List[bool], step: torch.Tensor, lr: torch.Tensor,
            b1: float, b2: float, eps: float, weight_decay: float, grad_clip: float
            ) -> torch.Tensor:
    if not len(params) == len(grads) == len(m) == len(v) == len(decay):
        raise ValueError("one gradient, two moments and one decay flag a parameter")
    if not params:
        raise ValueError("no parameters")
    dev = params[0].device
    if not params[0].is_cuda:
        raise ValueError(f"the AdamW kernel takes CUDA tensors, got {dev}")
    if step.device != dev or step.dtype != torch.int32 or step.dim() != 0:
        raise ValueError(f"step must be a 0-dim int32 tensor on {dev}, got {step.dtype} "
                         f"{tuple(step.shape)} on {step.device}")
    if lr.device != dev or lr.dtype != torch.float32 or lr.dim() != 0:
        raise ValueError(f"lr must be a 0-dim float32 tensor on {dev}, got {lr.dtype} "
                         f"{tuple(lr.shape)} on {lr.device}")
    plan = _plan(params, grads, m, v, decay, dev)
    wl = plan.wl
    gs = []                                           # kept alive until the launches
    for i in wl.order:
        g = grads[i]
        if g.device != dev or g.numel() != wl.numel[i]:
            raise ValueError(f"gradient {i} has {g.numel()} elements on {g.device}, its "
                             f"parameter {wl.numel[i]} on {dev}")
        gs.append(g if g.is_contiguous() else g.contiguous())
    plan.gptr.copy_(torch.tensor([g.data_ptr() for g in gs], dtype=torch.int64,
                                 pin_memory=True), non_blocking=True)
    out = torch.empty(4, dtype=torch.float32, device=dev)   # gnorm, scale, c1, c2
    lib, stream = library(), torch.cuda.current_stream(dev).cuda_stream
    c = ctypes.c_float

    def at(t: torch.Tensor, first: int) -> int:      # the address of row `first`
        return t.data_ptr() + first * t.stride(0) * t.element_size()

    for grp in wl.groups:
        err = lib.adamw_grad_sq(plan.table.data_ptr(), plan.gptr.data_ptr(),
                                at(plan.chunks, grp.first), at(plan.partials, grp.first),
                                dev.index, grp.count, _KIND[grp.gdtype], stream)
        if err:
            raise RuntimeError(f"adamw_grad_sq kernel launch failed: CUDA error {err}")
    err = lib.adamw_finish(plan.partials.data_ptr(), step.data_ptr(), out.data_ptr(),
                           dev.index, len(wl.chunks), c(b1), c(b2), c(grad_clip), stream)
    if err:
        raise RuntimeError(f"adamw_finish kernel launch failed: CUDA error {err}")
    for grp in wl.groups:
        err = lib.adamw_apply(plan.table.data_ptr(), plan.gptr.data_ptr(),
                              at(plan.chunks, grp.first), out.data_ptr(), lr.data_ptr(),
                              dev.index, grp.count, _KIND[grp.pdtype], _KIND[grp.gdtype],
                              c(b1), c(1 - b1), c(b2), c(1 - b2), c(eps), c(weight_decay),
                              stream)
        if err:
            raise RuntimeError(f"adamw_apply kernel launch failed: CUDA error {err}")
    adamw_update.launches += 2 * len(wl.groups) + 1
    adamw_update.elements += wl.elements
    return out


@torch.library.custom_op("repro_torch::adamw_update", mutates_args=("params", "m", "v"),
                         device_types="cuda")
def _update_op(params: List[torch.Tensor], grads: List[torch.Tensor], m: List[torch.Tensor],
               v: List[torch.Tensor], decay: List[bool], step: torch.Tensor, lr: torch.Tensor,
               b1: float, b2: float, eps: float, weight_decay: float, grad_clip: float
               ) -> torch.Tensor:
    return _launch(params, grads, m, v, decay, step, lr, b1, b2, eps, weight_decay, grad_clip)


@_update_op.register_fake
def _(params, grads, m, v, decay, step, lr, b1, b2, eps, weight_decay, grad_clip):
    _pairs(params, grads, decay)                      # the dtypes and sizes it would refuse
    return lr.new_empty((4,), dtype=torch.float32)


def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 m: List[torch.Tensor], v: List[torch.Tensor], decay: List[bool],
                 step: torch.Tensor, lr: torch.Tensor, *, b1: float, b2: float, eps: float,
                 weight_decay: float, grad_clip: float) -> torch.Tensor:
    """One AdamW step in place over every leaf, as
    ``optim/adamw.py::AdamW.plain_update`` computes it: ``params`` (bf16 or
    f32) with their ``grads`` (bf16 or f32) and f32 moments ``m`` and
    ``v``, all contiguous on one CUDA device; ``decay`` per leaf; ``step``
    the incremented step (0-dim int32) and ``lr`` its learning rate (0-dim
    f32), both on the device; ``grad_clip`` <= 0 clips nothing.  Returns
    the gradients' global norm (0-dim f32).  Launches 2 x (dtype pairs) + 1
    kernels and does not wait on the device."""
    out = torch.ops.repro_torch.adamw_update(list(params), list(grads), list(m), list(v),
                                             [bool(d) for d in decay], step, lr, float(b1),
                                             float(b2), float(eps), float(weight_decay),
                                             float(grad_clip))
    return out[0]


adamw_update.launches = 0    # kernel launches since the count was last reset
adamw_update.elements = 0    # parameters updated since the count was last reset
