"""Logical-axis sharding rules and the sharded layouts of whole models,
ported from ``repro/models/sharding.py``.

Weights and activations are named by *logical* axes, which the rules in
force map onto the axes of the mesh in force.  The baseline recipe:

* ``batch``   -> ("pod", "data")     (DP over pods and the data axis)
* ``tp``      -> "model"             (Megatron tensor parallel)
* ``expert``  -> "model"             (expert parallel, MoE with E >= axis)
* ``fsdp``    -> "data"              (parameter/optimizer sharding, big archs)
* ``seq``     -> "data"              (sequence-sharded long-context caches)

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the axis names, put in force with ``use_mesh``; a
collective over a mesh axis is a collective over that dim's process group
(``repro_torch.collectives``).  A pspec is a tuple with one entry per
tensor dim: ``None``, an axis name, or a tuple of axis names.  A rule maps
to ``None`` when its mesh axes are absent or do not divide the dim.

The layouts: ``param_pspecs`` gives every parameter of a model (and every
AdamW moment of a train state) its pspec by the reference's path rules
over its JAX key; ``placements`` turns a pspec into DTensor placements on
the mesh in force; ``shard`` is the counterpart of
``with_sharding_constraint``: it redistributes a DTensor to the placements
of its logical axes, and returns anything else as it is (the per-rank
tensors of the explicit-collective modules, or every tensor when no mesh
or no rules are in force).
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["AxisRules", "DEFAULT_RULES", "FSDP_RULES", "set_rules", "current_rules",
           "use_rules", "use_mesh", "current_mesh", "logical_to_pspec", "gqa_axes",
           "axis_size", "shard", "param_pspecs", "placements", "is_dtensor", "zeros",
           "local_shape", "contiguous_strides", "batch_laid_out", "parameters_as",
           "pinned", "jax_key"]

Logical = Optional[Union[str, Tuple[str, ...]]]

# logical axis name -> mesh axis (or tuple of mesh axes) or None
AxisRules = Dict[str, Any]

DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "tp": "model",
    "expert": "model",
    "tp_ff": None,         # MoE inner-dim TP (used when E < model axis)
    "fsdp": None,          # off in the faithful baseline for small archs
    "seq": "data",
    "vocab": "model",
}

FSDP_RULES: AxisRules = dict(DEFAULT_RULES, fsdp="data")

_ACTIVE: AxisRules = {}
_MESH = None   # the DeviceMesh in force (use_mesh), or None


def set_rules(rules: AxisRules) -> None:
    global _ACTIVE
    _ACTIVE = dict(rules)


def current_rules() -> AxisRules:
    return _ACTIVE


@contextmanager
def use_rules(rules: AxisRules):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = dict(rules)
    try:
        yield
    finally:
        _ACTIVE = prev


@contextmanager
def use_mesh(mesh):
    """Put ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``) in force, as
    the reference's ``with mesh:`` does."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh():
    return _MESH


def _mesh_axes() -> Dict[str, int]:
    """Axis sizes of the mesh in force (empty if none)."""
    if _MESH is None:
        return {}
    return dict(zip(_MESH.mesh_dim_names, _MESH.shape))


def _resolve(logical: Logical, mesh_axes: Dict[str, int], dim: Optional[int]) -> Any:
    """Map one logical axis to mesh axes, dropping unmapped/ill-fitting ones.

    When the full axis product does not divide the dimension, fall back to
    the longest contiguous run of axes that does (batch=128 can't take
    pod*data*model=512 but happily takes pod*data=32).
    """
    if logical is None:
        return None
    rule = _ACTIVE.get(logical, None) if isinstance(logical, str) else logical
    if rule is None:
        return None
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    live = [a for a in axes if a in mesh_axes]
    if not live:
        return None
    if dim is not None:
        best: list = []
        best_total = 1
        n = len(live)
        for i in range(n):
            for j in range(i + 1, n + 1):
                cand = live[i:j]
                total = 1
                for a in cand:
                    total *= mesh_axes[a]
                if total > 0 and dim % total == 0 and total > best_total:
                    best, best_total = cand, total
        live = best
        if not live:
            return None
    if len(live) == 1:
        return live[0]
    return tuple(live)


def logical_to_pspec(logical_axes: Sequence[Logical],
                     shape: Optional[Sequence[int]] = None) -> Tuple[Any, ...]:
    mesh_axes = _mesh_axes()
    dims = list(shape) if shape is not None else [None] * len(logical_axes)
    return tuple(_resolve(l, mesh_axes, d) for l, d in zip(logical_axes, dims))


def gqa_axes(n_kv: int, head_dim: int):
    """Where to put 'tp' for GQA tensors laid out (..., K, [G,] hd).

    Returns (kv_axis, hd_axis) logical names: shard the kv-head dim when it
    divides the model axis (attention fully local per head group), else
    shard head_dim on BOTH q and cache so the contraction is a local
    partial sum + small psum — never an all-gather of the cache.
    """
    tp = _ACTIVE.get("tp")
    sizes = _mesh_axes()
    n = sizes.get(tp, 1) if isinstance(tp, str) else 1
    if n <= 1:
        return None, None
    if n_kv % n == 0:
        return "tp", None
    if head_dim % n == 0:
        return None, "tp"
    return None, None


def axis_size(*mesh_axis_names: str) -> int:
    sizes = _mesh_axes()
    out = 1
    for a in mesh_axis_names:
        out *= sizes.get(a, 1)
    return out


# ---------------------------------------------------------------------------
# shard: with_sharding_constraint by logical axes
# ---------------------------------------------------------------------------

_PLAIN = (torch.Tensor, torch.nn.Parameter)


def is_dtensor(t: Any) -> bool:
    """Whether ``t`` is a DTensor, without importing ``torch.distributed.
    tensor`` for a plain tensor or parameter (the card's hot path)."""
    if type(t) in _PLAIN or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def placements(pspec: Sequence[Any], mesh=None) -> Tuple[Any, ...]:
    """DTensor placements of ``pspec`` on ``mesh`` (the mesh in force):
    ``Shard(d)`` on each mesh dim that entry d names, ``Replicate()`` on the
    others.  A dim named by several mesh axes is split over them in the
    mesh's order, as JAX splits ``P(("pod", "data"))``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _MESH if mesh is None else mesh
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(pspec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape: Sequence[int], pspec: Sequence[Any], mesh=None) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` array laid out by
    ``pspec`` (every split even, as ``logical_to_pspec`` resolves them)."""
    mesh = _MESH if mesh is None else mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for d, e in zip(shape, tuple(pspec) + (None,) * (len(shape) - len(pspec))):
        for a in () if e is None else ((e,) if isinstance(e, str) else e):
            d //= sizes[a]
        out.append(d)
    return tuple(out)


def zeros(shape: Sequence[int], logical: Sequence[Logical], like: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Zeros of ``shape`` in ``dtype`` (``like``'s) on ``like``'s device;
    where ``like`` is a DTensor, a DTensor laid out by ``logical`` under the
    mesh and rules in force, of which each rank holds only its own shard."""
    dtype = dtype or like.dtype
    if not is_dtensor(like):
        return torch.zeros(tuple(shape), dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor
    pspec = logical_to_pspec(logical, shape)
    local = torch.zeros(local_shape(shape, pspec, like.device_mesh), dtype=dtype,
                        device=like.to_local().device)
    return DTensor.from_local(local, like.device_mesh, placements(pspec, like.device_mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    out, step = [], 1
    for d in reversed(tuple(shape)):
        out.append(step)
        step *= max(d, 1)
    return tuple(reversed(out))


class _Layout(torch.autograd.Function):
    """Redistribute forward; the gradient back to the input's layout, a
    partial sum's as replicated (every summand's gradient is the whole
    one), as XLA transposes a sharding constraint.  DTensor's own backward
    would leave it a partial sum, which the next product then keeps by
    gathering its weights."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Replicate
        ctx.back = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.back), None


def _piece(t: torch.Tensor, pspec: Sequence[Any], mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` laid out by ``pspec``."""
    names = list(mesh.mesh_dim_names)
    for d, e in enumerate(pspec):
        idx, n = 0, 1
        for a in () if e is None else ((e,) if isinstance(e, str) else e):
            size = mesh.shape[names.index(a)]
            idx, n = idx * size + mesh.get_local_rank(a), n * size
        if n > 1:
            t = t.narrow(d, idx * (t.shape[d] // n), t.shape[d] // n)
    return t


def batch_laid_out(cache: Dict[str, torch.Tensor], like: torch.Tensor, batch_dim: int = 1
                   ) -> Dict[str, torch.Tensor]:
    """A cache made whole on each rank (``init_cache``) as DTensors split
    over the batch axes at ``batch_dim`` (0-dim entries replicated), each
    rank keeping its own piece, where ``like`` is a DTensor; else ``cache``
    itself.  No collective: prefill's writes then stay on their ranks."""
    if not is_dtensor(like):
        return cache
    from torch.distributed.tensor import DTensor
    mesh, out = like.device_mesh, {}
    for k, t in cache.items():
        pspec = logical_to_pspec((None,) * batch_dim + ("batch",) if t.dim() else (), t.shape)
        out[k] = DTensor.from_local(_piece(t, pspec, mesh).clone(), mesh,
                                    placements(pspec, mesh), run_check=False, shape=t.shape,
                                    stride=contiguous_strides(t.shape))
    return out


@contextmanager
def parameters_as(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module``'s parameters named in ``tensors`` read as those tensors
    (a rank's local shards, which carry their DTensors' gradients) while the
    block runs, then restored: a region runs the model's own functions."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        saved.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = t
    try:
        yield module
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient laid out as ``x`` is (a DTensor's; the
    identity on anything else): the gradient of a reshape that merged
    replicated heads may come back split where the heads do not divide
    the mesh, which the reshape's backward cannot undo."""
    return _Layout.apply(x, tuple(x.placements)) if is_dtensor(x) else x


def shard(x: torch.Tensor, *logical_axes: Logical) -> torch.Tensor:
    """``x`` laid out by logical axes: a DTensor is redistributed to the
    placements of ``logical_to_pspec(logical_axes, x.shape)`` under the mesh
    and rules in force; anything else, and everything without a mesh or
    rules, is returned as it is."""
    if _MESH is None or not _ACTIVE or not is_dtensor(x):
        return x
    want = placements(logical_to_pspec(logical_axes, x.shape))
    return x if tuple(x.placements) == want else _Layout.apply(x, want)


# ---------------------------------------------------------------------------
# weight sharding rules, by the parameter's JAX key
# ---------------------------------------------------------------------------

# (regex over the '/'-joined JAX key, logical axes per dim), the reference's
# own table.  First match wins.
_WEIGHT_RULES: Tuple[Tuple[str, Tuple[Logical, ...]], ...] = (
    # embeddings & heads
    (r"embed/table$", ("vocab", "fsdp")),
    (r"lm_head/w$", ("fsdp", "vocab")),
    # attention
    (r"(attn|xattn)/wq$", ("fsdp", "tp")),
    (r"(attn|xattn)/wk$", ("fsdp", "tp")),
    (r"(attn|xattn)/wv$", ("fsdp", "tp")),
    (r"(attn|xattn)/wo$", ("tp", "fsdp")),
    (r"(attn|xattn)/b[qkv]$", ("tp",)),
    (r"(attn|xattn)/(q_norm|k_norm)$", (None,)),
    # dense mlp
    (r"mlp/w_(gate|up)$", ("fsdp", "tp")),
    (r"mlp/w_down$", ("tp", "fsdp")),
    # MoE
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w_(gate|up)$", ("expert", "fsdp", "tp_ff")),
    (r"moe/w_down$", ("expert", "tp_ff", "fsdp")),
    # Mamba2 / SSD
    (r"ssm/in_proj$", ("fsdp", "tp")),
    (r"ssm/out_proj$", ("tp", "fsdp")),
    (r"ssm/conv_w$", (None, "tp")),
    (r"ssm/(a_log|dt_bias|d_skip)$", ("tp",)),
    (r"ssm/norm$", ("tp",)),
    # xLSTM
    (r"(mlstm|slstm)/w_(up|qkv|gates|if)$", ("fsdp", "tp")),
    (r"(mlstm|slstm)/w_down$", ("tp", "fsdp")),
    (r"(mlstm|slstm)/r_gates$", (None, "tp", None)),
    (r"(mlstm|slstm)/conv_w$", (None, "tp")),
    (r"(mlstm|slstm)/(b_gates|gn)$", ("tp",)),
    # norms and everything 1-D
    (r"(norm|norm1|norm2|norm3|final_norm|ln)(/w|/b)?$", (None,)),
)


def jax_key(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A port parameter name -> (its JAX key, its index in the stacked
    leading dims): the numeric parts after the first are module-list
    indices, e.g. ``mamba.2.5.ssm.in_proj`` -> (``mamba/ssm/in_proj``,
    (2, 5)); ``shared.attn.wq`` -> (``shared/attn/wq``, ())."""
    head, *parts = name.split(".")
    n = 0
    while parts[n].isdigit():
        n += 1
    return "/".join([head, *parts[n:]]), tuple(int(i) for i in parts[:n])


def _pspec_of(name: str, t: torch.Tensor) -> Tuple[Any, ...]:
    """The reference's spec for the parameter's key with its stacked leading
    ``None``s dropped: the port's per-block modules carry no stacked dim, so
    any leading dims left over (the reference's ``_strip_stack``) are the
    tensor's own."""
    key = jax_key(name)[0]
    for pattern, logical in _WEIGHT_RULES:
        if re.search(pattern, key):
            extra = max(t.dim() - len(logical), 0)
            return logical_to_pspec((None,) * extra + tuple(logical), t.shape)
    return logical_to_pspec((None,) * t.dim(), t.shape)


def param_pspecs(tree: Any) -> Any:
    """Pspecs of a model (``{name: pspec}`` over its named parameters) or of
    a train state (``{"params": ..., "opt": AdamWState(step=(), m=..., v=...)}``,
    each moment its parameter's spec), under the mesh and rules in force, as
    the reference's ``param_pspecs`` gives them for its pytrees."""
    if isinstance(tree, torch.nn.Module):
        return {n: _pspec_of(n, p) for n, p in tree.named_parameters()}
    if isinstance(tree, dict) and set(tree) == {"params", "opt"}:
        opt = tree["opt"]
        moments = {k: {n: _pspec_of(n, t) for n, t in getattr(opt, k).items()}
                   for k in ("m", "v")}
        return {"params": param_pspecs(tree["params"]),
                "opt": type(opt)(step=(), **moments)}
    raise TypeError(f"param_pspecs takes a model or a train state, got {type(tree)}")
