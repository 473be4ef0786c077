"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the
production meshes without hardware, ported from ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder host
devices.  Here each cell is traced once, on the CPU, as rank 0 of a
``fake`` process group of 256 or 512 ranks (``torch.testing._internal.
distributed.fake_pg``: every collective completes at once and moves
nothing) under the production ``DeviceMesh`` (``launch/mesh.make_production_mesh``)
and the arch's rules (``rules_for``, the cache's positions over ``data`` for
``long_500k``).

*Inputs.*  The train state, the parameters, the batch and the cache are
DTensors whose local shards are **meta** tensors (shape and dtype, no
storage), built by ``DTensor.from_local`` on the shard each pspec
(``param_pspecs``, ``batch_pspec``, ``cache_pspecs``) gives rank 0, so that
placing them counts no collective.  Meta rather than fake CUDA tensors:
autograd asks the CUDA device guard for a stream, which a CPU-only build of
torch does not have.  ``kernels.ops`` sends a meta tensor down the card's
path, to the kernels' registered ops, whose fake implementations give the
outputs' shapes: every kernel a cell reaches, forward and backward, is
traced as the card would call it, and nothing is launched.

*What runs.*  The port's own ``make_train_step`` (remat, microbatches,
``compress_pods``), prefill (``make_prefill``, the encoder-decoder with its
frames) or ``make_serve_step``, once.  DTensor propagates the model's plain
ops and inserts the collectives; ``shard`` (``models/sharding.py``) lays
activations out where the reference's ``with_sharding_constraint`` does.
Plain tensors that the model makes (zeros, positions) meet DTensors as
replicated ones (``implicit_replication``).  Regions that DTensor cannot
propagate run rank by rank in ``local_map`` regions, the counterpart of the
reference's ``shard_map``:

* attention, the decode attention and the SSD scan (``kernels/sharded.py``):
  DTensor has no strategy for the kernels' ops;
* the MoE block (``models/moe.py``): the reference's ``shard_map`` branch,
  the port's explicit-collective ``moe_block`` on each rank's expert shard;
* the embedding and the loss over a vocab split over ranks
  (``models/layers.py``): DTensor's masked-partial lookup has no gradient
  it can lay out again, so each rank looks up, and takes the log-sum-exp
  and the label's logit of, its own slice, combined by all-reduces;
* the decode steps' cache writes (``models/layers.py``): in-place scatters
  at a position held on the device, which DTensor has no strategy for;
* the xLSTM's groups and the sLSTM's loop in prefill (``models/xlstm.py``):
  loops of small ops per position that DTensor would dispatch one by one
  (and cannot propagate through the mLSTM's gradient).

Where DTensor would keep a partial sum through a norm and gather the next
weights (it picks layouts by collective bytes alone), ``shard`` at each
block's output projection, with a gradient laid out as XLA transposes a
sharding constraint, keeps the products Megatron-shaped.

*Counts, per rank, in one dispatch mode beneath DTensor* (``Counts``):
it skips every call on DTensors and counts the local ops they become, and
nothing of DTensor's own shape propagation (global-shape fake ops, run
under ``_propagating``):

* FLOPs: ``torch.utils.flop_counter``'s formulas, and for each kernel op a
  formula (``register_flop_formula``) that counts its plain version's
  matrix work on the same shapes (attention 4 B H Sq Sk hd forward, 10 B H
  Sq Sk hd backward, with its recomputed scores; decode 4 B H Smax hd; the
  router's product 2 T D E; the scan and the router's backward, elementwise,
  0, as the counter counts every elementwise op);
* HBM bytes: each local op's input and output bytes, views and collectives
  left out: an unfused, eager count, each op reading its inputs and
  writing its outputs once;
* collective bytes by kind, from the ``_c10d_functional`` ops' (and the
  explicit ``c10d`` collectives') local output shapes;
* argument bytes: the local shards of the inputs; output bytes: those of
  the outputs;
* temp bytes: the peak of the storage the step's ops allocate, counted
  live from allocation until the last tensor on it dies (a
  ``weakref.finalize`` per tensor), inputs excluded.

``roofline/analysis.py::analyze_counts`` turns the counts into the
reference's report.  The reference's ``hloparse.py`` reads XLA's HLO text,
which torch does not produce; the counter takes its place.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

CPU only.  The fake process group (512 ranks; the single pod's mesh is
its first 256) is started once a process; several cells run in parallel,
a process each, as many at a time as the machine has cores.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
import traceback
import warnings
import weakref
from contextlib import ExitStack, contextmanager
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry, register_flop_formula

from ..configs.base import ArchConfig, ShapeConfig, get_config, get_shape, registry, shape_cells
from ..kernels import ops as _ops  # noqa: F401  (registers the kernels' ops)
from ..models.model import input_specs, model_flops, model_module, param_count
from ..models.sharding import (axis_size, contiguous_strides, local_shape, logical_to_pspec,
                               param_pspecs, placements, use_mesh, use_rules)
from ..models.transformer import dtype_of
from ..optim.adamw import AdamW
from ..optim.schedule import constant
from ..roofline.analysis import analyze_counts
from ..train.step import make_prefill, make_serve_step, make_train_step, train_state_shape
from .mesh import make_production_mesh, rules_for

__all__ = ["batch_pspec", "cache_pspecs", "lower_cell", "run_cell", "all_cells", "main",
           "Counts"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")


# ---------------------------------------------------------------------------
# sharding specs for inputs and caches (the reference's, on the port's trees)
# ---------------------------------------------------------------------------

def batch_pspec(name: str, spec: torch.Tensor):
    if name == "frames":
        return logical_to_pspec(("batch", None, None), spec.shape)
    return logical_to_pspec(("batch", None), spec.shape)


_CACHE_AXES = {
    # name -> logical axes, aligned to the *trailing* dims of the array
    "k": ("batch", "seq", "kv", "hd"),
    "v": ("batch", "seq", "kv", "hd"),
    "xk": ("batch", "seq", "kv", "hd"),
    "xv": ("batch", "seq", "kv", "hd"),
    "state": ("batch", "tp", None, None),      # (L,B,H,P,N)
    "conv": ("batch", None, "tp"),             # (L,B,K-1,conv_dim)
    "m_C": ("batch", None, "tp", None),        # (G,m,B,H,hd,hd)
    "m_n": ("batch", None, "tp"),              # (G,m,B,H,hd)
    "m_m": ("batch", None),                    # (G,m,B,H)
    "m_conv": ("batch", None, "tp"),           # (G,m,B,K-1,d_inner)
    "s_h": ("batch", "tp"), "s_c": ("batch", "tp"),
    "s_n": ("batch", "tp"), "s_m": ("batch", "tp"),
    "s_conv": ("batch", None, "tp"),           # (G,B,K-1,D)
}


def cache_pspecs(cfg: ArchConfig, cache: Dict[str, torch.Tensor], *, long_context: bool
                 ) -> Dict[str, Any]:
    """A pspec per cache tensor (the reference's ``cache_pspecs``).

    KV heads shard over 'model' when divisible, else the head_dim does;
    the cache sequence dim shards over 'data' only for long-context cells
    (batch already covers 'data' otherwise).
    """
    tp_size = axis_size("model")

    def spec_for(name, arr):
        if name not in _CACHE_AXES:
            return ()
        axes = list(_CACHE_AXES[name])
        if "kv" in axes:
            kv_ok = tp_size > 0 and cfg.n_kv_heads % max(tp_size, 1) == 0
            axes[axes.index("kv")] = "tp" if kv_ok else None
            axes[axes.index("hd")] = None if kv_ok else "tp"
        if "seq" in axes:
            axes[axes.index("seq")] = "seq" if long_context else None
        logical = (None,) * (arr.dim() - len(axes)) + tuple(axes)
        return logical_to_pspec(logical, arr.shape)

    return {name: spec_for(name, arr) for name, arr in cache.items()}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
        "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "wait_tensor", "_wrap_tensor_autograd",
         "_local_scalar_dense", "device", "sym_size", "sym_stride", "sym_numel", "dim",
         "is_same_size", "_has_compatible_shallow_copy_type"}

_propagating = [0]   # > 0 while DTensor propagates shapes on global fake tensors


@contextmanager
def _quiet_propagation():
    """Mark DTensor's own shape propagation (ops on global-shape fake
    tensors, which no rank runs) so that the counter skips it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, op_schema):
        _propagating[0] += 1
        try:
            return orig(self, op_schema)
        finally:
            _propagating[0] -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counts(TorchDispatchMode):
    """Per-rank FLOPs, HBM bytes, collective bytes by kind and the peak of
    live intermediate storage of the local ops (see the module docstring)."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collectives: Dict[str, int] = {}
        self.live: Dict[int, list] = {}
        self.cur = 0
        self.peak = 0
        self.known = {self._storage(t) for t in inputs}

    @staticmethod
    def _storage(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _track(self, t: torch.Tensor) -> None:
        cd = self._storage(t)
        if cd in self.known:
            return
        entry = self.live.get(cd)
        if entry is None:
            entry = self.live[cd] = [0, t.untyped_storage().nbytes()]
            self.cur += entry[1]
            self.peak = max(self.peak, self.cur)
        entry[0] += 1
        weakref.finalize(t, self._release, cd)

    def _release(self, cd: int) -> None:
        entry = self.live.get(cd)
        if entry is not None:
            entry[0] -= 1
            if entry[0] == 0:
                self.cur -= entry[1]
                del self.live[cd]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor turns it into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagating[0]:
            return out
        packet = func._overloadpacket
        outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor)]
        kind = _COLLECTIVES.get(packet.__name__)
        if kind is not None:
            moved = outs or [a for a in tree_leaves(args) if isinstance(a, torch.Tensor)]
            self.collectives[kind] = self.collectives.get(kind, 0) + \
                sum(_nbytes(t) for t in moved)
        elif not (func.is_view or packet.__name__ in _FREE):
            ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
            self.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        for t in outs:
            if t.is_meta:
                self._track(t)
        return out


def _register_flop_formulas() -> None:
    """Each kernel op's FLOPs: the matrix work of its plain version on the
    same shapes (``kernels/ref.py``), whatever the kernel skips."""
    ops = torch.ops.repro_torch

    def attention(q, k, *_, **__):            # Q K^T and P V over every (query, key)
        B, Sq, H, hd = q
        return 4 * B * H * Sq * k[1] * hd

    def attention_bwd(q, k, *_, **__):        # the scores again, dP, dV, dQ, dK
        B, Sq, H, hd = q
        return 10 * B * H * Sq * k[1] * hd

    def decode(q, cache_k, *_, **__):         # one query against every cached position
        B, _, H, hd = q
        return 4 * B * H * cache_k[1] * hd

    def router(x, router, *_, **__):          # the f32 product; top-k and softmax are elementwise
        return 2 * x[0] * x[1] * router[1]

    def elementwise(*_, **__):                # counted as the counter counts elementwise ops
        return 0

    for op, formula in ((ops.flash_attention, attention), (ops.flash_attention_infer, attention),
                        (ops.flash_attention_bwd, attention_bwd), (ops.flash_decode, decode),
                        (ops.flash_decode_lse, decode),
                        (ops.moe_router, router), (ops.moe_router_bwd, elementwise),
                        (ops.ssd_state_scan, elementwise),
                        (ops.ssd_state_scan_bwd, elementwise)):
        register_flop_formula(op)(formula)


_register_flop_formulas()


def _register_pointwise_shardings() -> None:
    """DTensor strategies for the elementwise ops it has none for and a
    cell runs (the mLSTM's ``logsigmoid`` backward): any placement that
    every operand shares."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _(grad_output, x, buffer):
        return [([Replicate()], [Replicate()] * 3)] + \
            [([Shard(d)], [Shard(d)] * 3) for d in range(x.ndim)]


_register_pointwise_shardings()


# ---------------------------------------------------------------------------
# inputs as DTensors on meta shards
# ---------------------------------------------------------------------------

def _placed(t: torch.Tensor, pspec, mesh) -> torch.Tensor:
    """A DTensor of ``t``'s global shape and dtype laid out by ``pspec``,
    whose local shard is a meta tensor: no collective places it."""
    local = torch.empty(local_shape(t.shape, pspec, mesh), dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements(pspec, mesh), run_check=False,
                              shape=t.shape, stride=contiguous_strides(t.shape))


def _place_model(model: torch.nn.Module, specs: Dict[str, Any], mesh) -> None:
    """Replace every parameter of ``model`` by its DTensor (in place)."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, torch.nn.Parameter(_placed(p, specs[name], mesh),
                                              requires_grad=p.requires_grad))


def _locals(tree):
    """Every tensor of ``tree`` (models included), each rank's shard of a
    DTensor."""
    tree = tree_map(lambda t: list(t.parameters()) if isinstance(t, torch.nn.Module) else t,
                    tree, is_leaf=lambda t: isinstance(t, torch.nn.Module))
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _locals(tree))


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

WORLD = 512   # ranks of the fake process group: both meshes are cut from it


def _world() -> None:
    """The fake process group, this process its rank 0 (started once)."""
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=0, world_size=WORLD, store=FakeStore())


def _mesh(multi: bool):
    _world()
    return make_production_mesh(multi_pod=multi)


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *, remat: str = "dots",
               microbatch: int = 1, compress_pods: bool = False):
    """Build the cell's inputs and trace its step once.  Returns (Counts
    with ``argument_bytes``/``output_bytes`` set, meta)."""
    from torch.distributed.tensor.experimental import implicit_replication
    long_ctx = shape.name == "long_500k"
    model_axis = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    rules = rules_for(cfg, model_axis=model_axis, seq_shard_cache=long_ctx)
    meta: Dict[str, Any] = {"rules": {k: str(v) for k, v in rules.items()},
                            "remat": remat, "microbatch": microbatch,
                            "compress_pods": compress_pods}
    specs = input_specs(cfg, shape)
    with ExitStack() as stack:
        stack.enter_context(use_mesh(mesh))
        stack.enter_context(use_rules(rules))
        stack.enter_context(implicit_replication())
        stack.enter_context(_quiet_propagation())
        if shape.kind == "train":
            optimizer = AdamW(lr=constant(1e-4))
            state = train_state_shape(cfg, optimizer)
            sp = param_pspecs(state)
            _place_model(state["params"], sp["params"], mesh)
            opt = state["opt"]
            for k in ("m", "v"):
                moments = getattr(opt, k)
                for n in moments:
                    moments[n] = _placed(moments[n], getattr(sp["opt"], k)[n], mesh)
            state["opt"] = opt._replace(step=_placed(opt.step, (), mesh))
            batch = {k: _placed(v, batch_pspec(k, v), mesh) for k, v in specs.items()}
            step = make_train_step(cfg, optimizer, remat=remat, microbatch=microbatch,
                                   compress_pods=compress_pods, mesh=mesh)
            args, run = (state, batch), lambda: step(state, batch)
        else:
            params = model_module(cfg).Model(cfg, device="meta", dtype=dtype_of(cfg))
            _place_model(params, param_pspecs(params), mesh)
            if shape.kind == "prefill":
                batch = {k: _placed(v, batch_pspec(k, v), mesh) for k, v in specs.items()}
                prefill = make_prefill(cfg)
                args = (params, batch)
                run = lambda: prefill(params, batch, max_seq=shape.seq_len)  # noqa: E731
            else:
                cache = specs["cache"]
                cspecs = cache_pspecs(cfg, cache, long_context=long_ctx)
                cache = {k: _placed(v, cspecs[k], mesh) for k, v in cache.items()}
                tokens = _placed(specs["tokens"], batch_pspec("tokens", specs["tokens"]),
                                 mesh)
                serve_step = make_serve_step(cfg)
                args = (params, cache, tokens)
                run = lambda: serve_step(params, cache, tokens)  # noqa: E731
        counts = Counts(_locals(args))
        t0 = time.process_time()
        with counts:
            out = run()
        meta["compile_s"] = round(time.process_time() - t0, 2)
        counts.argument_bytes = _local_bytes(args)
        counts.output_bytes = _local_bytes(out)
    return counts, meta


def run_cell(arch_id: str, shape_name: str, mesh_name: str, *, remat: str = "dots",
             microbatch: int = 1, out_dir: Optional[str] = None, tag: str = "",
             compress_pods: bool = False, quiet: bool = False) -> Dict[str, Any]:
    cfg = get_config(arch_id)
    shape = get_shape(shape_name)
    multi = mesh_name == "multi"
    try:
        mesh = _mesh(multi)
        chips = mesh.size()
        counts, meta = lower_cell(cfg, shape, mesh, remat=remat, microbatch=microbatch,
                                  compress_pods=compress_pods)
        report = analyze_counts(
            counts, arch=arch_id, shape=shape_name,
            mesh_name=f"{'2x16x16' if multi else '16x16'}", chips=chips,
            model_flops=model_flops(cfg, shape), notes=f"remat={remat} mb={microbatch} {tag}")
        result = {"status": "ok", **report.to_json(), **meta,
                  "params": param_count(cfg),
                  "active_params": param_count(cfg, active_only=True)}
    except Exception as e:
        result = {"status": "error", "arch": arch_id, "shape": shape_name,
                  "mesh": "multi" if multi else "single",
                  "error": f"{type(e).__name__}: {e}",
                  "trace": traceback.format_exc()[-2000:]}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1, default=str)
    if not quiet:
        if result["status"] == "ok":
            print(f"[OK]   {arch_id:24s} {shape_name:12s} {mesh_name:6s} "
                  f"compute={result['compute_s']:.4f}s "
                  f"memory={result['memory_s']:.4f}s "
                  f"coll={result['collective_s']:.4f}s "
                  f"dom={result['dominant']:10s} "
                  f"args/dev={result['argument_bytes']/1e9:.2f}GB "
                  f"temp/dev={result['temp_bytes']/1e9:.2f}GB "
                  f"trace={result.get('compile_s', 0)}s", flush=True)
        else:
            print(f"[FAIL] {arch_id:24s} {shape_name:12s} {mesh_name:6s} "
                  f"{result['error']}", flush=True)
    return result


def all_cells():
    for arch_id, cfg in registry().items():
        if arch_id == "lidc-demo":
            continue
        for shape_name in shape_cells(cfg):
            yield arch_id, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) cell")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod gradient compression (multi mesh)")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in all_cells():
            print(f"{a:26s} {s}")
        return

    # DTensor advises on every two-axis all-reduce and every plain tensor it
    # replicates; the counts already say what moves
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore", message=".*implicitly creating a replicated DTensor")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    if not all(a and s for a, s in cells):
        ap.error("need --arch and --shape (or --all)")

    runs = [dict(arch_id=a, shape_name=s, mesh_name=m, remat=args.remat,
                 microbatch=args.microbatch, out_dir=args.out,
                 compress_pods=args.compress and m == "multi", tag=args.tag)
            for a, s in cells for m in meshes]
    jobs = min(len(runs), os.cpu_count() or 1)
    t0 = time.perf_counter()
    if jobs <= 1:
        results = [run_cell(**kw) for kw in runs]
    else:   # a process a cell, each starting its own fake process group
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn"),
                                 max_tasks_per_child=1) as pool:
            results = list(pool.map(_run_quietly, runs))
    failures = sum(r["status"] != "ok" for r in results)
    print(f"{len(results) - failures} of {len(results)} cells ok in "
          f"{time.perf_counter() - t0:.1f} s wall ({jobs} at a time); "
          f"traces {sum(r.get('compile_s', 0) for r in results):.1f} CPU s in all")
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


def _run_quietly(kw: Dict[str, Any]) -> Dict[str, Any]:
    """``run_cell`` in a worker process, its line printed as it finishes."""
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore", message=".*implicitly creating a replicated DTensor")
    return run_cell(**kw)


if __name__ == "__main__":
    main()
