"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

``--list`` against the reference's cells (from ``repro.configs``: importing
``repro.launch.dryrun`` would set ``XLA_FLAGS`` for every test on this
worker); cells of three families (the other three in
``test_torch_dryrun_families.py``), traced in one subprocess (the fake
process group is global), each ``"status": "ok"`` with the reference's
artifact keys; the counter's per-rank count of a sharded product and of an
input's placement; one cell's argument bytes against its leaves' local
shards computed from the pspecs.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.configs.base import registry as jax_registry
from repro.configs.base import shape_cells as jax_shape_cells
from repro_torch.configs.base import get_config, get_shape
from repro_torch.launch.dryrun import batch_pspec, cache_pspecs
from repro_torch.launch.mesh import rules_for
from repro_torch.models.model import input_specs, model_module
from repro_torch.models.sharding import local_shape, param_pspecs, use_mesh, use_rules
from repro_torch.models.transformer import dtype_of

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

# (arch, shape, mesh): with test_torch_dryrun_families.py's, one per family
# across both meshes; the last one's argument bytes are checked below
CELLS = [("qwen3-moe-30b-a3b", "decode_32k", "single"),     # moe
         ("xlstm-350m", "long_500k", "single"),             # ssm
         ("qwen2-0.5b", "decode_32k", "multi")]             # dense

# the reference's artifact keys (repro/launch/dryrun.py run_cell and
# roofline/analysis.py RooflineReport)
KEYS = {"status", "arch", "shape", "mesh", "chips", "device_flops", "device_bytes",
        "device_collective_bytes", "collectives_by_kind", "compute_s", "memory_s",
        "collective_s", "dominant", "model_flops", "hlo_total_flops", "useful_ratio",
        "argument_bytes", "temp_bytes", "output_bytes", "notes", "rules", "remat",
        "microbatch", "compress_pods", "compile_s", "params", "active_params"}

RUN = textwrap.dedent('''
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import dryrun as D
    cells = json.loads(sys.argv[1])
    out = {"cells": [D.run_cell(a, s, m, remat="full", quiet=True) for a, s, m in cells]}
    mesh = D._mesh(True)
    counts = D.Counts()
    with D._quiet_propagation(), counts:
        x = D._placed(torch.empty(256, 4096, dtype=torch.bfloat16, device="meta"),
                      (("pod", "data"), None), mesh)
        w = D._placed(torch.empty(4096, 8192, dtype=torch.bfloat16, device="meta"),
                      (None, "model"), mesh)
        placed = dict(counts.collectives)
        y = x @ w
    out["probe"] = {"flops": counts.flops, "placed_collectives": placed,
                    "collectives": counts.collectives, "local": list(y.to_local().shape)}
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def traced():
    out = subprocess.run([sys.executable, "-c", RUN, json.dumps(CELLS)], capture_output=True,
                         text=True, env=ENV, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_list_prints_the_reference_cells():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
                         capture_output=True, text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = [f"{a:26s} {s}" for a, cfg in jax_registry().items() if a != "lidc-demo"
            for s in jax_shape_cells(cfg)]
    assert out.stdout.splitlines() == want
    assert len(want) == 32


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_cells_trace_with_the_reference_keys(traced, i):
    r = traced["cells"][i]
    arch, shape, mesh = CELLS[i]
    assert r["status"] == "ok", r.get("error")
    assert set(r) == KEYS
    assert (r["arch"], r["shape"], r["mesh"]) == (arch, shape,
                                                  "2x16x16" if mesh == "multi" else "16x16")
    assert r["chips"] == (512 if mesh == "multi" else 256)
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["argument_bytes"] > 0 and r["device_flops"] > 0 and r["device_bytes"] > 0
    assert r["hlo_total_flops"] == r["device_flops"] * r["chips"]
    assert 0 < r["useful_ratio"] <= 1.05


def test_the_counter_counts_a_ranks_own_product_and_no_placement(traced):
    """x (256, 4096) split over pod x data, w (4096, 8192) over model, on the
    (2, 16, 16) mesh: rank 0 multiplies (8, 4096) by (4096, 512), 2 x 8 x
    4096 x 512 FLOPs, not the global product's (DTensor's shape propagation
    runs it on global fake tensors), and placing x and w moves nothing."""
    p = traced["probe"]
    assert p["flops"] == 2 * 8 * 4096 * 512 == 33_554_432
    assert p["local"] == [8, 512]
    assert p["placed_collectives"] == {} and p["collectives"] == {}


def test_argument_bytes_are_the_leaves_local_shards(traced):
    arch, shape_name, _ = CELLS[-1]
    r = traced["cells"][-1]
    cfg, shape = get_config(arch), get_shape(shape_name)
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))

    def local_bytes(t, spec):
        n = 1
        for d in local_shape(t.shape, spec, mesh):
            n *= d
        return n * t.element_size()

    with use_mesh(mesh), use_rules(rules_for(cfg, model_axis=16)):
        model = model_module(cfg).Model(cfg, device="meta", dtype=dtype_of(cfg))
        specs = input_specs(cfg, shape)
        want = sum(local_bytes(p, s) for (_, p), s in zip(model.named_parameters(),
                                                          param_pspecs(model).values()))
        cspecs = cache_pspecs(cfg, specs["cache"], long_context=False)
        want += sum(local_bytes(t, cspecs[k]) for k, t in specs["cache"].items())
        want += local_bytes(specs["tokens"], batch_pspec("tokens", specs["tokens"]))
    assert r["argument_bytes"] == want


def test_every_kernel_op_counts_its_plain_versions_flops():
    """Each registered kernel op on the paths has a formula: attention 4 B H
    Sq Sk hd forward and 10 B H Sq Sk hd backward, decode 4 B H Smax hd
    (with or without its log-sum-exps),
    the router's product 2 T D E; the scan and the router's backward are
    elementwise (0, as every elementwise op)."""
    import torch
    from torch.utils.flop_counter import flop_registry
    ops = torch.ops.repro_torch
    meta = dict(device="meta")
    q, k = torch.empty(2, 64, 8, 128, **meta), torch.empty(2, 96, 2, 128, **meta)
    lse = torch.empty(2, 8, 64, **meta)
    f = {name: flop_registry[getattr(ops, name)] for name in (
        "flash_attention", "flash_attention_infer", "flash_attention_bwd", "flash_decode",
        "flash_decode_lse", "moe_router", "moe_router_bwd", "ssd_state_scan", "ssd_state_scan_bwd")}
    assert f["flash_attention_infer"](q, k, k, True, out_val=q) == 4 * 2 * 8 * 64 * 96 * 128
    assert f["flash_attention"](q, k, k, True, out_val=(q, lse)) == 4 * 2 * 8 * 64 * 96 * 128
    assert f["flash_attention_bwd"](q, k, k, q, lse, q, True, out_val=(q, k, k)) == \
        10 * 2 * 8 * 64 * 96 * 128
    qd, cache, n = torch.empty(4, 1, 24, 64, **meta), torch.empty(4, 300, 2, 64, **meta), \
        torch.empty(4, dtype=torch.int32, **meta)
    assert f["flash_decode"](qd, cache, cache, n, out_val=qd) == 4 * 4 * 24 * 300 * 64
    assert f["flash_decode_lse"](qd, cache, cache, n, out_val=(qd, None)) == \
        4 * 4 * 24 * 300 * 64
    x, r = torch.empty(10, 64, **meta), torch.empty(64, 16, **meta)
    assert f["moe_router"](x, r, 4, out_val=None) == 2 * 10 * 64 * 16
    assert f["ssd_state_scan"](torch.empty(1, 2, 3, 4, 5, **meta), torch.empty(1, 2, 3, **meta),
                               None, out_val=None) == 0
