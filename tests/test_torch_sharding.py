"""The port's sharded layouts against the reference's: for every registry
arch, on both production meshes and every dry-run shape, the parameter,
train-state, batch and cache pspecs leaf by leaf, the reference's with its
stacked leading ``None``s dropped where the port keeps one module per layer.

The reference side runs in a subprocess (``repro.launch.dryrun`` sets
``XLA_FLAGS`` when it is imported) under ``jax.sharding.use_abstract_mesh``,
which needs no devices; the port's side needs no process group either: its
pspecs read only the mesh's axis names and sizes.  ``shard`` is the
identity without a mesh and on plain tensors, and lays a DTensor out on a
small fake mesh (a subprocess: the fake process group is global).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs.base import get_config, get_shape, registry, shape_cells
from repro_torch.interop import _jax_key
from repro_torch.launch.dryrun import batch_pspec, cache_pspecs
from repro_torch.launch.mesh import rules_for
from repro_torch.models.model import input_specs, model_module
from repro_torch.models.sharding import param_pspecs, shard, use_mesh, use_rules
from repro_torch.models.transformer import dtype_of
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.step import train_state_shape

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

REFERENCE = textwrap.dedent('''
    import json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from repro.launch import dryrun as D
    from repro.configs.base import get_config, get_shape, registry, shape_cells
    from repro.launch.mesh import rules_for
    from repro.models.model import bundle_for, input_specs
    from repro.models.sharding import param_pspecs, set_rules
    from repro.optim.adamw import AdamW
    from repro.optim.schedule import constant
    from repro.train.step import train_state_shape

    def flat(tree):
        out = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[key] = [list(e) if isinstance(e, tuple) else e for e in spec]
        return out

    res = {}
    for mesh_name, (shape, names) in {"single": ((16, 16), ("data", "model")),
                                      "multi": ((2, 16, 16), ("pod", "data", "model"))}.items():
        with jax.sharding.use_abstract_mesh(AbstractMesh(shape, names)):
            for arch, cfg in registry().items():
                for cell in shape_cells(cfg):
                    sh = get_shape(cell)
                    set_rules(rules_for(cfg, model_axis=16,
                                        seq_shard_cache=cell == "long_500k"))
                    specs = input_specs(cfg, sh)
                    out = {"batch": {k: list(D.batch_pspec(k, v)) for k, v in specs.items()
                                     if k != "cache"}}
                    if sh.kind == "train":
                        out["state"] = flat(param_pspecs(train_state_shape(
                            cfg, AdamW(lr=constant(1e-4)))))
                    else:
                        b = bundle_for(cfg)
                        out["params"] = flat(param_pspecs(jax.eval_shape(
                            lambda k: b.init(cfg, k), jax.ShapeDtypeStruct((2,), jnp.uint32))))
                    if sh.kind == "decode":
                        out["cache"] = flat(D.cache_pspecs(cfg, specs["cache"],
                                                           long_context=cell == "long_500k"))
                    res[f"{arch}|{cell}|{mesh_name}"] = out
    json.dump(res, sys.stdout)
''')


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _stacked_match(name, port_spec, ref):
    key, idx = _jax_key(name)
    want = ref[key]
    assert want[:len(idx)] == [None] * len(idx), (name, want)
    assert _norm(port_spec) == want[len(idx):], (name, port_spec, want)


@pytest.mark.parametrize("arch", list(registry()))
def test_pspecs_equal_the_reference(reference, arch):
    cfg = get_config(arch)
    for cell in shape_cells(cfg):
        sh = get_shape(cell)
        for mesh_name, (shape, names) in MESHES.items():
            ref = reference[f"{arch}|{cell}|{mesh_name}"]
            mesh = SimpleNamespace(mesh_dim_names=names, shape=shape)
            rules = rules_for(cfg, model_axis=16, seq_shard_cache=cell == "long_500k")
            with use_mesh(mesh), use_rules(rules):
                specs = input_specs(cfg, sh)
                assert {k: _norm(batch_pspec(k, v)) for k, v in specs.items()
                        if k != "cache"} == ref["batch"]
                if sh.kind == "train":
                    state = param_pspecs(train_state_shape(cfg, AdamW(lr=constant(1e-4))))
                    assert state["opt"].step == () and ref["state"]["opt/.step"] == []
                    for prefix, tree in (("params", state["params"]),
                                         ("opt/.m", state["opt"].m),
                                         ("opt/.v", state["opt"].v)):
                        sub = {k[len(prefix) + 1:]: v for k, v in ref["state"].items()
                               if k.startswith(prefix + "/")}
                        assert {_jax_key(n)[0] for n in tree} == set(sub)
                        for name, spec in tree.items():
                            _stacked_match(name, spec, sub)
                else:
                    model = model_module(cfg).Model(cfg, device="meta", dtype=dtype_of(cfg))
                    port = param_pspecs(model)
                    assert {_jax_key(n)[0] for n in port} == set(ref["params"])
                    for name, spec in port.items():
                        _stacked_match(name, spec, ref["params"])
                if sh.kind == "decode":
                    cache = cache_pspecs(cfg, specs["cache"],
                                         long_context=cell == "long_500k")
                    assert {k: _norm(v) for k, v in cache.items()} == ref["cache"]


def test_shard_is_the_identity_without_a_mesh_or_on_plain_tensors():
    x = torch.randn(4, 6)
    assert shard(x, "batch", None) is x
    with use_rules(rules_for(get_config("qwen3-1.7b"))):
        assert shard(x, "batch", "tp") is x
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    with use_mesh(mesh), use_rules(rules_for(get_config("qwen3-1.7b"), model_axis=2)):
        assert shard(x, "batch", "tp") is x       # a rank's own tensor stays as it is


FAKE_MESH = textwrap.dedent('''
    import json, torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.sharding import placements, shard, use_mesh, use_rules
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    x = DTensor.from_local(torch.zeros(8, 6, 4), mesh, [Replicate()] * 3, run_check=False)
    out = {}
    with use_mesh(mesh), use_rules(rules_for(get_config("qwen3-1.7b"), model_axis=2)):
        for axes in (("batch", None, "tp"), ("batch", None, None), (None, "tp", None),
                     (None, None, None)):
            y = shard(x, *axes)
            out[",".join(map(str, axes))] = [repr(p) for p in y.placements] + \\
                [list(y.to_local().shape)]
        out["pspec"] = [repr(p) for p in placements((("pod", "data"), None, "model"))]
    print(json.dumps(out))
''')


def test_shard_lays_a_dtensor_out_on_a_small_fake_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", FAKE_MESH], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # batch over (pod, data): dim 0 split 2 x 2; tp over model
    assert got["batch,None,tp"] == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)", [2, 6, 2]]
    assert got["batch,None,None"] == ["Shard(dim=0)", "Shard(dim=0)", "Replicate()", [2, 6, 4]]
    assert got["None,tp,None"] == ["Replicate()", "Replicate()", "Shard(dim=1)", [8, 3, 4]]
    assert got["None,None,None"] == ["Replicate()"] * 3 + [[8, 6, 4]]
    assert got["pspec"] == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)"]
