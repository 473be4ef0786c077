"""PyTorch port: the sharded branch of ``moe_block`` on a 2 x 2 ("data",
"model") mesh of gloo ranks against the reference's ``shard_map`` branch
on a 2 x 2 host mesh.

qwen3-moe smoke in f32 (8 experts, top-2), x of 4 x 64 tokens (128 a
data shard, so capacity 1.25 drops): expert parallel
(``rules_for(model_axis=2, force_tp=True)``: 4 experts a rank) and expert
TP (``rules_for(model_axis=16, force_tp=True)``: every expert on half of
``d_ff``), each at capacity factor 8 and 1.25 (drops).  The
loss is sum(y * gy) + 3 aux; ``y`` and the gradients of x, the router and
each rank's expert shard at 2e-5 of each tensor's largest value, aux at
1e-6; and without a mesh the single-shard branch, as before.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from torch_ranks import run_jax, spawn

TOL = 2e-5
AUX_TOL = 1e-6
CASES = list(itertools.product(("ep", "tp"), (8.0, 1.25)))
MODEL_AXIS = {"ep": 2, "tp": 16}

JAX_EP = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs.base import smoke_of
from repro.launch.mesh import rules_for
from repro.models import moe as MoE
from repro.models.sharding import set_rules

mesh = make_mesh((2, 2), ("data", "model"))
base = dataclasses.replace(smoke_of("qwen3-moe-30b-a3b"), dtype="float32")
p = MoE.init_moe(base, jax.random.PRNGKey(0), jnp.float32)
rng = np.random.default_rng(4)
x = rng.normal(size=(4, 64, base.d_model)).astype(np.float32)
gy = rng.normal(size=(4, 64, base.d_model)).astype(np.float32)
out = {"x": x, "gy": gy, **{"p:" + k: np.asarray(v) for k, v in p.items()}}
for mode, model_axis in (("ep", 2), ("tp", 16)):
    for cf in (8.0, 1.25):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        set_rules(rules_for(cfg, model_axis=model_axis, force_tp=True))

        def loss(p, x):
            y, aux = MoE.moe_block(cfg, p, x)
            return jnp.sum(y * gy) + 3.0 * aux, (y, aux)

        with mesh:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
        tag = f"{mode}{cf}:"
        out.update({tag + "y": np.asarray(y), tag + "aux": np.asarray(aux),
                    tag + "gx": np.asarray(gx),
                    **{tag + "g" + k: np.asarray(v) for k, v in gp.items()}})
np.savez(OUT, **out)
"""


def _base():
    from repro_torch.configs.base import smoke_of
    return dataclasses.replace(smoke_of("qwen3-moe-30b-a3b"), dtype="float32")


def _moe_rank(rank, n, ref):
    from torch import nn
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh, use_rules

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    d = mesh.get_local_rank("data")
    full = nn.Module()
    for k in ("router", "w_gate", "w_up", "w_down"):
        setattr(full, k, nn.Parameter(torch.from_numpy(ref["p:" + k])))
    x = torch.from_numpy(ref["x"][2 * d:2 * d + 2]).requires_grad_(True)
    gy = torch.from_numpy(ref["gy"][2 * d:2 * d + 2])
    out = {"data": d, "model": mesh.get_local_rank("model")}
    for mode, cf in CASES:
        cfg = dataclasses.replace(_base(), capacity_factor=cf)
        with use_rules(rules_for(cfg, model_axis=MODEL_AXIS[mode], force_tp=True)), \
                use_mesh(mesh):
            p = moe.local_experts(cfg, full)
            y, aux = moe.moe_block(cfg, p, x)
        leaves = [x] + [getattr(p, k) for k in ("router", "w_gate", "w_up", "w_down")]
        grads = torch.autograd.grad(torch.sum(y * gy) + 3.0 * aux, leaves)
        tag = f"{mode}{cf}:"
        out[tag + "y"], out[tag + "aux"] = y.detach().numpy(), aux.item()
        for k, g in zip(("gx", "grouter", "gw_gate", "gw_up", "gw_down"), grads):
            out[tag + k] = g.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    ref = run_jax(JAX_EP, 4, tmp / "jax.npz")
    return ref, spawn(_moe_rank, 4, tmp, ref)


def _close(got, want, what):
    err = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    assert err <= TOL, f"{what}: {err:.3e} of the largest value"


@pytest.mark.parametrize("mode,cf", CASES)
def test_sharded_moe_block_matches_jax(runs, mode, cf):
    ref, ranks = runs
    tag = f"{mode}{cf}:"
    cfg = _base()
    E, F = cfg.n_experts, cfg.d_ff
    for got in ranks:
        d, m = got["data"], got["model"]
        rows = slice(2 * d, 2 * d + 2)
        _close(got[tag + "y"], ref[tag + "y"][rows], f"{tag} rank {d, m} y")
        assert abs(got[tag + "aux"] - float(ref[tag + "aux"])) <= AUX_TOL
        _close(got[tag + "gx"], ref[tag + "gx"][rows], f"{tag} rank {d, m} dx")
        _close(got[tag + "grouter"], ref[tag + "grouter"], f"{tag} rank {d, m} drouter")
        if mode == "ep":
            mine = (slice(m * E // 2, (m + 1) * E // 2),)
            cut = {k: mine for k in ("w_gate", "w_up", "w_down")}
        else:
            half = slice(m * F // 2, (m + 1) * F // 2)
            cut = {"w_gate": (slice(None), slice(None), half),
                   "w_up": (slice(None), slice(None), half), "w_down": (slice(None), half)}
        for k, idx in cut.items():
            assert got[tag + "g" + k].shape == ref[tag + "g" + k][idx].shape
            _close(got[tag + "g" + k], ref[tag + "g" + k][idx], f"{tag} rank {d, m} d{k}")


def test_capacity_1_25_drops_assignments(runs):
    """The drop case does drop: its output differs from capacity 8's."""
    ref, _ = runs
    for mode in ("ep", "tp"):
        assert np.max(np.abs(ref[f"{mode}1.25:y"] - ref[f"{mode}8.0:y"])) > 1e-3


def test_without_a_mesh_moe_block_is_the_single_shard_branch(runs):
    """Rules alone (no mesh in force) leave moe_block on one shard: the
    whole batch against the reference's sharded result."""
    from torch import nn

    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_rules
    ref, _ = runs
    p = nn.Module()
    for k in ("router", "w_gate", "w_up", "w_down"):
        setattr(p, k, nn.Parameter(torch.from_numpy(ref["p:" + k])))
    cfg = dataclasses.replace(_base(), capacity_factor=8.0)
    with use_rules(rules_for(cfg, model_axis=2, force_tp=True)):
        y, aux = moe.moe_block(cfg, p, torch.from_numpy(ref["x"]))
    _close(y.detach().numpy(), ref["ep8.0:y"], "y")
    assert abs(aux.item() - float(ref["ep8.0:aux"])) <= AUX_TOL
