"""PyTorch port: the sharding rules, the int8 cross-pod all-reduce and the
compressed train step, against the reference.

* ``rules_for``, ``logical_to_pspec`` and ``gqa_axes`` equal the
  reference's for every registry arch, on meshes of the production shapes
  (the port's a ``DeviceMesh`` over a fake process group, the reference's
  an ``AbstractMesh``);
* ``compressed_psum_pod`` on 4 gloo ranks against the reference's on a
  (4, 2) ("pod", "data") host mesh: within one quantum of the second
  rounding per element, and within 0.05 of the plain sum's largest value
  (the reference's own bound); int8 on the wire;
* ``compress_grads_with_feedback`` bit-equal to the reference's;
* the compressed train step on 2 ranks against the reference's
  ``compress_pods`` step executed on 2 host devices (qwen2 smoke, f32, two
  AdamW steps with eps 1, which makes each update about lr times the
  gradient, so an int8 rounding that falls the other way on one side moves
  an update by lr times one quantum, never by lr), and on both frameworks
  the pods' gradients summed, not averaged, while the loss is averaged
  (ROADMAP "Gaps in the reference itself").
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs.base import registry as jax_registry
from repro.launch.mesh import rules_for as jax_rules_for
from repro.models import sharding as JS
from repro.optim.compress import compress_grads_with_feedback as jax_feedback
from repro_torch.configs.base import registry
from repro_torch.launch.mesh import rules_for
from repro_torch.models import sharding
from repro_torch.optim.compress import compress_grads_with_feedback
from torch_ranks import run_jax, spawn

ARCHS = sorted(registry())
MESHES = [((2, 16, 16), ("pod", "data", "model")), ((16, 16), ("data", "model")),
          ((2, 4), ("data", "model"))]
LOGICAL = [("vocab", "fsdp"), ("fsdp", "vocab"), ("fsdp", "tp"), ("tp", "fsdp"), ("tp",),
           (None,), ("fsdp", None), (None, "tp"), (None, "tp", None),
           ("expert", "fsdp", "tp_ff"), ("expert", "tp_ff", "fsdp"),
           ("batch", None, None), ("batch", "seq", None, None), ("batch", None, "tp")]


def test_rules_for_equals_the_reference_for_every_arch():
    assert ARCHS == sorted(jax_registry())
    combos = itertools.product((16, 4, 2), (None, True, False), (None, True, False),
                               (False, True))
    for arch, (model_axis, fsdp, force_tp, seq) in itertools.product(ARCHS, combos):
        kw = dict(model_axis=model_axis, fsdp=fsdp, force_tp=force_tp, seq_shard_cache=seq)
        want = jax_rules_for(jax_registry()[arch], **kw)
        assert rules_for(registry()[arch], **kw) == want, (arch, kw)


def _shapes(cfg):
    """Dims the rules meet for ``cfg``: weights' and activations'."""
    dims = [cfg.vocab, cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd, cfg.d_ff,
            max(cfg.n_experts, 1), 1, 8, 32, 128, 256, 512, 1024]
    return [None] + [tuple(d) for d in itertools.product(dims, repeat=2)]


@pytest.fixture
def fake_world():
    """A process group of fake ranks, for meshes of the production sizes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(size):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_shape,names", MESHES)
def test_logical_to_pspec_and_gqa_axes_equal_the_reference(fake_world, mesh_shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(int(np.prod(mesh_shape)))
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    jmesh = AbstractMesh(mesh_shape, names)
    model = mesh_shape[-1]
    for arch in ARCHS:
        cfg, jcfg = registry()[arch], jax_registry()[arch]
        for force_tp in (None, True):
            rules = rules_for(cfg, model_axis=model, force_tp=force_tp)
            with sharding.use_rules(rules), sharding.use_mesh(mesh), \
                    jax.sharding.use_abstract_mesh(jmesh):
                JS.set_rules(jax_rules_for(jcfg, model_axis=model, force_tp=force_tp))
                assert sharding._mesh_axes() == JS._mesh_axes()
                assert sharding.gqa_axes(cfg.n_kv_heads, cfg.hd) == JS.gqa_axes(
                    cfg.n_kv_heads, cfg.hd), arch
                assert sharding.axis_size(*names) == JS.axis_size(*names)
                for logical in LOGICAL:
                    for dims in _shapes(cfg):
                        shape = None if dims is None else (dims * 2)[:len(logical)]
                        want = tuple(JS.logical_to_pspec(logical, shape))
                        want += (None,) * (len(logical) - len(want))
                        assert sharding.logical_to_pspec(logical, shape) == want, \
                            (arch, logical, shape)
    JS.set_rules({})


def test_without_a_mesh_the_rules_resolve_to_nothing():
    with sharding.use_rules(sharding.FSDP_RULES):
        assert sharding.current_mesh() is None
        assert sharding.logical_to_pspec(("batch", "fsdp", "tp"), (8, 8, 8)) == (None,) * 3
        assert sharding.gqa_axes(8, 128) == (None, None)
        assert sharding.axis_size("data", "model") == 1


# ---------------------------------------------------------------------------
# the int8 all-reduce
# ---------------------------------------------------------------------------

JAX_COMPRESS = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.optim.compress import compressed_psum_pod

mesh = make_mesh((4, 2), ("pod", "data"))
x = np.random.default_rng(0).normal(size=(4 * 37, 5)).astype(np.float32)
x[:37] *= 30.0          # one pod's scale far above the others'
sm = lambda f: jax.jit(shard_map(f, mesh=mesh, in_specs=P("pod", None),
                                 out_specs=P("pod", None)))
plain = sm(lambda v: jax.lax.psum(v, "pod"))(x)
comp = sm(lambda v: compressed_psum_pod(v, "pod"))(x)
np.savez(OUT, x=x, plain=np.asarray(plain), comp=np.asarray(comp))
"""


def _compress_rank(rank, n, x):
    from unittest import mock

    from repro_torch.optim.compress import compressed_psum_pod
    wire = []

    def recording(fn):
        def call(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            tensors += [t for a in args if isinstance(a, list) for t in a]
            wire.append((fn.__name__, [(str(t.dtype), t.numel()) for t in tensors]))
            return fn(*args, **kw)
        return call

    local = torch.from_numpy(x[rank * 37:(rank + 1) * 37])
    with mock.patch.object(dist, "all_to_all_single", recording(dist.all_to_all_single)), \
            mock.patch.object(dist, "all_gather", recording(dist.all_gather)):
        out = compressed_psum_pod(local, dist.group.WORLD)
    singles = [dist.new_group([r]) for r in range(n)]
    alone = compressed_psum_pod(local, singles[rank])
    return {"out": out.numpy(), "wire": wire, "alone_is_x": alone is local}


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compress")
    ref = run_jax(JAX_COMPRESS, 8, tmp / "jax.npz")
    return ref, spawn(_compress_rank, 4, tmp, ref["x"])


def test_compressed_psum_pod_matches_jax_on_four_ranks(compressed):
    ref, ranks = compressed
    x, plain = ref["x"].reshape(4, 37, 5), ref["plain"][:37]
    # one quantum of the second rounding: the largest partial sum / 127
    scales = np.abs(x).reshape(4, -1).max(axis=1) / 127.0
    quantum = (np.abs(plain).max() + scales.sum() / 2) / 127.0
    for r, got in enumerate(ranks):
        want = ref["comp"][r * 37:(r + 1) * 37]
        assert np.max(np.abs(got["out"] - want)) <= quantum * (1 + 1e-5), r
        err = np.max(np.abs(got["out"] - plain)) / np.max(np.abs(plain))
        assert err < 0.05, err
        assert got["alone_is_x"]


def test_compressed_psum_pod_puts_int8_on_the_wire(compressed):
    _, ranks = compressed
    for got in ranks:
        calls = got["wire"]
        assert [name for name, _ in calls] == ["all_gather", "all_to_all_single",
                                               "all_gather", "all_gather"]
        for name, tensors in calls:
            big = [dtype for dtype, numel in tensors if numel > 1]
            assert set(big) <= {"torch.int8"}, (name, tensors)
        # 185 elements padded to 188, a quarter a pod: int8 out and back
        assert calls[1][1] == [("torch.int8", 188), ("torch.int8", 188)]


def test_compress_grads_with_feedback_is_bit_equal_to_jax():
    """Three steps of error feedback on f32 and bf16 gradients."""
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=(17, 9)).astype(np.float32),
             (rng.normal(size=(64,)) * 1e-3).astype(np.float32),
             rng.normal(size=(5, 4)).astype(jnp.bfloat16)]
    dtypes = [torch.float32, torch.float32, torch.bfloat16]
    err = jerr = None
    for _ in range(3):
        deq, err = compress_grads_with_feedback(
            [torch.from_numpy(np.asarray(g, np.float32)).to(d) for g, d in zip(grads, dtypes)],
            err)
        jdeq, jerr = jax_feedback([jnp.asarray(g) for g in grads], jerr)
        for i, d in enumerate(dtypes):
            assert deq[i].dtype == d
            np.testing.assert_array_equal(deq[i].float().numpy(),
                                          np.asarray(jdeq[i], np.float32), err_msg=str(i))
            np.testing.assert_array_equal(err[i].numpy(), np.asarray(jerr[i]), err_msg=str(i))


def test_make_local_mesh_is_one_by_one(fake_world):
    from repro_torch.launch.mesh import make_local_mesh
    fake_world(1)
    mesh = make_local_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with sharding.use_mesh(mesh), sharding.use_rules(sharding.DEFAULT_RULES), \
            jax.sharding.use_abstract_mesh(AbstractMesh((1, 1), ("data", "model"))):
        JS.set_rules(JS.DEFAULT_RULES)
        assert sharding._mesh_axes() == JS._mesh_axes() == {"data": 1, "model": 1}
        for shape in ((8, 8), None):     # axes of size 1 shard nothing, given a shape
            want = tuple(JS.logical_to_pspec(("batch", "tp"), shape))
            assert sharding.logical_to_pspec(("batch", "tp"), shape) == want
    JS.set_rules({})


# ---------------------------------------------------------------------------
# the compressed train step
# ---------------------------------------------------------------------------

LR = 1e-3
EPS = 1.0      # AdamW's eps: an update about LR x the gradient, where |g| << 1

JAX_STEP = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.ckpt.checkpoint import _flatten
from repro.compat import make_mesh
from repro.configs.base import smoke_of
from repro.optim import AdamW, constant
from repro.train.step import make_train_state, make_train_step

cfg = dataclasses.replace(smoke_of("qwen2-0.5b"), dtype="float32")
opt = AdamW(lr=constant(1e-3), eps=1.0)
mesh = make_mesh((2,), ("pod",))
rng = np.random.default_rng(11)
batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)} for _ in range(2)]
state = make_train_state(cfg, jax.random.PRNGKey(0), opt)
out = {"param0:" + k: np.asarray(v) for k, v in _flatten(state["params"]).items()}
_, plain = jax.jit(make_train_step(cfg, opt))(state, batches[0])
out["plain_loss"], out["plain_gn"] = np.asarray(plain["loss"]), np.asarray(plain["grad_norm"])
step = jax.jit(make_train_step(cfg, opt, compress_pods=True, mesh=mesh))
with mesh:
    for i, b in enumerate(batches):
        state, m = step(state, b)
        out[f"loss{i}"], out[f"gn{i}"] = np.asarray(m["loss"]), np.asarray(m["grad_norm"])
        out.update({f"param{i + 1}:" + k: np.asarray(v)
                    for k, v in _flatten(state["params"]).items()})
for i, b in enumerate(batches):
    out[f"tokens{i}"], out[f"labels{i}"] = b["tokens"], b["labels"]
np.savez(OUT, **out)
"""


def _step_rank(rank, n, ref):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.interop import params_from_jax, params_to_jax
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(
        __import__("repro_torch.configs.base", fromlist=["x"]).smoke_of("qwen2-0.5b"),
        dtype="float32")
    mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("pod",))
    opt = AdamW(lr=constant(LR), eps=EPS)

    def fresh():
        params = params_from_jax({k[7:]: v for k, v in ref.items() if k.startswith("param0:")},
                                 cfg, device=torch.device("cpu")).requires_grad_(True)
        return {"params": params, "opt": opt.init(params)}

    def batch(i, rows):
        return {k: torch.from_numpy(ref[f"{k}{i}"][rows]) for k in ("tokens", "labels")}

    out = {}
    _, plain = make_train_step(cfg, opt)(fresh(), batch(0, slice(None)))
    out["plain_loss"], out["plain_gn"] = plain["loss"].item(), plain["grad_norm"].item()
    step = make_train_step(cfg, opt, compress_pods=True, mesh=mesh)
    state = fresh()
    rows = slice(rank * 2, rank * 2 + 2)      # this pod's shard of the batch
    for i in range(2):
        state, m = step(state, batch(i, rows))
        out[f"loss{i}"], out[f"gn{i}"] = m["loss"].item(), m["grad_norm"].item()
        out[f"params{i + 1}"] = params_to_jax(state["params"])
    return out


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("step")
    ref = run_jax(JAX_STEP, 2, tmp / "jax.npz")
    return ref, spawn(_step_rank, 2, tmp, ref)


def test_compressed_train_step_matches_jax_on_two_ranks(stepped):
    ref, ranks = stepped
    p0 = {k[7:]: v for k, v in ref.items() if k.startswith("param0:")}
    for got in ranks:
        for i in range(2):
            np.testing.assert_allclose(got[f"loss{i}"], ref[f"loss{i}"], rtol=1e-5)
            np.testing.assert_allclose(got[f"gn{i}"], ref[f"gn{i}"], rtol=1e-5)
            want = {k[len(f"param{i + 1}:"):]: v for k, v in ref.items()
                    if k.startswith(f"param{i + 1}:")}
            assert set(got[f"params{i + 1}"]) == set(want)
            for key, w in want.items():
                # each element's update since the start, within three int8
                # quanta (3/127) of the tensor's largest: the two sides
                # round a few elements to neighbouring integers
                d_got, d_want = got[f"params{i + 1}"][key] - p0[key], w - p0[key]
                err = np.max(np.abs(d_got - d_want)) / np.max(np.abs(d_want))
                assert err <= 3 / 127, f"step {i}: {key}: {err:.3e}"
    np.testing.assert_array_equal(ranks[0]["params2"]["embed/table"],
                                  ranks[1]["params2"]["embed/table"])


def test_compressed_step_sums_the_pods_gradients_on_both_frameworks(stepped):
    """The reference psums the pods' gradients through the int8 all-reduce
    but pmeans the loss (``repro/train/step.py:80-86``), so its update sees
    n_pods x the mean gradient; the port does the same.  Here, on the same
    first batch, the compressed step's gradient norm is twice the plain
    step's (each pod's gradient is the mean over its half), within the int8
    roundings, and its loss is the plain step's."""
    ref, ranks = stepped
    for side in [ref] + ranks:
        ratio = float(side["gn0"]) / float(side["plain_gn"])
        assert abs(ratio - 2.0) < 0.02, ratio
        np.testing.assert_allclose(float(side["loss0"]), float(side["plain_loss"]), rtol=1e-5)
