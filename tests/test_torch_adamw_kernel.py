"""PyTorch port: the fused AdamW kernel's host side on the CPU.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``
holds it against the plain loop there); here: its work list at
qwen3-1.7b's full leaf set on the meta device, the dispatch (CPU tensors
and DTensors take the plain loop and launch nothing, meta tensors take the
registered op and launch nothing), and the dtypes it refuses.
"""

import pytest
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import get_config, smoke_of
from repro_torch.kernels import adamw as fused
from repro_torch.models.model import model_module
from repro_torch.models.transformer import dtype_of
from repro_torch.optim import AdamW, constant, warmup_cosine
from repro_torch.train.step import make_train_state

QWEN3_1P7B_LEAVES = 310
QWEN3_1P7B_ELEMENTS = 1_720_574_976


def _meta_model(arch):
    cfg = get_config(arch)
    return model_module(cfg).Model(cfg, device="meta", dtype=dtype_of(cfg))


def _opt(**kw):
    return AdamW(lr=warmup_cosine(3e-3, 2, 10), **kw)


@pytest.fixture
def launches():
    fused.adamw_update.launches = fused.adamw_update.elements = 0
    yield fused.adamw_update
    fused.adamw_update.launches = fused.adamw_update.elements = 0


def test_work_list_covers_qwen3_1p7b_leaf_by_leaf():
    """310 leaves, 1,720,574,976 elements, one dtype group (bf16 p and g);
    each leaf's chunks cover its elements once, in order, and none passes
    the leaf's end; every leaf decays but the final norm."""
    model = _meta_model("qwen3-1.7b")
    named = list(model.named_parameters())
    params = [p for _, p in named]
    decay = _opt().decays(named)
    wl = fused.work_list(params, [torch.empty_like(p) for p in params], decay)
    assert len(wl.order) == len(params) == QWEN3_1P7B_LEAVES
    assert wl.elements == QWEN3_1P7B_ELEMENTS
    assert sorted(wl.order) == list(range(len(params)))
    assert [(g.pdtype, g.gdtype, g.first, g.count) for g in wl.groups] == [
        (torch.bfloat16, torch.bfloat16, 0, len(wl.chunks))]
    covered = [0] * len(params)
    for row, c in wl.chunks:
        i = wl.order[row]
        start = c * fused.CHUNK
        assert start == covered[i], (named[i][0], c)       # in order, none left out
        assert start < wl.numel[i]                        # inside the leaf
        covered[i] = min(start + fused.CHUNK, wl.numel[i])
    assert covered == wl.numel
    assert len(wl.chunks) == sum(-(-n // fused.CHUNK) for n in wl.numel)
    assert [n for (n, _), d in zip(named, decay) if not d] == ["final_norm.w"]


def test_work_list_groups_leaves_by_dtype_pair():
    """Leaves group by (p, g) dtype pair in order of first appearance, each
    group's chunks contiguous; an empty leaf has no chunk."""
    bf, f32 = torch.bfloat16, torch.float32
    params = [torch.empty(70_000, dtype=bf, device="meta"),
              torch.empty(5, dtype=f32, device="meta"),
              torch.empty(0, dtype=bf, device="meta"),
              torch.empty(3, dtype=bf, device="meta")]
    grads = [torch.empty(70_000, dtype=f32, device="meta"),
             torch.empty(5, dtype=f32, device="meta"),
             torch.empty(0, dtype=f32, device="meta"),
             torch.empty(3, dtype=bf, device="meta")]
    wl = fused.work_list(params, grads, [True, False, True, True])
    assert wl.order == [0, 2, 1, 3]
    assert [(g.pdtype, g.gdtype, g.first, g.count) for g in wl.groups] == [
        (bf, f32, 0, 3), (f32, f32, 3, 1), (bf, bf, 4, 1)]
    assert wl.chunks == [(0, 0), (0, 1), (0, 2), (2, 0), (3, 0)]
    assert wl.elements == 70_008 and wl.decay == [True, False, True, True]


@pytest.mark.parametrize("pdtype,gdtype", [(torch.float16, torch.float16),
                                           (torch.bfloat16, torch.float16),
                                           (torch.float64, torch.float32)])
def test_work_list_refuses_other_dtypes(pdtype, gdtype):
    p = torch.empty(4, dtype=pdtype, device="meta")
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        fused.work_list([p], [torch.empty(4, dtype=gdtype, device="meta")], [True])


def test_work_list_refuses_a_gradient_of_another_size():
    p = torch.empty(4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="elements"):
        fused.work_list([p], [torch.empty(5, dtype=torch.bfloat16, device="meta")], [True])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_tensors_take_the_plain_loop(launches, dtype):
    """AdamW.update on CPU tensors is the plain loop, bit for bit, and
    launches nothing."""
    import dataclasses
    cfg = dataclasses.replace(smoke_of("qwen3-1.7b"), dtype=dtype)
    opt = _opt(grad_clip=0.5)
    a = make_train_state(cfg, 0, opt, device=torch.device("cpu"))
    b = make_train_state(cfg, 0, opt, device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        grads = [torch.randn(p.shape, generator=gen).to(p.dtype)
                 for p in a["params"].parameters()]
        assert not fused.takes(list(a["params"].parameters()))
        sa, ma = opt.update(grads, a["opt"], a["params"])
        sb, mb = opt.plain_update(grads, b["opt"], b["params"])
        a["opt"], b["opt"] = sa, sb
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])
        assert torch.equal(ma["lr"], mb["lr"])
    for (n, p), q in zip(a["params"].named_parameters(), b["params"].parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a["opt"].m[n], b["opt"].m[n]) and torch.equal(a["opt"].v[n],
                                                                          b["opt"].v[n]), n
    assert int(a["opt"].step) == 2
    assert launches.launches == 0 and launches.elements == 0


@pytest.fixture
def one_rank_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    dist.destroy_process_group()


def test_dtensors_take_the_plain_loop(launches, one_rank_mesh):
    """A leaf list that holds DTensors keeps the plain loop (its norm needs
    the mesh's reduction), on the CPU and on the meta device alike."""
    from torch.distributed.tensor import DTensor, Replicate
    gen = torch.Generator().manual_seed(5)
    plain = {"w": torch.randn(6, 4, generator=gen), "b": torch.randn(4, generator=gen)}

    def module(tensors):
        m = nn.Module()
        for n, t in tensors.items():
            m.register_parameter(n, nn.Parameter(t.clone()))
        return m

    dt = {n: DTensor.from_local(t.clone(), one_rank_mesh, [Replicate()], run_check=False)
          for n, t in plain.items()}
    meta = [DTensor.from_local(torch.empty(3, device="meta"), one_rank_mesh, [Replicate()],
                               run_check=False)]
    assert not fused.takes(meta) and not fused.takes(list(dt.values()))
    opt = _opt()
    pm, dm = module(plain), module(dt)
    ps, ds = opt.init(pm), opt.init(dm)
    grads = [torch.randn(t.shape, generator=gen) for t in plain.values()]
    dgrads = [DTensor.from_local(g.clone(), one_rank_mesh, [Replicate()], run_check=False)
              for g in grads]
    _, pmet = opt.plain_update(grads, ps, pm)
    _, dmet = opt.update(dgrads, ds, dm)
    for n in plain:
        assert torch.equal(getattr(dm, n).to_local(), getattr(pm, n)), n
        assert torch.equal(ds.m[n].to_local(), ps.m[n]), n
    assert torch.equal(dmet["grad_norm"].to_local(), pmet["grad_norm"])
    assert launches.launches == 0


def test_meta_tensors_take_the_op_and_launch_nothing(launches):
    """qwen3-1.7b's train state on the meta device goes through the
    registered op, whose fake gives the norm's shape; no launch is counted
    and the state keeps its shapes."""
    model = _meta_model("qwen3-1.7b").requires_grad_(True)
    opt = _opt()
    state = opt.init(model)
    leaves = list(model.parameters())
    assert fused.takes(leaves)
    new, metrics = opt.update([torch.empty_like(p) for p in leaves], state, model)
    assert metrics["grad_norm"].is_meta and metrics["grad_norm"].shape == ()
    assert metrics["grad_norm"].dtype == torch.float32
    assert new.step.is_meta and new.m is state.m
    assert launches.launches == 0 and launches.elements == 0


def test_meta_tensors_of_another_dtype_are_refused(launches):
    model = nn.Module()
    model.register_parameter("w", nn.Parameter(torch.empty(4, 4, dtype=torch.float16,
                                                           device="meta")))
    opt = AdamW(lr=constant(1e-3))
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        opt.update([torch.empty(4, 4, dtype=torch.float16, device="meta")], opt.init(model),
                   model)
    assert launches.launches == 0


def test_decays_follow_the_reference_dims():
    """A block's 1-D norm weight decays (a row of the reference's stacked
    array), the final norm's does not, and nothing decays without a decay."""
    named = list(_meta_model("qwen3-1.7b").named_parameters())
    flags = dict(zip([n for n, _ in named], _opt().decays(named)))
    assert flags["blocks.3.norm1.w"] and flags["embed.table"] and not flags["final_norm.w"]
    assert not any(_opt(weight_decay=0.0).decays(named))
