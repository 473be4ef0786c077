"""The xLSTM's internal casts follow the parameters' dtype: with f32 and
bf16 parameters every norm, gate, cell and loss is computed in f32, each
op's dtypes read off the dispatcher; with f64 parameters
(``params.double()``) the whole path is f64, which makes a reference that
no host's f32 rounding moves (``chip_smoke.py`` phase 12 holds the card's
f32 run against it)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import smoke_of
from repro_torch.models import bundle_for
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X


def _model(dtype):
    cfg = dataclasses.replace(smoke_of("xlstm-350m"), dtype=dtype)
    params = bundle_for(cfg).init(cfg, 1, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (2, 48)), dtype=torch.int32)
    labels = torch.tensor(rng.integers(0, cfg.vocab, (2, 48)), dtype=torch.int32)
    return cfg, params, {"tokens": toks, "labels": labels}


def _outputs(cfg, params, batch):
    params.requires_grad_(True)
    logits = X.apply(cfg, params, batch["tokens"])
    loss = X.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return [logits, loss.detach(), *grads]


# the ops that only gates, cells, norms and the loss run: each must see
# nothing narrower than f32
ACC_OPS = {"rsqrt", "log_sigmoid_forward", "log_sigmoid_backward", "logsumexp", "sigmoid",
           "sigmoid_backward", "tanh", "tanh_backward", "baddbmm", "maximum", "amax", "cumsum"}


class _OpDtypes(TorchDispatchMode):
    """Each aten op run, with the dtypes of its floating-point tensors."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        leaves = tree_leaves((args, kwargs or {}))
        self.ops.append((func.overloadpacket.__name__,
                         {a.dtype for a in leaves
                          if isinstance(a, torch.Tensor) and a.is_floating_point()}))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_gates_cells_norms_and_loss_are_computed_in_f32_or_f64(monkeypatch, dtype):
    """``X.apply``, ``X.loss_fn`` and every gradient with bf16, f32 and f64
    parameters: the mLSTM's gate preactivations (and their product, within
    f32's rounding of the exact one), the sLSTM cell's inputs,
    states and outputs, and every op of a gate, cell, norm or loss are f32
    (f64 with f64 parameters); the only exps in the model's bf16 are those
    of ``L.silu``."""
    cfg, params, batch = _model("float32" if dtype == "float64" else dtype)
    if dtype == "float64":
        params = params.double()
    acc = torch.float64 if dtype == "float64" else torch.float32
    gates, cells, narrow_silu = [], [], []
    qkvif, cell, silu = X._mlstm_qkvif, X._slstm_cell, L.silu

    def qkvif_spy(cfg_, p, x):
        out = qkvif(cfg_, p, x)
        got, xm = torch.cat(out[3:5], -1), out[-1]
        with torch.no_grad():   # the exact product of the operands as rounded
            want = xm.double() @ p.w_if.to(xm.dtype).double() + p.b_gates.double()
            gap = float((got.double() - want).abs().max() / want.abs().max())
        gates.append((got.dtype, gap))
        return out

    def cell_spy(rT, xt, state, one):
        h, st = cell(rT, xt, state, one)
        cells.extend(t.dtype for t in (xt, *state.values(), h, *st.values()))
        return h, st

    def silu_spy(x):
        narrow_silu.append(x.dtype != acc)
        return silu(x)

    monkeypatch.setattr(X, "_mlstm_qkvif", qkvif_spy)
    monkeypatch.setattr(X, "_slstm_cell", cell_spy)
    monkeypatch.setattr(L, "silu", silu_spy)
    with _OpDtypes() as rec:
        _outputs(cfg, params, batch)
    assert gates and {dt for dt, _ in gates} == {acc}
    assert max(gap for _, gap in gates) <= (1e-12 if dtype == "float64" else 1e-5)
    assert cells and set(cells) == {acc}
    ran = {name for name, _ in rec.ops}
    assert ACC_OPS <= ran
    assert [name for name, dts in rec.ops if name in ACC_OPS and dts != {acc}] == []
    narrow_exps = sum(name == "exp" and dts != {acc} for name, dts in rec.ops)
    assert narrow_exps == sum(narrow_silu) == (12 if dtype == "bfloat16" else 0)


def test_f64_parameters_run_the_whole_path_in_f64():
    cfg, params, batch = _model("float32")
    f32 = _outputs(cfg, params, batch)
    f64 = _outputs(cfg, params.double(), batch)
    assert all(t.dtype == torch.float64 for t in f64)
    # f64 throughout: the results are not f32 values widened
    assert not torch.equal(f64[0], f32[0].double())
    for a, b in zip(f32, f64):
        scale = b.abs().max()
        assert float((a.double() - b).abs().max() / scale) <= 1e-4
    # the f64 reference is its own: a second run is bit-equal
    again = _outputs(cfg, params, batch)
    assert all(torch.equal(a, b) for a, b in zip(f64, again))


def test_f64_decode_cells_follow_the_parameters():
    cfg, params, batch = _model("float32")
    params = params.double()
    toks = batch["tokens"][:1, :16]
    full, _ = X.prefill(cfg, params, toks)
    assert full.dtype == torch.float64
    blk = params.mlstm[0][0].mlstm
    x = torch.randn((1, 8, cfg.d_model), dtype=torch.float64, generator=torch.Generator()
                    .manual_seed(0)) * 0.3
    par, chunk = X.mlstm_parallel(cfg, blk, x), X.mlstm_chunkwise(cfg, blk, x)
    assert par.dtype == chunk.dtype == torch.float64
    assert float((par - chunk).abs().max()) <= 1e-10
