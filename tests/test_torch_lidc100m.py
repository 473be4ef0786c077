"""PyTorch port: lidc-100m, the config that ``examples/train_100m.py``
trains in f32 and ``chip_smoke.py`` phase 14 trains on the card.

The port keeps its own copy of the config in
``repro_torch.examples.train_100m`` (it imports nothing of ``examples/`` or
of the JAX package), and ``chip_smoke.py`` trains that copy; here it is held
to the example's ``CONFIG_100M``, loaded by path.  A narrowed copy (2 layers,
d_model 128, 2/1 heads of 64, d_ff 512, vocab 512, tied embeddings, f32)
then goes through both packages on the CPU with the same weights
(``interop.params_from_jax``) and batches: ``loss_fn`` and every gradient
at 2e-5 (atol = rtol), and three ``run_training`` steps resumed from the
reference's checkpoint at 1e-4, as ``tests/test_torch_data_ckpt.py`` holds
resumed runs (AdamW steps carry f32 noise through elements whose gradient
is near eps).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.ckpt.checkpoint import _flatten
from repro.datalake import DataLake
from repro.models import bundle_for as jax_bundle
from repro.models import param_count as jax_param_count
from repro.train.trainer import run_training as jax_run_training
from repro_torch.examples.train_100m import CONFIG_100M
from repro_torch.interop import named_to_jax, params_from_jax
from repro_torch.models import bundle_for, param_count
from repro_torch.train.trainer import run_training

ROOT = Path(__file__).resolve().parents[1]
NARROW = {"n_layers": 2, "d_model": 128, "n_heads": 2, "n_kv_heads": 1, "d_ff": 512,
          "vocab": 512}
TOL = 2e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EXAMPLE = _load("train_100m_example", ROOT / "examples" / "train_100m.py")
SMOKE = _load("chip_smoke_phase14", ROOT / "chip_smoke.py")   # stdlib only at import


def _narrowed():
    return (dataclasses.replace(EXAMPLE.CONFIG_100M, **NARROW),
            dataclasses.replace(CONFIG_100M, **NARROW))


def test_phase_14_config_is_the_example_config_field_by_field():
    want, got = EXAMPLE.CONFIG_100M, CONFIG_100M
    assert SMOKE.lidc_100m_config() is got
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert (got.dtype, got.hd, got.n_heads // got.n_kv_heads) == ("float32", 64, 2)
    assert param_count(got) == jax_param_count(want)


def test_narrowed_loss_fn_and_every_gradient_match_jax():
    jcfg, cfg = _narrowed()
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(_flatten(jparams), cfg, device=torch.device("cpu"))
    params.requires_grad_(True)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 97)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(lambda p: jax_bundle(jcfg).loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    loss = bundle_for(cfg).loss_fn(cfg, params, {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.parameters()))
    tg, jg = named_to_jax(zip((n for n, _ in params.named_parameters()), grads)), _flatten(jg)
    assert abs(loss.item() - float(jl)) <= TOL * (1 + abs(float(jl)))
    assert set(tg) == set(jg)
    for key in jg:
        np.testing.assert_allclose(np.asarray(tg[key], np.float32),
                                   np.asarray(jg[key], np.float32), atol=TOL, rtol=TOL,
                                   err_msg=key)


def test_narrowed_run_training_matches_the_reference():
    """The reference trains one step (checkpoint at 1); the port, from a
    copy of its lake, and the reference each train steps 2-4 at the
    example's peak lr.  Both restart the stream from its seed, so they see
    the same batches and start from the same weights."""
    jcfg, cfg = _narrowed()
    kw = dict(batch=2, seq=64, run_name="lidc", ckpt_every=1, seed=1, lr=1e-3)
    jlake = DataLake()
    assert jax_run_training(jcfg, steps=1, lake=jlake, **kw).steps_done == 1
    tlake = DataLake()
    for key in jlake.store.keys():
        tlake.store.put(key, bytes(jlake.store.get(key)))
    want = jax_run_training(jcfg, steps=4, lake=jlake, **kw)
    got = run_training(cfg, steps=4, lake=tlake, device="cpu", **kw)
    assert want.resumed_from == got.resumed_from == 1
    assert len(got.losses) == len(want.losses) == 3
    assert all(np.isfinite(got.losses))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
