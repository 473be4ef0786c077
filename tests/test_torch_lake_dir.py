"""PyTorch port: the directory-backed lake (``repro_torch.lake.DirLake``)
against the reference's ``DataLake(store=DirStore(root))``.

* each reads the other's directory: the same names, bit-equal arrays and
  equal JSON, objects whole and in segments, and the same ``_index.json``;
* in f32, ``run_training`` resumes a directory across frameworks, both
  ways, with losses at 1e-4 (as ``test_torch_lidc100m.py``);
* ``repro_torch.examples.train_100m`` runs as ``examples/train_100m.py``
  does: the same config, flags, defaults, run name and lake.

Resuming in a new process, through the two CLIs and after a kill:
``tests/test_torch_lake_resume.py``.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from repro.configs.base import smoke_of as jax_smoke
from repro.core.names import Name
from repro.datalake import DataLake, DirStore
from repro.train.trainer import run_training as jax_run_training
from repro_torch.configs.base import smoke_of
from repro_torch.lake import DirLake, LakeName
from repro_torch.train.trainer import run_training

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _objects(rng):
    return {"small": {"a": rng.normal(size=(3, 4)).astype(np.float32),
                      "b": np.arange(7, dtype=np.int32)},
            "big": {"w": rng.normal(size=(1000, 700)).astype(np.float32),
                    "x/y": rng.normal(size=(50,)).astype(np.float32)}}


def _fill(lake, name_of, objects):
    for key, arrays in objects.items():
        lake.put_arrays(name_of(f"/lidc/data/{key}"), arrays)
    lake.put_json(name_of("/lidc/data/ckpt/r/latest"), {"step": 4, "run": "r", "loss": 0.25})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dir_lake_reads_the_reference_directory_and_back(tmp_path, writer):
    rng = np.random.default_rng(0)
    objects = _objects(rng)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _fill(DataLake(store=DirStore(str(jdir))), Name.parse, objects)
    _fill(DirLake(str(tdir)), LakeName.parse, objects)
    # the same keys in the same order, so the same index file
    assert (jdir / "_index.json").read_text() == (tdir / "_index.json").read_text()
    index = json.loads((tdir / "_index.json").read_text())
    assert any("/seg=" in k for k in index) and "/lidc/data/big/manifest" in index
    assert "/lidc/data/small#meta" in index
    assert sorted(p.name for p in tdir.glob("*.bin")) == sorted(index.values())

    root = jdir if writer == "jax" else tdir
    readers = {"jax": (DataLake(store=DirStore(str(root))), Name.parse),
               "port": (DirLake(str(root)), LakeName.parse)}
    for lake, name_of in readers.values():
        for key, arrays in objects.items():
            assert lake.has(name_of(f"/lidc/data/{key}"))
            got = lake.get_arrays(name_of(f"/lidc/data/{key}"))
            assert set(got) == set(arrays)
            for k, a in arrays.items():
                assert got[k].dtype == a.dtype
                np.testing.assert_array_equal(got[k], a)
        assert lake.get_json(name_of("/lidc/data/ckpt/r/latest")) == {
            "step": 4, "run": "r", "loss": 0.25}
        assert lake.get_arrays(name_of("/lidc/data/absent")) is None
        assert not lake.has(name_of("/lidc/data/absent"))
    assert sorted(readers["port"][0].names()) == sorted(readers["jax"][0].names())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_f32_run_resumes_from_disk_across_frameworks(tmp_path, first):
    """In f32 the resumed losses agree at 1e-4: ``first`` trains 4 steps into
    a directory, each framework resumes a copy of it to 8."""
    jcfg = dataclasses.replace(jax_smoke("lidc-demo"), dtype="float32")
    cfg = dataclasses.replace(smoke_of("lidc-demo"), dtype="float32")
    kw = dict(batch=4, seq=32, run_name="x", ckpt_every=2, seed=1)
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    if first == "jax":
        jax_run_training(jcfg, steps=4, lake=DataLake(store=DirStore(dirs["jax"])), **kw)
    else:
        run_training(cfg, steps=4, lake=DirLake(dirs["jax"]), device="cpu", **kw)
    shutil.copytree(dirs["jax"], dirs["port"])
    want = jax_run_training(jcfg, steps=8, lake=DataLake(store=DirStore(dirs["jax"])), **kw)
    got = run_training(cfg, steps=8, lake=DirLake(dirs["port"]), device="cpu", **kw)
    assert want.resumed_from == got.resumed_from == 4
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_100m_example_runs_as_the_reference_example(tmp_path, monkeypatch):
    """Both examples' ``main`` with the same arguments, their trainers
    replaced by a recorder: the same config, steps, batch, sequence, run
    name, checkpoint interval, lr, and a directory lake at the same path
    (the reference's ``DirStore`` and the port's ``DirLake`` on one layout)."""
    import repro_torch.examples.train_100m as port_example
    import repro_torch.train.trainer as port_trainer
    ref_example = _load("train_100m_reference", ROOT / "examples" / "train_100m.py")
    calls = {}

    def recorder(side):
        def run(cfg, **kw):
            calls[side] = (cfg, kw)
            return port_trainer.TrainResult(run=kw["run_name"], steps_done=0)
        return run

    monkeypatch.chdir(tmp_path)
    for argv in ([], ["--steps", "7", "--batch", "2", "--seq", "16", "--lake-dir", "d"]):
        monkeypatch.setattr(ref_example, "run_training", recorder("jax"))
        monkeypatch.setattr(port_trainer, "run_training", recorder("port"))
        with mock.patch.object(sys, "argv", ["x"] + argv):
            ref_example.main()
        with mock.patch.object(sys, "argv", ["x", "--device", "cpu"] + argv):
            assert port_example.main() == 0
        (jcfg, jkw), (cfg, kw) = calls["jax"], calls["port"]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jlake, lake = jkw.pop("lake"), kw.pop("lake")
        assert isinstance(lake, DirLake) and lake.root == jlake.store.root
        assert kw.pop("device").type == "cpu"
        kw.pop("on_step")
        jkw.pop("on_step")
        assert kw == jkw
