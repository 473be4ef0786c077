"""The port's fleet on the CPU: LIDC overlays built from the port's own
control plane (``repro_torch.core``, ``runtime.fleet.build_fleet``) whose
clusters train with the port's executors.

- the quickstart (``repro_torch.examples.quickstart``) completes with a
  falling loss, and its repeat is answered without a new job;
- the failover (``repro_torch.examples.multicluster_failover``) resumes
  from step 10 on the surviving cluster, bit-equal to an unbroken run;
- ``python -m repro_torch.launch.train --via-lidc`` exits 0, Completed
  (``tests/test_torch_data_ckpt.py::test_train_cli_direct_mode_and_via_lidc``);
- across frameworks through two overlays: a job killed after its step-2
  checkpoint in the reference's overlay on a directory lake is resumed
  from step 2 by the port's overlay over the same directory, and steps
  3-4 are held to the reference's unbroken run at the bf16 tolerance.
"""

import math
import types

import numpy as np
import pytest

import repro.train.trainer as jax_trainer
from repro.core.jobs import Job as RefJob
from repro.core.jobs import JobSpec as RefJobSpec
from repro.core.overlay import LidcSystem as RefLidcSystem
from repro.datalake import DataLake as RefDataLake
from repro.datalake import DirStore as RefDirStore
from repro.runtime import executors as jex
from repro.runtime.fleet import standard_endpoints as ref_endpoints
from repro_torch.ckpt import latest_step
from repro_torch.configs.base import smoke_of
from repro_torch.core import LidcSystem
from repro_torch.core.jobs import JobSpec
from repro_torch.datalake import DataLake, DirStore
from repro_torch.examples import multicluster_failover, quickstart
from repro_torch.runtime import executors as tex
from repro_torch.runtime.fleet import build_fleet, resilient_run, standard_endpoints

ARCH = "lidc-demo-smoke"


def test_quickstart_completes_and_its_repeat_is_a_cache_hit():
    out = quickstart.run("cpu", arch=ARCH, verbose=False)
    handle, again = out["handle"], out["again"]
    assert handle.state == "Completed", handle.error
    result = handle.result
    assert result["real_compute"] is True and result["steps"] == 15
    assert result["arch"] == ARCH and result["cluster"] in out["system"].overlay.clusters
    # a falling loss: well under the uniform guess over the vocabulary
    assert result["final_loss"] < math.log(smoke_of("lidc-demo").vocab) - 0.3
    run = out["system"].lake
    assert latest_step(run, result["run_name"]) == 15
    # the result is published under its name and fetched by it
    assert handle.receipt["result_name"] == f"/lidc/data/results/{result['run_name'][6:]}"
    assert again.state == "Completed" and out["new_jobs"] == 0
    assert again.result == result
    assert out["repeat"]["edge"]["interests"] > 0 and out["first"]["virtual_s"] > 0


def test_failover_resumes_from_step_10_bit_equal_to_an_unbroken_run():
    out = multicluster_failover.run("cpu", arch=ARCH, verbose=False)
    handle, whole = out["handle"], out["unbroken"]
    assert out["killed"]["step"] == 10 and out["attempts"] >= 2
    assert handle.result["cluster"] != out["killed"]["cluster"]
    assert handle.result["resumed_from"] == 10 and out["latest_step"] == 20
    assert handle.result["final_loss"] == whole.result["final_loss"]
    assert whole.result["resumed_from"] in (None, 5, 10, 15)


def test_build_fleet_is_the_references_layout_on_h100s():
    system = build_fleet(2, chips=4, archs=["lidc-demo"], device="cpu")
    assert sorted(system.overlay.clusters) == ["pod0", "pod1"]
    for cluster in system.overlay.clusters.values():
        assert cluster.chips == 4 and cluster.hbm_gb_per_chip == tex.HBM_GB_PER_CHIP
        assert cluster.matchmaker.memory_model is tex.memory_model
        apps = {e.app: e.archs for e in cluster.endpoints}
        assert apps["train"] == ("lidc-demo", "lidc-demo-smoke", "lidc-demo")
        assert set(apps) == {"train", "serve", "blast"}
    assert system.lake.__class__ is DataLake


# ---------------------------------------------------------------------------
# across frameworks through two overlays
# ---------------------------------------------------------------------------

def _record_training(monkeypatch):
    log = []

    def recording(fn, kind):
        def run(*args, **kwargs):
            res = fn(*args, **kwargs)
            log.append((kind, res.steps_done, list(res.losses)))
            return res
        return run

    monkeypatch.setattr(jax_trainer, "run_training",
                        recording(jax_trainer.run_training, "jax"))
    monkeypatch.setattr(tex, "run_training", recording(tex.run_training, "torch"))
    return log


def test_a_job_killed_in_the_references_overlay_resumes_in_the_ports(monkeypatch, tmp_path):
    log = _record_training(monkeypatch)
    fields = {"app": "train", "arch": ARCH, "shape": "custom", "chips": 1, "steps": 4}
    run_name = "train-" + JobSpec("train", {k: v for k, v in fields.items()
                                            if k != "app"}).signature()
    lake_dir = str(tmp_path / "lake")

    ref = RefLidcSystem()
    ref.lake = RefDataLake(store=RefDirStore(lake_dir))
    ref.add_cluster("jax-pod", chips=8, endpoints=ref_endpoints([ARCH], ckpt_every=2),
                    memory_model=jex.memory_model)
    put_json, killed = ref.lake.put_json, []

    def hook(name, obj, **kw):
        out = put_json(name, obj, **kw)
        if run_name in str(name) and str(name).endswith("latest") and not killed:
            killed.append(obj["step"])
            ref.overlay.fail_cluster("jax-pod")
        return out

    ref.lake.put_json = hook
    dead = ref.client.run_job(fields)
    assert killed == [2] and (dead is None or dead.state != "Completed")

    port = LidcSystem()
    port.lake = DataLake(store=DirStore(lake_dir))
    for i in range(2):
        port.add_cluster(f"h100-{i}", chips=8, latency=0.002 * (i + 1),
                         hbm_gb_per_chip=tex.HBM_GB_PER_CHIP, memory_model=tex.memory_model,
                         endpoints=standard_endpoints([ARCH], ckpt_every=2, device="cpu"))
    handle, attempts = resilient_run(port, fields)
    assert handle.state == "Completed" and attempts == 1
    assert handle.result["resumed_from"] == 2 and handle.result["run_name"] == run_name
    assert latest_step(port.lake, run_name) == 4
    assert [(k, s) for k, s, _ in log] == [("jax", 2), ("torch", 2), ("torch", 4)]
    resumed = log[2][2]

    # the reference's unbroken run on its own lake
    del log[:]
    spec = RefJobSpec("train", {k: v for k, v in fields.items() if k != "app"})
    plan = jex.make_train_executor(ckpt_every=2)(
        RefJob(spec=spec, cluster="c", granted_chips=1),
        types.SimpleNamespace(lake=RefDataLake()))
    for _, work in plan.phases:
        work()
    assert [(k, s) for k, s, _ in log] == [("jax", 2), ("jax", 4)]
    np.testing.assert_allclose(resumed, log[1][2], atol=3e-2, rtol=3e-2)
    assert handle.result["final_loss"] == pytest.approx(plan.finalize().payload["final_loss"],
                                                        abs=3e-2, rel=3e-2)
