"""PyTorch port, the executors and endpoints of a LIDC cluster, on the CPU
against the JAX package's (``repro/runtime/{executors,fleet}.py``):

- the cost model, the memory model, the arch resolution, the job signature
  and the blast executor, function by function;
- the serve and train executors beside the reference's;
- a mixed fleet: one reference ``LidcSystem`` with a pod whose endpoints are
  the reference's and a pod whose endpoints are the port's.  A train job
  killed after its step-2 checkpoint on one pod resumes on the other, in
  both directions; an arch the port's pod leaves out of its endpoints is
  never placed there.

The reference's cost model states TPU v5e constants; the port's states the
H100's.  Where durations are compared, the reference module's constants are
set to the H100's inside the test.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.train.trainer as jax_trainer
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_config
from repro.core.cluster import ExecPlan as JaxExecPlan
from repro.core.cluster import ExecResult as JaxExecResult
from repro.core.jobs import Job as JaxJob
from repro.core.jobs import JobSpec as JaxJobSpec
from repro.core.overlay import LidcSystem
from repro.datalake import DataLake
from repro.runtime import executors as jex
from repro.runtime.fleet import resilient_run
from repro.runtime.fleet import standard_endpoints as jax_endpoints
from repro_torch.ckpt import latest_step
from repro_torch.configs.base import SHAPES, get_config, registry
from repro_torch.models.model import PORTED_FAMILIES
from repro_torch.runtime import executors as tex
from repro_torch.runtime.fleet import standard_endpoints
from repro_torch.runtime.protocol import Job, JobSpec, canonical_job_name

H100 = {"PEAK_FLOPS": 989e12, "HBM_BW": 3.35e12}
SMOKE_NAMES = [a + "-smoke" for a in registry()]
NO_LAKE = types.SimpleNamespace(lake=None)


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's executors with the H100's cost constants."""
    for name, value in H100.items():
        monkeypatch.setattr(jex, name, value)


def _jobs(app, fields):
    """The same job as the reference's ``Job`` and the port's."""
    return (JaxJob(spec=JaxJobSpec(app=app, fields=dict(fields)), cluster="c", granted_chips=1),
            Job(JobSpec(app, dict(fields))))


# ---------------------------------------------------------------------------
# function by function
# ---------------------------------------------------------------------------

def test_cost_constants_are_the_h100s():
    assert (tex.PEAK_FLOPS, tex.HBM_BW) == (H100["PEAK_FLOPS"], H100["HBM_BW"])
    assert tex.HBM_GB_PER_CHIP == 80.0 and tex.ASSUMED_MFU == jex.ASSUMED_MFU == 0.4
    assert tex.REAL_PARAM_LIMIT == jex._REAL_TRAIN_PARAM_LIMIT


def test_roofline_step_time_matches_the_reference(h100_reference):
    """Every arch of a ported family at every shape, on 1 and 8 chips."""
    archs = [a for a, cfg in registry().items() if cfg.family in PORTED_FAMILIES]
    assert {"chameleon-34b", "grok-1-314b", "zamba2-2.7b", "qwen3-1.7b"} <= set(archs)
    for arch in archs:
        for name in SHAPES:
            for chips in (1, 8):
                assert tex.roofline_step_time(get_config(arch), SHAPES[name], chips) == \
                    jex.roofline_step_time(jax_config(arch), JAX_SHAPES[name], chips), \
                    (arch, name, chips)


def test_memory_model_matches_the_reference():
    """Equal wherever the port runs the family (every family), for every
    shaped job of any app and for shapeless train jobs; ``None`` where the
    reference gives none.  A shapeless serve job is sized at the serve
    executor's shape instead (the test below)."""
    archs = list(registry()) + SMOKE_NAMES + ["not-a-model"]
    for arch in archs:
        ported = arch in registry() and get_config(arch).family in PORTED_FAMILIES
        for app in ("train", "serve", "blast"):
            for shape in [None, *SHAPES, "custom"]:
                if shape is None and app == "serve":
                    continue
                fields = {"arch": arch} if shape is None else {"arch": arch, "shape": shape}
                want = jex.memory_model(JaxJobSpec(app, fields), 4)
                got = tex.memory_model(JobSpec(app, fields), 4)
                assert got == (want if ported else None), (app, arch, shape)
    assert tex.memory_model(JobSpec("blast", {"srr": "SRR2931415"}), 1) is None


def test_shapeless_serve_job_is_sized_at_the_serve_executors_shape():
    """The serve executor's own shape (``SERVE_SHAPE``: 4 slots of 64
    positions), where the reference sizes every shapeless job as its 256 x
    4096 train cell (137.5 GB a chip for qwen3-1.7b on one)."""
    from repro_torch.models.model import memory_estimate
    assert (tex.SERVE_SHAPE.kind, tex.SERVE_SHAPE.seq_len, tex.SERVE_SHAPE.global_batch) \
        == ("decode", 64, 4)
    for arch in ("qwen3-1.7b", "zamba2-2.7b", "qwen3-moe-30b-a3b", "lidc-demo"):
        for chips in (1, 4):
            got = tex.memory_model(JobSpec("serve", {"arch": arch, "chips": 1}), chips)
            assert got == memory_estimate(get_config(arch), tex.SERVE_SHAPE, chips)
    assert tex.memory_model(JobSpec("serve", {"arch": "xlstm-350m"}), 1) == \
        memory_estimate(get_config("xlstm-350m"), tex.SERVE_SHAPE, 1)
    assert tex.memory_model(JobSpec("serve", {"arch": "not-a-model"}), 1) is None
    spec = {"arch": "qwen3-1.7b", "chips": 1}
    assert jex.memory_model(JaxJobSpec("serve", spec), 1) > tex.HBM_GB_PER_CHIP * 1e9
    assert tex.memory_model(JobSpec("serve", spec), 1) < tex.HBM_GB_PER_CHIP * 1e9


def test_one_card_cluster_admits_a_shapeless_serve_job():
    """A reference overlay with one port cluster of one H100: a serve job
    with no shape is admitted and completes there (simulated: qwen3-1.7b is
    above the real-compute limit); a shapeless train job of the same arch is
    still sized as the reference sizes it, and placed nowhere."""
    system = LidcSystem()
    system.add_cluster("h100", chips=1, hbm_gb_per_chip=tex.HBM_GB_PER_CHIP,
                       memory_model=tex.memory_model,
                       endpoints=standard_endpoints(["qwen3-1.7b"], device="cpu",
                                                    plan_type=JaxExecPlan,
                                                    result_type=JaxExecResult))
    handle = system.client.run_job({"app": "serve", "arch": "qwen3-1.7b", "chips": 1})
    assert handle is not None and handle.state == "Completed"
    assert handle.result["cluster"] == "h100" and handle.result["arch"] == "qwen3-1.7b"
    assert handle.result["tokens_out"] == 32 and handle.result["real_compute"] is False
    assert system.client.submit({"app": "train", "arch": "qwen3-1.7b", "chips": 1,
                                 "steps": 1}) is None


def test_resolve_arch_matches_the_reference():
    """Every registry arch and its ``-smoke`` name resolve to the same
    config in both; ``qwen3-1.7b-smoke`` (and ``qwen3-smoke``) resolve to
    the MoE smoke config in both, the reference's first-token match."""
    for name in list(registry()) + SMOKE_NAMES + ["chameleon-smoke", "lidc-demo-smoke"]:
        assert dataclasses.asdict(tex._resolve_arch(name)) == \
            dataclasses.asdict(jex._resolve_arch(name)), name
    for name in ("qwen3-1.7b-smoke", "qwen3-smoke"):
        assert tex._resolve_arch(name).arch_id == jex._resolve_arch(name).arch_id \
            == "qwen3-moe-smoke"
    with pytest.raises(KeyError):
        tex._resolve_arch("nothing-smoke")


@pytest.mark.parametrize("app,fields", [
    ("train", {"arch": "qwen3-1.7b", "shape": "train_4k", "chips": 256, "steps": 100}),
    ("train", {"arch": "lidc-demo-smoke", "shape": "custom", "chips": 4, "steps": 8,
               "tag": "failover-test"}),
    ("train", {"shape": "custom", "steps": 1}),
    ("train", {"arch": "lidc-demo", "spill": "pod0:pod1", "avoid": "pod2", "flag": True}),
    ("serve", {"arch": "chameleon-smoke", "requests": 3, "new_tokens": 2.0, "prio": 1}),
    ("blast", {"srr": "SRR2931415", "db": "human", "mem": 4, "cpu": 2.5}),
    ("compress", {"dataset": "/lidc/data/a/b", "level": 6}),
])
def test_job_signature_and_name_match_the_reference(app, fields):
    want, got = JaxJobSpec(app=app, fields=fields), JobSpec(app, fields)
    assert str(canonical_job_name({"app": app, **fields})) == str(want.name())
    assert got.signature() == want.signature()
    assert (got.arch, got.shape, got.steps(7)) == (want.arch, want.shape, want.steps(7))


def test_job_signature_rejects_what_the_reference_rejects():
    for spec in (JaxJobSpec("train", {"bad key": 1}), JobSpec("train", {"bad key": 1})):
        with pytest.raises(ValueError, match="illegal job field key"):
            spec.signature()


def test_blast_executor_matches_the_reference():
    """Payload and duration equal within one process (the alignment's seed
    is the salted string hash, in both)."""
    for fields in ({"srr": "SRR2931415", "db": "human", "mem": 4, "cpu": 2},
                   {"srr": "SRR5139395", "db": "human", "mem": 8, "cpu": 6},
                   {"srr": "SRR0000001", "db": "mouse"}):
        jjob, job = _jobs("blast", fields)
        want, got = jex.blast_executor(jjob, NO_LAKE), tex.blast_executor(job, NO_LAKE)
        assert got.payload == want.payload and got.duration == want.duration


# ---------------------------------------------------------------------------
# the executors beside the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,real", [("lidc-demo-smoke", True), ("chameleon-smoke", True),
                                       ("qwen3-moe-smoke", False)])
def test_serve_executor_matches_the_reference(h100_reference, arch, real):
    """Real decoding for the dense and vlm smokes (weights differ: each
    framework draws its own from seed 0; the payload counts tokens), the
    MoE smoke simulated, as in the reference."""
    jjob, job = _jobs("serve", {"arch": arch, "requests": 5, "new_tokens": 6})
    want = jex.make_serve_executor()(jjob, NO_LAKE)
    got = tex.make_serve_executor(device="cpu")(job, NO_LAKE)
    assert got.payload == want.payload and got.payload["real_compute"] is real
    assert got.payload["tokens_out"] == 30
    assert got.duration == want.duration > 0


@pytest.mark.parametrize("arch,steps", [("lidc-demo-smoke", 5), ("chameleon-smoke", 4),
                                        ("qwen3-1.7b", 25)])
def test_train_plans_match_the_reference(h100_reference, arch, steps):
    """The same phases (count and virtual durations) and, before any phase
    has run, the same payload."""
    jjob, job = _jobs("train", {"arch": arch, "shape": "custom", "steps": steps})
    want = jex.make_train_executor(ckpt_every=2)(jjob, NO_LAKE)
    got = tex.make_train_executor(ckpt_every=2, device="cpu")(job, NO_LAKE)
    assert len(got.phases) == len(want.phases) == -(-steps // 2)
    assert [d for d, _ in got.phases] == [d for d, _ in want.phases]
    assert got.finalize().payload == want.finalize().payload


def test_executors_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        standard_endpoints(["lidc-demo"])
    assert len(standard_endpoints(["lidc-demo"], device="cpu")) == 3


def test_endpoints_list_only_what_the_port_runs():
    """train and serve: the archs whose resolved family the port runs (all
    six families, so every arch that resolves); an app left with no arch
    gets no endpoint (an endpoint with no archs would take any)."""
    names = list(registry()) + SMOKE_NAMES + ["not-a-model"]
    train, serve, blast = standard_endpoints(names, device="cpu")
    assert (train.app, serve.app, blast.app) == ("train", "serve", "blast")
    fam = {n: jex._resolve_arch(n).family for n in names if n != "not-a-model"}
    assert set(fam.values()) == set(PORTED_FAMILIES)
    assert train.archs == serve.archs == tuple(fam)
    assert {"qwen3-1.7b-smoke", "qwen3-moe-30b-a3b", "qwen3-1.7b", "zamba2-2.7b",
            "zamba2-2.7b-smoke", "xlstm-350m", "seamless-m4t-large-v2-smoke"} \
        <= set(train.archs)
    assert serve.families == ("dense", "vlm")
    assert [e.app for e in standard_endpoints(["not-a-model"], device="cpu")] == ["blast"]


# ---------------------------------------------------------------------------
# a mixed fleet in the reference's overlay
# ---------------------------------------------------------------------------

FLEET_ARCHS = ["lidc-demo", "lidc-demo-smoke", "chameleon-smoke", "xlstm-350m-smoke",
               "qwen3-1.7b-smoke", "zamba2-smoke", "qwen2-0.5b-smoke"]
# an arch the port's pod leaves out of its endpoints (the overlay places its
# jobs on the reference's pod only)
PORT_LEAVES_OUT = "qwen2-0.5b-smoke"
POD = {"jax": "jax-pod", "torch": "h100-pod"}


def mixed_fleet(kinds):
    """A reference overlay with one pod per entry of ``kinds``, the first
    the nearest (it takes a job first while it lives)."""
    system = LidcSystem()
    for i, kind in enumerate(kinds):
        if kind == "jax":
            system.add_cluster(POD[kind], chips=8, latency=0.002 * (i + 1),
                               endpoints=jax_endpoints(FLEET_ARCHS, ckpt_every=2),
                               memory_model=jex.memory_model)
        else:
            system.add_cluster(POD[kind], chips=8, latency=0.002 * (i + 1),
                               hbm_gb_per_chip=tex.HBM_GB_PER_CHIP,
                               memory_model=tex.memory_model,
                               endpoints=standard_endpoints(
                                   [a for a in FLEET_ARCHS if a != PORT_LEAVES_OUT],
                                   ckpt_every=2, device="cpu",
                                   plan_type=JaxExecPlan, result_type=JaxExecResult))
    return system


def _record_training(monkeypatch):
    """Every ``run_training`` call of either framework's executor, as
    (framework, steps trained, losses)."""
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


def _solo_plan(kind, fields):
    """The train job run whole by one framework's executor on its own lake."""
    spec = {k: v for k, v in fields.items() if k != "app"}
    jjob, job = _jobs("train", spec)
    cluster = types.SimpleNamespace(lake=DataLake())
    plan = (jex.make_train_executor(ckpt_every=2)(jjob, cluster) if kind == "jax" else
            tex.make_train_executor(ckpt_every=2, device="cpu")(job, cluster))
    for _, work in plan.phases:
        work()
    return plan.finalize().payload


def resume_on_the_other_framework(monkeypatch, first, then, arch):
    """A train job of ``arch``, 4 steps, a checkpoint every 2: the nearer
    pod (``first``'s framework) dies just after its step-2 checkpoint; the
    client re-expresses the same name (``resilient_run``) and the other
    framework's pod resumes from that checkpoint.  Steps 3-4 are held to a
    run of the first framework alone at the bf16 tolerance (both restore
    the step-2 state and restart the data stream from its seed).  Returns
    the job's result."""
    log = _record_training(monkeypatch)
    system = mixed_fleet((first, then))
    fields = {"app": "train", "arch": arch, "shape": "custom", "chips": 1, "steps": 4}
    run_name = "train-" + JobSpec("train", {k: v for k, v in fields.items()
                                            if k != "app"}).signature()
    killed = []
    put_json = system.lake.put_json

    def hook(name, obj, **kw):
        out = put_json(name, obj, **kw)
        if (run_name in str(name) and str(name).endswith("latest") and not killed
                and obj.get("step", 0) >= 2):
            killed.append(obj["step"])
            system.overlay.fail_cluster(POD[first])
        return out

    system.lake.put_json = hook
    handle, attempts = resilient_run(system, fields)
    assert killed == [2] and attempts >= 2
    assert handle.state == "Completed" and handle.result["cluster"] == POD[then]
    assert handle.result["resumed_from"] == 2 and handle.result["real_compute"] is True
    assert latest_step(system.lake, run_name) == 4
    assert [(k, s) for k, s, _ in log] == [(first, 2), (then, 2), (then, 4)]
    resumed = log[2][2]

    del log[:]
    solo = _solo_plan(first, fields)
    assert [(k, s) for k, s, _ in log] == [(first, 2), (first, 4)]
    np.testing.assert_allclose(resumed, log[1][2], atol=3e-2, rtol=3e-2)
    assert handle.result["final_loss"] == resumed[-1]
    assert solo["final_loss"] == pytest.approx(resumed[-1], abs=3e-2, rel=3e-2)
    return handle.result


@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax")])
def test_train_job_resumes_on_the_other_framework(monkeypatch, first, then):
    """lidc-demo-smoke (``resume_on_the_other_framework``)."""
    resume_on_the_other_framework(monkeypatch, first, then, "lidc-demo-smoke")


@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax")])
def test_xlstm_train_job_resumes_on_the_other_framework(monkeypatch, first, then):
    """xlstm-350m-smoke (the ssm family, bf16).  seamless-smoke has no such
    case: both frameworks' train executors refuse the f32 frames its data
    stream makes (``tests/test_torch_encdec.py``)."""
    result = resume_on_the_other_framework(monkeypatch, first, then, "xlstm-350m-smoke")
    assert result["arch"] == "xlstm-smoke"


def test_archs_the_port_cannot_run_are_placed_elsewhere(monkeypatch):
    """A train job of an arch the port's pod leaves out of its endpoints
    (``PORT_LEAVES_OUT``; the port runs every family since the xLSTM and
    encoder-decoder slice) lands on the reference's pod, though the port's
    is the nearer; with only the port's pod it is placed nowhere, while a
    serve job completes there.  A qwen3-1.7b-smoke train job (resolved to
    the MoE smoke, which the port trains) lands on the port's nearer pod.
    Placement is what is tested: the reference's pod simulates its jobs
    (its real-compute limit set to 0 here).  The name is kept from when the
    left-out arch was one the port could not run."""
    monkeypatch.setattr(jex, "_REAL_TRAIN_PARAM_LIMIT", 0)
    system = mixed_fleet(("torch", "jax"))
    for arch, pod in ((PORT_LEAVES_OUT, "jax"), ("qwen3-1.7b-smoke", "torch")):
        handle = system.client.run_job({"app": "train", "arch": arch, "shape": "custom",
                                        "chips": 1, "steps": 2})
        assert handle.state == "Completed" and handle.result["cluster"] == POD[pod], arch
    assert handle.result["arch"] == "qwen3-moe-smoke" and handle.result["real_compute"]
    assert [job.spec.arch for job in system.overlay.clusters[POD["torch"]].jobs.values()] \
        == ["qwen3-1.7b-smoke"]

    alone = mixed_fleet(("torch",))
    handle = alone.client.submit({"app": "train", "arch": PORT_LEAVES_OUT,
                                  "shape": "custom", "chips": 1, "steps": 2})
    assert handle is None
    assert not alone.overlay.clusters[POD["torch"]].jobs
    handle = alone.client.run_job({"app": "serve", "arch": "chameleon-smoke",
                                   "requests": 3, "new_tokens": 4})
    assert handle.state == "Completed" and handle.result["cluster"] == POD["torch"]
    assert handle.result["tokens_out"] == 12 and handle.result["real_compute"] is True
