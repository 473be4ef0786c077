"""The two packages side by side for the parity tests of the port's planes
(``tests/test_torch_{datalake_fetch,serve_plane,replication,workflow,
taskmap}.py``): one namespace of modules per package, and a reset that
numbers jobs and Interests from 1 in a package, so that a scenario run on
each gives the same names, nonces and event traces."""

import importlib
import itertools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]

MODULES = {
    "core": "core", "forwarder": "core.forwarder", "names": "core.names",
    "jobs": "core.jobs", "packets": "core.packets", "strategy": "core.strategy",
    "cluster": "core.cluster", "compute_plane": "core.compute_plane",
    "overlay": "core.overlay", "validation": "core.validation",
    "routing": "core.routing", "demand": "core.demand",
    "datalake": "datalake", "kv": "datalake.kv", "fetch": "datalake.fetch",
    "replication": "datalake.replication", "plane": "serve.plane",
    "workflow": "workflow", "apps": "workflow.apps", "faults": "workflow.faults",
    "engine": "workflow.engine", "dag": "workflow.dag", "taskmap": "workflow.taskmap",
}

PACKAGES = {"reference": "repro", "port": "repro_torch"}


def package(pkg: str) -> SimpleNamespace:
    """The modules of ``pkg`` ("reference" or "port") by their short names."""
    root = PACKAGES[pkg]
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{m}")
                              for k, m in MODULES.items()})


def renumber(monkeypatch, pkg: str) -> SimpleNamespace:
    """Number jobs and Interests from 1 in ``pkg``; returns its modules."""
    p = package(pkg)
    monkeypatch.setattr(p.jobs, "_job_seq", itertools.count(1))
    monkeypatch.setattr(p.packets, "_nonce_counter", itertools.count(1))
    return p


def on_both(monkeypatch, scenario, *args, **kw):
    """``scenario(p, *args, **kw)`` run on the reference, then on the port,
    each freshly numbered; returns both results."""
    return {pkg: scenario(renumber(monkeypatch, pkg), *args, **kw) for pkg in PACKAGES}


def reference_example(name: str) -> str:
    """The standard output of the repo's ``examples/<name>.py`` (the
    reference's), run as its docstring says, in a process of its own."""
    out = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return out.stdout
