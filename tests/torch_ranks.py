"""Helpers for the port's multi-rank CPU tests.

``spawn`` runs a function on n ranks, each a process started with
``torch.multiprocessing`` (spawn) that joins a gloo process group through a
``file://`` rendezvous under the test's temporary directory, so tests on
parallel workers never share a port.  Each rank's return value comes back
through a pickle file.  ``run_jax`` runs JAX code in a subprocess with
``xla_force_host_platform_device_count`` set, as ``tests/test_distributed.py``
and ``tests/test_pipeline.py`` do, and returns the arrays it saved.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _rank_main(rank, fn, n, tmp, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=n)
    try:
        out = fn(rank, n, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, n, tmp_path, *args, timeout=240):
    """[fn(rank, n, *args) for each rank], each on its own process of an
    n-rank gloo group.  ``fn`` must be importable (a module-level function)."""
    import torch.multiprocessing as mp
    tmp = str(Path(tmp_path) / f"ranks-{fn.__name__}-{time.monotonic_ns()}")
    os.makedirs(tmp)
    ctx = mp.start_processes(_rank_main, args=(fn, n, tmp, args), nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {n} ranks did not end in {timeout} s")
    results = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def run_jax(code: str, devices: int, out_path, timeout=300):
    """Run ``code`` under JAX on ``devices`` host devices; it saves its
    arrays with ``np.savez(OUT, ...)`` (``OUT`` is defined for it).
    Returns them as a dict."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    prog = f"OUT = {str(out_path)!r}\n" + textwrap.dedent(code)
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}
