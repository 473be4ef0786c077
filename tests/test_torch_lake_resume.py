"""PyTorch port: a training run resumes from a directory-backed lake in a
new process.

* ``repro.launch.train --smoke --lake-dir d --steps 4 --ckpt-every 2`` then
  ``repro_torch.launch.train ... --steps 6 --device cpu`` resumes at step 4,
  and the reverse; the resumed losses against a run of the first framework
  resumed from a copy of the directory;
* a process killed between the segments of a checkpoint resumes from the
  previous checkpoint, which its ``latest`` pointer still names.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.configs.base import smoke_of as jax_smoke
from repro.datalake import DataLake, DirStore
from repro.train.trainer import run_training as jax_run_training
from repro_torch.configs.base import smoke_of
from repro_torch.lake import DirLake, LakeName
from repro_torch.train.trainer import run_training

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

CLI = {"jax": [sys.executable, "-m", "repro.launch.train"],
       "port": [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"]}
LOSS = re.compile(r"^step\s+(\d+) loss (\S+)$", re.M)


def _cli(side, lake_dir, steps):
    out = subprocess.run(CLI[side] + ["--smoke", "--lake-dir", str(lake_dir), "--steps",
                                      str(steps), "--ckpt-every", "2"],
                         capture_output=True, text=True, timeout=300, env=ENV, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _resume_in_process(side, lake_dir, steps):
    """The CLI's run, resumed here from ``lake_dir`` (its defaults: lidc-demo
    smoke, 8 x 64 tokens, lr 3e-3, run name cli-<arch>)."""
    kw = dict(batch=8, seq=64, run_name="cli-lidc-demo-smoke", ckpt_every=2, lr=3e-3)
    if side == "jax":
        return jax_run_training(jax_smoke("lidc-demo"), steps=steps,
                                lake=DataLake(store=DirStore(str(lake_dir))), **kw)
    return run_training(smoke_of("lidc-demo"), steps=steps, lake=DirLake(str(lake_dir)),
                        device="cpu", **kw)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_cli_run_resumes_from_disk_on_the_other_framework(tmp_path, first, second):
    """``first``'s CLI trains 4 steps into a directory; ``second``'s CLI, a new
    process, resumes it to 6.  Its losses for steps 4-5 against ``first``
    resuming from a copy of the directory: 1e-4, and 5e-5 for the CLI's
    four printed decimals."""
    lake_dir = tmp_path / "lake"
    out = _cli(first, lake_dir, 4)
    assert [int(s) for s, _ in LOSS.findall(out)] == [0, 1, 2, 3]
    shutil.copytree(lake_dir, tmp_path / "copy")
    out = _cli(second, lake_dir, 6)
    assert "resumed from 4" in out
    got = LOSS.findall(out)
    assert [int(s) for s, _ in got] == [4, 5]
    want = _resume_in_process(first, tmp_path / "copy", 6)
    assert want.resumed_from == 4
    np.testing.assert_allclose([float(l) for _, l in got], want.losses, rtol=1e-4, atol=5e-5)
    latest = DirLake(str(lake_dir)).get_json(LakeName.parse(
        "/lidc/data/ckpt/cli-lidc-demo-smoke/latest"))
    assert latest["step"] == 6


DYING = """
import os, signal, sys
from repro_torch.configs.base import smoke_of
from repro_torch.lake import DirLake
from repro_torch.train.trainer import run_training

class Dying(DirLake):
    def _write(self, key, blob):
        if key.endswith("/step=4/seg=1"):      # between its two segments
            os.kill(os.getpid(), signal.SIGKILL)
        super()._write(key, blob)

run_training(smoke_of("lidc-demo"), steps=6, batch=2, seq=16, run_name="r", ckpt_every=2,
             lake=Dying(sys.argv[1]), device="cpu")
"""


def test_run_killed_during_a_checkpoint_resumes_from_the_previous_one(tmp_path):
    lake_dir = str(tmp_path / "lake")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(DYING), lake_dir],
                         capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode == -signal.SIGKILL, out.stderr[-3000:]
    lake = DirLake(lake_dir)
    ckpt = LakeName.parse("/lidc/data/ckpt/r")
    assert lake.get_json(ckpt.append("latest"))["step"] == 2
    assert lake.has(ckpt.append("step=2")) and not lake.has(ckpt.append("step=4"))
    assert lake.get_arrays(ckpt.append("step=4")) is None
    # the torn checkpoint's first segment is on disk, named by no index entry
    index = json.loads((tmp_path / "lake" / "_index.json").read_text())
    assert len(list((tmp_path / "lake").glob("*.bin"))) == len(index) + 1
    res = run_training(smoke_of("lidc-demo"), steps=6, batch=2, seq=16, run_name="r",
                       ckpt_every=2, lake=lake, device="cpu")
    assert res.resumed_from == 2 and res.steps_done == 6 and len(res.losses) == 4
    again = DirLake(lake_dir)
    assert again.get_json(ckpt.append("latest"))["step"] == 6
    assert again.get_arrays(ckpt.append("step=4")) is not None
