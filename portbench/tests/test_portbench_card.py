"""One cell on the card, end to end, through the benchmark's command
(it needs a CUDA device; without one it skips)."""

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.cuda
def test_one_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "qwen3-1.7b.train.s4096", "--seed", str(2**31 + 9), "--seconds", "3",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"setup_s", "train_tok_s"} <= set(result["metrics"])
