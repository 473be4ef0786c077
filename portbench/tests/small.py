"""A small configuration and small mixes, for driving whole runs of the
benchmark on the CPU (the port's plain PyTorch path)."""

from __future__ import annotations

import copy

from portbench import harness

SEED = 3_000_000_019      # above 2**31: a seed may need more than 32 signed bits

# Limits at this size, set as the cells' are, from CPU readings over seeds
# SEED + 0..5: the port's widest served gap 0-0.0142 (mistral shape), the
# fp8 control's 0.153-0.623;
# training's gaps 0.00010-0.00034 (step 1's loss), 0.0015-0.0033
# (gradient), 0.050-0.075 (change) against the control's 0.00006-0.0022,
# 0.0156-0.0397 and 0.009-0.014, and the faults': half the batch 0.0045-0.0126
# (step 1's loss) and 0.15-0.21 (gradient), a state unchanged 1 (gradient,
# change), a leaf moved twice 1.04 (change).  The worst step's loss gap is
# printed and not compared (None), as in the cell.
SMALL_LIMITS = {
    "mistral-large-123b.l11.serve.chat": {"served_logit_gap": 0.05},
    "qwen3-1.7b.train.s4096": {"loss_gap_step1": 0.0015, "grad_gap_median": None,
                               "grad_gap": 0.007, "change_gap": 0.3, "loss_gap": None},
}


def small_config(name: str = "qwen3-1.7b") -> dict:
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               intermediate_size=128, vocab_size=256, num_hidden_layers=2, eos_token_id=255)
    return cfg


def small_traffic(mix: str) -> dict:
    t = copy.deepcopy(harness.load_json(harness.HERE / "traffic" / f"{mix}.json"))
    if t["driver"] == "serve":
        t.update(slots=4, max_seq=64, clients=4, pool=64, warm_step=8, warm_iterations=2,
                 check_requests=3,
                 prompt={"median": 16, "sigma": 0.5, "min": 8, "max": 40},
                 output={"median": 8, "sigma": 0.5, "min": 4, "max": 16})
    else:
        t.update(rows=2, seq=64, document={"median": 10, "sigma": 1.0, "min": 2, "max": 100})
    return t
