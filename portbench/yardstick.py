"""The benchmark's fixed measures: the H100's peaks, the operations and
bytes of a model step and of each kernel, and the statistics of a window.

Nothing here imports the program.  The counts are of what the inputs
need: every weight byte read once a step, every cache position a slot
attends read once, each causal query-key pair once.  ``model_flops`` is a
copy of the port's ``models/model.py::model_flops`` for the dense decoder
(6·N·D in training plus the causal attention term), kept here so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Sequence

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "Spec", "spec_of", "percentile", "param_count",
           "matmul_params", "model_flops_train", "decode_step_counts", "prefill_counts",
           "decode_attention_bytes", "attention_flops", "attention_bytes", "bound_s"]

# NVIDIA H100 SXM data sheet, dense rates at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Spec:
    """The shapes of a dense decoder, read from a configuration file."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    theta: float
    qk_norm: bool
    tied: bool
    dtype: str

    @property
    def dtype_bytes(self) -> int:
        return {"bfloat16": 2, "float16": 2, "float32": 4}[self.dtype]


def spec_of(cfg: Dict) -> Spec:
    """A configuration file's published keys as a ``Spec``."""
    heads = int(cfg["num_attention_heads"])
    return Spec(layers=int(cfg["num_hidden_layers"]), d_model=int(cfg["hidden_size"]),
                heads=heads, kv_heads=int(cfg["num_key_value_heads"]),
                head_dim=int(cfg.get("head_dim") or cfg["hidden_size"] // heads),
                d_ff=int(cfg["intermediate_size"]), vocab=int(cfg["vocab_size"]),
                eps=float(cfg["rms_norm_eps"]), theta=float(cfg["rope_theta"]),
                qk_norm=bool(cfg.get("qk_norm", False)),
                tied=bool(cfg["tie_word_embeddings"]), dtype=str(cfg["torch_dtype"]))


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile of all ``values``: the smallest
    value with at least p % of them at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(ordered)))
    return ordered[rank - 1]


def layer_params(s: Spec) -> int:
    attn = s.d_model * (s.heads + 2 * s.kv_heads) * s.head_dim + s.heads * s.head_dim * s.d_model
    norms = 2 * s.d_model + (2 * s.head_dim if s.qk_norm else 0)
    return attn + 3 * s.d_model * s.d_ff + norms


def param_count(s: Spec) -> int:
    """Every parameter: the layers, the embedding, the final norm and an
    untied head."""
    head = 0 if s.tied else s.d_model * s.vocab
    return s.layers * layer_params(s) + s.vocab * s.d_model + s.d_model + head


def matmul_params(s: Spec) -> int:
    """Parameters that enter a matrix product for every token: the layers'
    projections and the output head (the tied table, or the untied head;
    an untied embedding is a lookup)."""
    attn = s.d_model * (s.heads + 2 * s.kv_heads) * s.head_dim + s.heads * s.head_dim * s.d_model
    return s.layers * (attn + 3 * s.d_model * s.d_ff) + s.vocab * s.d_model


def weight_bytes_read(s: Spec, rows: int) -> int:
    """Weight bytes one forward step over ``rows`` tokens must read: every
    parameter once, an untied embedding only its ``rows`` rows."""
    n = param_count(s)
    if not s.tied:
        n -= s.vocab * s.d_model - rows * s.d_model
    return n * s.dtype_bytes


def model_flops_train(s: Spec, batch: int, seq: int) -> float:
    """The port's ``model_flops`` for a training step of ``batch`` x ``seq``
    tokens: 6·N·D plus causal QK^T and PV, forward and backward."""
    n = param_count(s)
    return 6.0 * n * batch * seq + 12.0 * s.layers * batch * s.heads * s.head_dim * seq ** 2 / 2


def attention_flops(s: Spec, seq: int, causal: bool = True) -> float:
    """QK^T and PV of one sequence through one layer's attention: 2
    products x 2 operations x query-key pairs x head dim x heads."""
    pairs = seq * (seq + 1) / 2 if causal else seq * seq
    return 4.0 * pairs * s.head_dim * s.heads


def attention_bytes(s: Spec, seq: int) -> float:
    """q, k, v read and o written once, one sequence, one layer."""
    return float(seq * (2 * s.heads + 2 * s.kv_heads) * s.head_dim * s.dtype_bytes)


def decode_attention_bytes(s: Spec, positions: int, rows: int) -> float:
    """One layer's flash_decode over ``rows`` slots attending ``positions``
    cache positions in all: K and V of every position read once, q read
    and o written once a row."""
    kv = 2.0 * positions * s.kv_heads * s.head_dim * s.dtype_bytes
    return kv + 2.0 * rows * s.heads * s.head_dim * s.dtype_bytes


def decode_step_counts(s: Spec, active: int, active_positions: int, rows: int,
                       all_positions: int) -> Dict[str, float]:
    """One decode step of ``rows`` slots, ``active`` of them serving a
    request: operations of the active rows (projections, head, attention
    over their ``active_positions``), bytes of the weights, the cache
    positions every slot attends (``all_positions``) and the new K/V."""
    flops = (2.0 * matmul_params(s) * active
             + 4.0 * s.layers * s.heads * s.head_dim * active_positions)
    kv_write = 2.0 * rows * s.layers * s.kv_heads * s.head_dim * s.dtype_bytes
    nbytes = (weight_bytes_read(s, rows) + kv_write
              + s.layers * decode_attention_bytes(s, all_positions, rows))
    return {"flops": flops, "bytes": nbytes}


def prefill_counts(s: Spec, seq: int) -> Dict[str, float]:
    """One prompt of ``seq`` tokens: its projections, the causal attention
    of every layer, the head at the last position; the weights read once
    and the K/V written once."""
    flops = (2.0 * (matmul_params(s) - s.vocab * s.d_model) * seq + 2.0 * s.vocab * s.d_model
             + s.layers * attention_flops(s, seq))
    kv_write = 2.0 * seq * s.layers * s.kv_heads * s.head_dim * s.dtype_bytes
    return {"flops": flops, "bytes": weight_bytes_read(s, seq) + kv_write}


def bound_s(counts: Iterable[Dict[str, float]], dtype: str = "bfloat16") -> float:
    """The least time the chip could take for each piece of work, summed:
    the larger of its operations over the peak rate and its bytes over the
    peak bandwidth."""
    return sum(max(c["flops"] / PEAK_FLOPS[dtype], c["bytes"] / PEAK_BYTES) for c in counts)

