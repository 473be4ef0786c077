"""The benchmark's fixed measures: the H100's peaks, the operations and
bytes of the attention kernels, and the statistics of a window.

Nothing here imports the program.  The counts are of what the inputs
need: every cache position a slot attends read once, each causal
query-key pair once.  The counts of a whole model step are its family's
(``families/<family>.py``); they take these for the attention layers.
An attention count takes the shapes of the layer's attention from the
family's spec: ``heads``, ``kv_heads``, ``head_dim`` and ``dtype_bytes``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "percentile", "decode_attention_bytes",
           "attention_flops", "attention_bytes", "bound_s"]

# NVIDIA H100 SXM data sheet, dense rates at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile of all ``values``: the smallest
    value with at least p % of them at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(ordered)))
    return ordered[rank - 1]


def attention_flops(s, seq: int, causal: bool = True) -> float:
    """QK^T and PV of one sequence through one layer's attention: 2
    products x 2 operations x query-key pairs x head dim x heads."""
    pairs = seq * (seq + 1) / 2 if causal else seq * seq
    return 4.0 * pairs * s.head_dim * s.heads


def attention_bytes(s, seq: int) -> float:
    """q, k, v read and o written once, one sequence, one layer."""
    return float(seq * (2 * s.heads + 2 * s.kv_heads) * s.head_dim * s.dtype_bytes)


def decode_attention_bytes(s, positions: int, rows: int) -> float:
    """One layer's flash_decode over ``rows`` slots attending ``positions``
    cache positions in all: K and V of every position read once, q read
    and o written once a row."""
    kv = 2.0 * positions * s.kv_heads * s.head_dim * s.dtype_bytes
    return kv + 2.0 * rows * s.heads * s.head_dim * s.dtype_bytes


def bound_s(counts: Iterable[Dict[str, float]], dtype: str = "bfloat16") -> float:
    """The least time the chip could take for each piece of work, summed:
    the larger of its operations over the peak rate and its bytes over the
    peak bandwidth."""
    return sum(max(c["flops"] / PEAK_FLOPS[dtype], c["bytes"] / PEAK_BYTES) for c in counts)
