"""flash_attention_roofline: the roofline bound of the traced training
steps' causal attention, forward and backward (2 products forward, 4
backward: dV, dP, dQ, dK; the recomputed scores are not counted) over the
device time of the kernels launched under ``repro_torch::flash_attention``
and ``repro_torch::flash_attention_bwd``, in %.  The layers that run
attention, and their heads, are the record's family's."""

from portbench import families
from portbench import yardstick as y

OPS = ("repro_torch::flash_attention", "repro_torch::flash_attention_bwd")


def read(record):
    t = record.get("trace_ops")
    if not t or not record.get("trace_steps"):
        return None
    dev = sum(t["op_device_s"].get(op, 0.0) for op in OPS)
    if not dev:
        return None
    s, rows, seq = record["spec"], record["rows"], record["seq"]
    layers = families.named(record["family"]).attention_layers(s)
    flops = 3.0 * y.attention_flops(s, seq) * rows * layers * record["trace_steps"]
    nbytes = 3.0 * y.attention_bytes(s, seq) * rows * layers * record["trace_steps"]
    bound = max(flops / y.PEAK_FLOPS[s.dtype], nbytes / y.PEAK_BYTES)
    record.setdefault("bases", []).append(
        f"flash_attention_roofline: {flops!r} operations, bound {bound!r} s over device "
        f"{dev!r} s")
    return 100.0 * bound / dev
