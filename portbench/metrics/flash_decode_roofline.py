"""flash_decode_roofline: the roofline bound of the traced decode steps'
attention (K and V of every position each slot attends, read once; q and
o once a row; 4·heads·head_dim operations a position) over the device
time of the kernels launched under ``repro_torch::flash_decode``, in %.
The layers that run attention, and their heads, are the record's family's."""

from portbench import families
from portbench import yardstick as y

OP = "repro_torch::flash_decode"


def read(record):
    t = record.get("trace_ops")
    if not t or not t["op_device_s"].get(OP):
        return None
    s = record["spec"]
    layers = families.named(record["family"]).attention_layers(s)
    bound = 0.0
    for i in record["iterations"]:
        if i["phase"] == "trace_ops" and i["active"]:
            nbytes = y.decode_attention_bytes(s, i["all_pos"], i["rows"])
            flops = 4.0 * s.heads * s.head_dim * i["all_pos"]
            bound += layers * max(flops / y.PEAK_FLOPS[s.dtype], nbytes / y.PEAK_BYTES)
    dev = t["op_device_s"][OP]
    record.setdefault("bases", []).append(
        f"flash_decode_roofline: bound {bound!r} s over device {dev!r} s")
    return 100.0 * bound / dev if bound else None
