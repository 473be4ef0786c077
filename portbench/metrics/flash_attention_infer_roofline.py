"""flash_attention_infer_roofline: the roofline bound of the traced
prefills' causal attention (4·heads·head_dim operations a query-key pair;
q, k, v read and o written once) over the device time of the kernels
launched under ``repro_torch::flash_attention_infer``, in %.  The layers
that run attention, and their heads, are the record's family's."""

from portbench import families
from portbench import yardstick as y

OP = "repro_torch::flash_attention_infer"


def read(record):
    t = record.get("trace_ops")
    if not t or not t["op_device_s"].get(OP):
        return None
    s = record["spec"]
    layers = families.named(record["family"]).attention_layers(s)
    bound = sum(layers * max(y.attention_flops(s, n) / y.PEAK_FLOPS[s.dtype],
                             y.attention_bytes(s, n) / y.PEAK_BYTES)
                for i in record["iterations"] if i["phase"] == "trace_ops"
                for n in i["prefills"])
    dev = t["op_device_s"][OP]
    record.setdefault("bases", []).append(
        f"flash_attention_infer_roofline: bound {bound!r} s over device {dev!r} s")
    return 100.0 * bound / dev if bound else None
