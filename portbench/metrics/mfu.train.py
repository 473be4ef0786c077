"""mfu.train: the model FLOPs of the window's training steps (the record's
family's ``train_flops``: for the dense family 6·N·D plus causal attention,
the port's ``model_flops`` as copied there) over the window's seconds and
989 TFLOP/s, in %."""

from portbench import families
from portbench import yardstick as y


def read(record):
    s, fam = record["spec"], families.named(record["family"])
    rows, seq = record["rows"], record["seq"]
    flops = len(record["steps"]) * fam.train_flops(s, rows, seq)
    secs = record["window"]["seconds"]
    record.setdefault("bases", []).append(
        f"mfu.train: {flops!r} model FLOPs over {secs!r} s at {y.PEAK_FLOPS['bfloat16']!r}")
    return 100.0 * flops / secs / y.PEAK_FLOPS["bfloat16"]
