"""mfu.serve: the share of the window that the chip's roofline bound of
the window's work would fill: for each prefill and each decode step the
larger of its counted operations over 989 TFLOP/s and its counted bytes
(weights, cache positions attended, K/V written) over 3.35 TB/s, summed,
over the window's seconds, in %.  The counts are the record's family's."""

from portbench import families
from portbench import yardstick as y


def read(record):
    s, fam = record["spec"], families.named(record["family"])
    counts = []
    for i in record["iterations"]:
        if i["phase"] != "window":
            continue
        counts += [fam.prefill_counts(s, n) for n in i["prefills"]]
        if i["active"]:
            counts.append(fam.decode_step_counts(s, i["active"], i["active_pos"], i["rows"],
                                                 i["all_pos"]))
    if not counts:
        return None
    bound, secs = y.bound_s(counts), record["window"]["seconds"]
    record.setdefault("bases", []).append(
        f"mfu.serve: roofline bound {bound!r} s of {len(counts)} prefills and steps over "
        f"{secs!r} s")
    return 100.0 * bound / secs
