"""decode_step_ms: the engine's host seconds in decode steps over its
decode steps, both as the window moved its counters (``decode_s``,
``decode_steps``)."""


def read(record):
    e = record["engine"]
    if not e["decode_steps"]:
        return None
    record.setdefault("bases", []).append(
        f"decode_step_ms: decode_s {e['decode_s']!r} over {e['decode_steps']} steps")
    return 1e3 * e["decode_s"] / e["decode_steps"]
