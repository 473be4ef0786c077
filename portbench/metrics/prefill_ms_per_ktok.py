"""prefill_ms_per_ktok: the engine's host milliseconds in prefill (its
``prefill_s``, first token included) per 1,000 prompt tokens prefilled
in the window."""


def read(record):
    tokens = sum(sum(i["prefills"]) for i in record["iterations"] if i["phase"] == "window")
    if not tokens:
        return None
    secs = record["engine"]["prefill_s"]
    record.setdefault("bases", []).append(
        f"prefill_ms_per_ktok: prefill_s {secs!r} over {tokens} prompt tokens")
    return 1e3 * secs / (tokens / 1e3)
