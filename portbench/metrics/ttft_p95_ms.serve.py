"""ttft_p95_ms.serve: the 95th percentile (nearest rank) of submit to first
token, over every request submitted in the window.
A per-layer metric, not an end-to-end one: a closed loop of as many
clients as slots keeps the engine saturated, so the tokens completed a
second are what users get, and the tail follows the queue."""

from portbench.yardstick import percentile


def read(record):
    w = record["window"]
    ttft = [r["first"] - r["submitted"] for r in record["requests"]
            if w["open"] <= r["submitted"] < w["close"] and r["first"] is not None]
    if not ttft:
        return None
    record.setdefault("bases", []).append(
        f"ttft_p95_ms.serve: {len(ttft)} requests submitted in the window, "
        f"{len(ttft) - int(0.95 * len(ttft))} beyond the 95th percentile")
    return 1e3 * percentile(ttft, 95)
