"""itl_p95_ms.serve: the 95th percentile (nearest rank) of the gaps between
consecutive tokens of a request, over every gap that ends in the window.
A per-layer metric, not an end-to-end one: a closed loop of as many
clients as slots keeps the engine saturated, so the tokens completed a
second are what users get, and the tail follows the queue."""

from portbench.yardstick import percentile


def read(record):
    gaps = record["gaps"].get("window", [])
    if not gaps:
        return None
    record.setdefault("bases", []).append(f"itl_p95_ms.serve: {len(gaps)} gaps in the window")
    return 1e3 * percentile(gaps, 95)
