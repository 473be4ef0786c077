"""idle_share.serve, idle_share.train (one reader, split by the end-to-end
metric each moves): the time with no kernel running in a sub-window traced for
the device alone (the union of its kernels' intervals) over the
sub-window's length on the host clock, in %."""


def read(record):
    t = record.get("trace")
    if not t or not t["window_s"]:
        return None
    record.setdefault("bases", []).append(
        f"idle share: busy {t['busy_s']!r} s of a traced window of {t['window_s']!r} s")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
