"""The obs preparation on the prefetch worker, mean over the window's
cycles (the cycle log's `obs_s`), seconds."""

import statistics


def read(data):
    log = data.get("cycle_log")
    return statistics.mean(c["obs_s"] for c in log) if log else None
