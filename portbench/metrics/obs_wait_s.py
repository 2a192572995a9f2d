"""The loop's wait for the prefetched obs, mean over the window's cycles
(the cycle log's `obs_wait_s`), seconds."""

import statistics


def read(data):
    log = data.get("cycle_log")
    return statistics.mean(c["obs_wait_s"] for c in log) if log else None
