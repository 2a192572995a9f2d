"""The variational solve (L-BFGS through the decoder), mean over the
window's cycles (the cycle log's `solve_s`), seconds."""

import statistics


def read(data):
    log = data.get("cycle_log")
    return statistics.mean(c["solve_s"] for c in log) if log else None
