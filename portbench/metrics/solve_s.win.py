"""The 4D-Var window solve (L-BFGS through the decoder and the flow steps
inside J), mean over the window's cycles (the cycle log's `solve_s`),
seconds."""

import statistics


def read(data):
    log = data.get("cycle_log")
    return statistics.mean(c["solve_s"] for c in log) if log else None
