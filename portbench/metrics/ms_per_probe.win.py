"""Milliseconds of solve per L-BFGS probe: the window's cycles' summed
`solve_s` (cycle log) over the `lbfgs.probes` the port counted in the same
cycles (its counters are always on, so this is read outside the
profiler). None for a program without the counter."""


def read(data):
    log, counts = data.get("cycle_log"), data.get("counters")
    probes = (counts or {}).get("lbfgs.probes")
    if not log or not probes:
        return None
    return 1e3 * sum(c["solve_s"] for c in log) / probes
