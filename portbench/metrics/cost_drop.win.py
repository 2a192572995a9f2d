"""How far the window solve lowers the 4D-Var cost, (J before - J after) /
J before in percent, J = Jb + obs_coeff Jo over the window's slots from
the cycle log, the mean over the window's first 3 cycles."""

import statistics


def read(data):
    log = data.get("cycle_log")
    if not log:
        return None
    k = data["obs_coeff"]
    drops = []
    for c in log[:3]:
        j0 = c["jb"][0] + k * c["jo"][0]
        j1 = c["jb"][-1] + k * c["jo"][-1]
        drops.append(100.0 * (j0 - j1) / j0)
    return statistics.mean(drops)
