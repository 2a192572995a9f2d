"""The device's idle share over one profiled steady window cycle: 1 - the
union of its busy intervals over the traced window, percent."""


def read(data):
    t = data.get("trace")
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
