"""The flow steps' share of the solve, percent: over the traced cycle, the
device time inside the port's `window.step` spans (each flow step of the
window cost, a checkpoint's recompute included) over the device time of
its `solve` span. The steps run one after another inside the solve, so the
share cannot pass 100. None without both spans' device times (a program
without them)."""


def read(data):
    spans = data.get("spans")
    if not spans:
        return None
    solve = [s["device_ms"] for s in spans if s["name"] == "solve"]
    steps = [s["device_ms"] for s in spans if s["name"] == "window.step"]
    if not solve or None in solve or not steps or None in steps:
        return None
    return 100.0 * sum(steps) / sum(solve)
