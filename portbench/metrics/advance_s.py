"""The 6 h advance (the forecast callable the harness hands the cycler,
synchronised), mean over the window's cycles, seconds."""

import statistics


def read(data):
    spans = data.get("advance_s")
    return statistics.mean(spans.values()) if spans else None
