"""The device's peak allocated memory over the window (after a reset at
its start), less what the benchmark itself holds there (`harness_bytes`:
the truth's fields and the buffers of its check), GiB."""


def read(data):
    b = data.get("peak_window_bytes")
    return (b - data["harness_bytes"]) / 2 ** 30 if b else None
