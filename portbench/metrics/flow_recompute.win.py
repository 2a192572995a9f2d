"""Flow forwards recomputed per flow step asked for: over the window's
cycles, the port's `window.flow_forwards` (every execution of a flow
step, the step checkpoint's recompute in a backward included) over its
`window.rollout_steps` (the steps the window cost's loop asks for), less
1. 0 without a checkpoint's recompute; 1 were every evaluation a value
and gradient under the step checkpoint. None for a program without the
counters."""


def read(data):
    counts = data.get("counters") or {}
    steps, forwards = counts.get("window.rollout_steps"), counts.get("window.flow_forwards")
    if not steps or forwards is None:
        return None
    return forwards / steps - 1.0
