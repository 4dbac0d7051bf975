"""The 95th percentile (nearest rank) of every batch of the window, each
timed by the host clock from its hand-over to the return of the grounding
evaluator's `evaluate`."""

import math


def read(run):
    lat = sorted(run.spans.get("batch", []))
    if run.mode != "eval" or not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
