"""Nearest-rank 95th percentile over every request of the window's
waves; a request's latency runs from its wave's hand-off to `generate`
to that call's return."""
import math


def read(obs):
    xs = sorted(w.seconds for w in obs.waves for _ in w.prompts)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]
