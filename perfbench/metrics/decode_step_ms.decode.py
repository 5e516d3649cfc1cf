"""Mean of the engine's `serve.engine.step_seconds` over the window (each
step timed to the host copy of its sampled tokens)."""


def read(obs):
    h = obs.step_seconds
    return 1e3 * h["total"] / h["count"] if h["count"] else None
