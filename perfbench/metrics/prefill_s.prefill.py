"""Mean of the engine's `serve.engine.prefill_seconds` over the window."""


def read(obs):
    h = obs.prefill_seconds
    return h["total"] / h["count"] if h["count"] else None
