"""The wave engine's useful share of decode work: tokens the decode
steps gave active requests (each request's first token comes from the
prefill) over decode steps (the engine's own count) times batch slots."""


def read(obs):
    steps = obs.step_seconds["count"]
    if not steps:
        return None
    useful = sum(len(s) - 1 for w in obs.waves for s in w.served)
    return 100.0 * useful / (steps * obs.batch_slots)
