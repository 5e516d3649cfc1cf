"""The share of the traced slice's decode steps (first to last
device-to-host copy of sampled tokens) with no kernel, copy or memset on
the device (`perfbench.trace`)."""


def read(obs):
    part = (obs.trace or {}).get("parts", {}).get("decode")
    return part["idle_pct"] if part else None
