"""The share of the traced slice's prefill (its start to the first
device-to-host copy of sampled tokens) with no kernel, copy or memset on
the device (`perfbench.trace`)."""


def read(obs):
    part = (obs.trace or {}).get("parts", {}).get("prefill")
    return part["idle_pct"] if part else None
