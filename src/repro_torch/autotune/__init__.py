"""Autotuning stack: config space, device simulator, strategies, sessions
and the tuned-config registry (port of `repro.autotune`)."""
