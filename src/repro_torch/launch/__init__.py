"""Launchers (port of `repro.launch`): train.py, the Moses autotune step of
the training launcher. Nothing here touches the card at import time."""
