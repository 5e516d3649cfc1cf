"""Set-up: process start to the window's start (imports, CUDA, the
weights from the seed, the engine, the warm-up at the cell's shapes)."""


def read(obs):
    return obs.setup_s
