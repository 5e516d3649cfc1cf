"""Every token `generate` put into a request of the window's waves, over
the window's whole span."""


def read(obs):
    tokens = sum(len(s) for w in obs.waves for s in w.served)
    return tokens / obs.window_s
