"""FLOPs of each request's own prompt (causal pairs within it, no
padding; `perfbench.counts`) over the window's summed prefill time, over
the bf16 peak."""
from perfbench import counts, peaks


def read(obs):
    t = obs.prefill_seconds["total"]
    if not obs.prefill_seconds["count"] or t <= 0:
        return None
    flops = sum(counts.prefill_flops(obs.run, len(p))
                for w in obs.waves for p in w.prompts)
    return 100.0 * flops / t / peaks.BF16_FLOPS
