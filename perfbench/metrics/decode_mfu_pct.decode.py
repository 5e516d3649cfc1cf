"""FLOPs the window's decode steps' active requests need (counted from
the configuration's sizes by `perfbench.counts`: 2 a weight a token runs,
an MoE token its top_k experts, plus attention over its own positions)
over the summed decode-step time, over the bf16 peak."""
from perfbench import counts, peaks


def read(obs):
    t = obs.step_seconds["total"]
    if not obs.step_seconds["count"] or t <= 0:
        return None
    per_token = counts.decode_token_flops(obs.run, 0)
    per_position = counts.attention_flops_per_position(obs.run)
    flops = 0.0
    for w in obs.waves:
        for p, s in zip(w.prompts, w.served):
            n = len(s) - 1            # decode tokens; contexts p+1 .. p+n
            flops += n * per_token + per_position * (
                n * len(p) + n * (n + 1) / 2)
    return 100.0 * flops / t / peaks.BF16_FLOPS
