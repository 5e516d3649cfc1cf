"""A dense model's decode steps against the HBM bandwidth: the least
bytes of the window's steps (every weight once a step, of the embedding
the batch's rows, and the keys and values the active requests hold,
counted by `perfbench.counts` from the configuration's sizes) over the
summed step time, over 3.35 TB/s."""
from perfbench import counts, peaks


def read(obs):
    steps, t = obs.step_seconds["count"], obs.step_seconds["total"]
    if not steps or t <= 0 or obs.run.get("moe"):
        return None
    fixed = counts.decode_step_bytes(obs.run, obs.batch_slots, [])
    kv = counts.kv_bytes_per_position(obs.run)
    held = sum((len(s) - 1) * len(p) + (len(s) - 1) * len(s) / 2
               for w in obs.waves for p, s in zip(w.prompts, w.served))
    least = steps * fixed + held * kv
    return 100.0 * least / peaks.HBM_BYTES_PER_S / t
