"""The host's time to enqueue `Model.decode_step` (to its return) over
its wall time to a synchronise, medians over the steps run after the
window on a state prefilled at the cell's batch and longest prompt."""
import statistics

NEEDS = ("split",)


def read(obs):
    if not obs.split:
        return None
    return 100.0 * statistics.median(obs.split["enqueue"]) / \
        statistics.median(obs.split["wall"])
