"""A run with its timed path broken underneath comes out not correct,
and the control (the reference at fp8 in the program's place) reads far
above the program and comes out not correct under the cell's limits, at
small widths on the CPU. The harness's look for a card is skipped:
`run_cell` is driven on the CPU."""
import functools
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_unchanged(engine):
    step = engine._step
    engine._step = lambda params, state, tok: (state,
                                               step(params, state, tok)[1])


def _token_altered(engine):
    sample = engine._sample

    def altered(logits, temps):
        t = sample(logits, temps)
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t
    engine._sample = altered


def _half_batch(engine):
    """Each step computes the first half of the batch; the rest take its
    logits."""
    step = engine._step

    def half(params, state, tok):
        state, logits = step(params, state, tok)
        B = logits.shape[0]
        return state, torch.cat([logits[: B // 2], logits[: B - B // 2]])
    engine._step = half


def _decode_off_the_tap(engine):
    """The engine's decode reaches the model's step without going through
    the `Model.decode_step` attribute (as a captured or fused step
    would)."""
    model = engine.model
    decode = type(model).decode_step
    engine._step = lambda params, state, tok: decode(model, params, state,
                                                     tok)


def _run(cfg, seed=5, faults=None, control=False):
    return harness.run_cell(getattr(tiny, cfg)(), tiny.MIX, tiny.cell(cfg),
                            [], seed=seed, seconds=0.0, trace=False,
                            device="cpu", t_start=time.perf_counter(),
                            faults=faults, control=control)


@functools.lru_cache(maxsize=None)
def _with_control(cfg, seed):
    return _run(cfg, seed=seed, control=True)


@pytest.mark.parametrize("cfg", ["glm", "deepseek"])
@pytest.mark.parametrize("fault", [_state_unchanged, _token_altered,
                                   _half_batch])
def test_a_broken_timed_path_is_not_correct(cfg, fault):
    assert _run(cfg)["result"]["correct"]
    assert not _run(cfg, faults=fault)["result"]["correct"]


@pytest.mark.parametrize("cfg", ["glm", "deepseek"])
def test_the_control_reads_far_above_the_program(cfg):
    prog, ctl = [], []
    for seed in (1, 2, 3):
        info = _with_control(cfg, seed)["info"]
        prog.append(info["program"]["max_gap"])
        ctl.append(info["control"]["max_gap"])
    assert min(ctl) > 1.5 * max(prog)
    assert min(ctl) > 0.04


@pytest.mark.parametrize("cfg", ["glm", "deepseek"])
def test_the_control_is_not_correct_under_the_cells_limits(cfg):
    for seed in (1, 2, 3):
        out = _with_control(cfg, seed)
        assert out["result"]["correct"]
        ctl = out["info"]["control"]
        assert not ctl["correct"]
        assert set(ctl["check"]) == set(tiny.LIMITS[cfg])
        assert any(c["value"] > c["limit"] for c in ctl["check"].values())


def test_a_decode_off_the_tap_is_named():
    """The replay of a wave whose rows interact follows the tokens the
    tap records; a decode that bypasses the tap stops the run with the
    cause, not with a crash in the reference."""
    with pytest.raises(RuntimeError, match="Model.decode_step"):
        _run("deepseek", faults=_decode_off_the_tap)
