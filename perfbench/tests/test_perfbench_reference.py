"""The plain references against the port at small widths on the CPU, at
float32: prefill over a left-padded wave and decode through the cache,
logit by logit; for MoE with capacity drops and with rows that finish
early (the engine keeps decoding them)."""
import numpy as np
import pytest
import torch

from perfbench import check, harness, weights
from perfbench.reference import dense_gqa, mla_moe
from perfbench.reference.common import FLOAT32
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program_wave(model, params, prompts, max_new):
    """The engine's loop on the Model API, keeping every step's logits:
    (padded tokens, served tokens per row, logits [steps+1][B, V], the
    tokens fed to each decode step [steps, B])."""
    B = len(prompts)
    S = max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    with torch.inference_mode():
        state, logits = model.prefill(params, {"tokens": torch.as_tensor(
            toks)}, max_len=S + max(max_new) + 8)
        steps = [logits.float()]
        nxt = logits.argmax(-1).to(torch.int32)
        served = [[int(nxt[i])] for i in range(B)]
        fed = []
        for n in range(1, max(max_new)):
            fed.append(nxt.numpy())
            state, logits = model.decode_step(params, state, nxt)
            steps.append(logits.float())
            nxt = logits.argmax(-1).to(torch.int32)
            for i in range(B):
                if n < max_new[i]:
                    served[i].append(int(nxt[i]))
    return toks, served, steps, np.stack(fed)


def _compare(cfg_file, ref, prompts, max_new, seed=3):
    model = harness.build(cfg_file)
    params = weights.make(model.abstract_params_and_axes()[0], seed,
                          torch.device("cpu"))
    toks, served, steps, fed = _program_wave(model, params, prompts,
                                             max_new)
    wave = {"tokens": toks, "served": served, "fed": fed}
    got = ref.served_logits(params, cfg_file["run"], wave,
                            list(range(len(prompts))), FLOAT32)
    worst = 0.0
    for r, lg in got.items():
        want = torch.stack([steps[i][r] for i in range(len(served[r]))])
        assert lg.shape == want.shape
        scale = want.abs().max()
        worst = max(worst, float((lg - want).abs().max() / scale))
    return worst


def _prompts(rng, lengths, vocab=512):
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in lengths]


def test_dense_gqa_matches_port_through_padded_prefill_and_decode():
    rng = np.random.default_rng(0)
    err = _compare(tiny.glm("float32"), dense_gqa,
                   _prompts(rng, [5, 17, 11]), [6, 3, 9])
    assert err < 1e-4


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_mla_moe_matches_port_with_drops_and_finished_rows(cf):
    rng = np.random.default_rng(1)
    err = _compare(tiny.deepseek("float32", capacity_factor=cf),
                   mla_moe, _prompts(rng, [9, 14, 4, 12]), [7, 2, 5, 4])
    assert err < 1e-4


def test_capacity_drops_happen_at_the_small_factor():
    """cf 0.5 must drop assignments, or the test above proves nothing
    about drops."""
    run = tiny.deepseek("float32", capacity_factor=0.5)["run"]
    X = torch.randn(40, 128, generator=torch.Generator().manual_seed(0))
    router = torch.randn(128, 8, generator=torch.Generator().manual_seed(1))
    _, _, kept = mla_moe.route(router, run, X)
    assert not bool(kept.all())


def test_sample_holds_the_longest_request_and_reaches_its_tokens():
    waves = [harness.Wave([np.ones(4, np.int32)] * 3, [5, 9, 2],
                          [[1] * 5, [1] * 9, [1] * 2], 1.0)
             for _ in range(4)]
    picked = check.sample(dense_gqa, waves, {"check": {"tokens": 20}}, 7)
    rows = [(w, r) for w, rs in picked for r in rs]
    assert (0, 1) in rows
    assert sum(len(waves[w].served[r]) for w, r in rows) >= 20
    assert check.sample(dense_gqa, waves, {"check": {"tokens": 20}}, 7) \
        == picked
    whole = check.sample(mla_moe, waves, {"check": {}}, 7)
    assert len(whole) == 1 and whole[0][1] == [0, 1, 2]
