"""The traffic generator repeats per seed, changes with it, and gives
every seed the same lengths."""
from perfbench import spec, traffic


def _key(wave):
    return [(d.prompt.tolist(), d.max_new_tokens) for d in wave]


def test_wave_repeats_per_seed_and_changes_with_it():
    mix = spec.traffic("chat")
    a = traffic.wave(mix, 16, 151552, 2 ** 31 + 5, 0)
    assert _key(a) == _key(traffic.wave(mix, 16, 151552, 2 ** 31 + 5, 0))
    assert _key(a) != _key(traffic.wave(mix, 16, 151552, 2 ** 31 + 6, 0))
    assert _key(a) != _key(traffic.wave(mix, 16, 151552, 2 ** 31 + 5, 1))


def test_stratified_lengths_are_the_same_multiset_for_every_seed():
    mix = spec.traffic("chat")
    sizes = set()
    for seed in (1, 2, 3 ** 20):
        w = traffic.wave(mix, 64, 1000, seed, 0)
        sizes.add((tuple(sorted(len(d.prompt) for d in w)),
                   tuple(sorted(d.max_new_tokens for d in w))))
        assert all(1 <= d.prompt.min() and d.prompt.max() < 1000 for d in w)
    assert len(sizes) == 1
    prompts, outputs = sizes.pop()
    assert 256 <= min(prompts) and max(prompts) <= 1024
    assert 64 <= min(outputs) and max(outputs) <= 256
    assert traffic.longest_prompt(mix, 64) == max(prompts)
    assert traffic.max_len(mix) == 1024 + 256 + 8



def test_a_mix_holds_lengths_and_its_description_only():
    """Greedy, stratified and closed-loop are the generator's; a mix file
    gives only its length bounds, its source and why it exists."""
    for name in ("chat", "longprompt"):
        mix = spec.traffic(name)
        assert set(mix) == {"prompt_tokens", "output_tokens", "source",
                            "why"}
        for k in ("prompt_tokens", "output_tokens"):
            assert set(mix[k]) == {"low", "high"}
            assert 1 <= mix[k]["low"] <= mix[k]["high"]
