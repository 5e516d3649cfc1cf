"""The RG-LRU scan launch plan (`repro_torch.kernels.rg_lru.plan`) on the
CPU.

The plan decides, before any launch, how many width lanes one CTA owns (so
that the CTAs spread over the SMs), how deep the shared-memory ring is and
how it is filled (TMA boxes, or plain loads where a row of W elements is not
a multiple of 16 bytes). The CUDA kernel runs only on a card: the `cuda`
test at the end holds it against `rg_lru_plain` there, bit for bit (both
multiply then add, each rounded, in the same order), and skips here.
"""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.autotune.space import Workload, knob_space  # noqa: E402
from repro_torch.kernels import rg_lru as lru  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,W,lanes", [
    (1, 2560, 16), (1, 1024, 16), (1, 2048, 16), (2, 2560, 32),
    (8, 2560, 32), (1, 4224, 32), (1, 4192, 16), (3, 17, 16),
    (1, 32, 16)])
def test_lane_and_cta_rule(B, W, lanes):
    """32 lanes a CTA, or 16 where B * ceil(W / 32) < 132."""
    p = lru.plan(B, 512, W, BF16, 256, 256)
    assert p.lanes == lanes
    assert p.ctas == B * -(-W // lanes)


def test_rg_lru_scan_spreads_over_the_sms():
    """RecurrentGemma-2B's rg_lru_scan (B = 1, S = 512, W = 2560, bf16):
    160 CTAs of 16 lanes (3 before), TMA loads, and the whole sequence, 8
    stages of 64 steps, 32 KB of a and x, in flight in each CTA."""
    p = lru.plan(1, 512, 2560, BF16, 256, 1024)
    assert (p.lanes, p.ctas, p.route) == (16, 160, "tma")
    assert p.ctas >= 80
    assert (p.stage_steps, p.stages) == (64, 8)
    assert p.stages * 2 * p.stage_steps * p.lanes * 2 == 32 * 1024


@pytest.mark.parametrize("W,dtype,route", [
    (2560, BF16, "tma"), (17, BF16, "ldg"), (300, BF16, "ldg"),
    (300, F32, "tma"), (17, F32, "ldg"), (8, BF16, "tma"), (4, BF16, "ldg"),
    (4, F32, "tma")], ids=str)
def test_load_route(W, dtype, route):
    """TMA where a row of W elements is a multiple of 16 bytes, else the
    producer warp's plain loads."""
    p = lru.plan(3, 33, W, dtype, 256, 256)
    assert p.route == route
    assert (W * (2 if dtype == BF16 else 4) % 16 == 0) == (route == "tma")


@pytest.mark.parametrize("S", [1, 33, 64, 65, 512, 12544])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_ring_depth(S, dtype):
    """As many stages as the sequence needs, at most 8 and 64 KB of ring;
    the shared memory the kernel asks for is the ring, its barriers and
    128 bytes of alignment slack."""
    for W in (17, 2560):
        p = lru.plan(1, S, W, dtype, 256, 256)
        stage = 2 * p.stage_steps * p.lanes * (2 if dtype == BF16 else 4)
        assert 1 <= p.stages <= lru.MAX_STAGES
        assert p.stages * stage <= lru.MAX_RING_BYTES
        assert p.stages == min(-(-S // 64), lru.MAX_RING_BYTES // stage, 8)
        assert p.smem_bytes == 128 + p.stages * stage + 16 * p.stages


def test_knobs_change_nothing():
    """chunk and block_w are checked, but no launch depends on them."""
    ks = knob_space(Workload("scan", (512, 2560)))
    plans = {lru.plan(1, 512, 2560, BF16, ck, bw)
             for ck, bw in itertools.product(ks["chunk"], ks["block_w"])}
    assert len(plans) == 1
    with pytest.raises(ValueError):
        lru.plan(1, 512, 2560, BF16, 0, 256)


def test_launch_error_raises_with_the_plan(monkeypatch):
    """No fallback: a refused launch raises, naming the plan. The CUDA path
    is reached with CPU tensors posing as CUDA ones."""
    calls = []

    def refuse(*args):
        calls.append(args)
        return 1  # cudaErrorInvalidValue

    class Cuda(torch.Tensor):
        @property
        def device(self):
            return types.SimpleNamespace(type="cuda")

    monkeypatch.setattr(lru, "_kernel", lambda: refuse)
    monkeypatch.setattr(lru.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(lru.torch.cuda, "device", lambda device: _Null())
    monkeypatch.setattr(lru.torch, "empty",
                        lambda shape, device=None, dtype=None: torch.zeros(
                            shape, dtype=dtype))
    a = torch.ones(1, 512, 2560, dtype=BF16).as_subclass(Cuda)
    x = torch.ones(1, 512, 2560, dtype=BF16).as_subclass(Cuda)
    before = lru.rg_lru.launches
    with pytest.raises(RuntimeError, match="rg_lru kernel launch failed.*"
                       "lanes=16, ctas=160.*route='tma'"):
        lru.rg_lru(a, x, chunk=256, block_w=1024)
    assert lru.rg_lru.launches == before
    # B, S, W, lanes, stages, tma, bf16 as the plan says
    assert calls[0][3:10] == (1, 512, 2560, 16, 8, 1, 1)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 512, 2560), BF16), ((3, 33, 17), BF16), ((3, 33, 17), F32)],
    ids=["rg_lru_scan", "ragged-bf16", "ragged-f32"])
def test_cuda_kernel_is_bit_identical_to_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    rng = np.random.RandomState(11)
    a = (1.0 / (1.0 + np.exp(-rng.randn(*shape))) * 0.98).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    ta, tx = (torch.as_tensor(t).to("cuda", dtype) for t in (a, x))
    before = lru.rg_lru.launches
    got = lru.rg_lru(ta, tx, chunk=256, block_w=1024)
    torch.cuda.synchronize()
    assert lru.rg_lru.launches == before + 1
    want = lru.rg_lru_plain(ta, tx)
    assert float((got - want).abs().max()) == 0.0
