"""The routed-only expert FFN (`repro_torch.kernels.moe_experts.
moe_experts`) and the MoE dispatch's route to it, on the CPU.

`_local_dispatch_ffn` takes the hand-written Hopper kernel pair for CUDA
bf16 inputs that `expert_route` accepts (no gradient, gated SiLU, C <= 16
rows an expert, d and f multiples of 64, E <= 1024), and the three
`torch.bmm` over every expert's buffer for everything else. The kernels
run only on a card: their plain version, `moe_experts_plain`, is
`_expert_ffn`'s bmm chain with the rows at or past each expert's fill set
to 0, and CPU tensors take it. Here:
  * the plain version equals `_expert_ffn` bit for bit on the rows below
    fill, and rows past fill read 0;
  * the route predicate is asked about a card's tensors by their device
    type, dtype, shapes and autograd alone;
  * the dispatch with the route forced to the kernel (the entry then takes
    the plain version) equals the bmm route bit for bit, with and without
    an offset of earlier tokens, and the scatter path on it matches the
    reference package's MoE within its bf16 tolerance.
The `cuda` tests at the end hold the kernel pair to the plain version on a
card and skip here; they import no JAX (`PYTHONPATH=src python3 -m pytest
--noconftest -m cuda tests/test_torch_moe_experts.py` on the card).
"""
import array
import ctypes
import dataclasses
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import expert_parallel as ep  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import moe_experts as me  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
ROOT = Path(__file__).resolve().parents[1]


def _buffers(E, C, d, f, fills, dtype=F32, seed=0, zero_past=True):
    """expert_in [E, C, d] (rows past each fill 0 where `zero_past`, as the
    dispatch leaves them), fill [E] int32 and wi, wg [E, d, f], wo [E, f,
    d], from numpy."""
    rng = np.random.RandomState(seed)
    fill = np.asarray(fills, np.int32)
    x = rng.randn(E, C, d).astype(np.float32)
    if zero_past:
        x[np.arange(C)[None, :] >= fill[:, None]] = 0.0
    w = [rng.randn(E, d, f) / np.sqrt(d), rng.randn(E, d, f) / np.sqrt(d),
         rng.randn(E, f, d) / np.sqrt(f)]
    t = [torch.as_tensor(a.astype(np.float32)).to(dtype) for a in (x, *w)]
    return t[0], torch.as_tensor(fill), t[1], t[2], t[3]


def _glu_cfg():
    return get_smoke_config("deepseek-v3-671b")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("C,fills", [
    (1, [0, 1, 0, 1, 1]),
    (3, [0, 3, 1, 2, 3]),
    (16, [16, 0, 5, 9, 1]),
], ids=["C1", "C3", "C16"])
def test_plain_equals_expert_ffn(C, fills, dtype):
    """Empty, partly filled and full experts: the plain version is
    `_expert_ffn` bit for bit below each fill and 0 past it, whatever
    expert_in holds there."""
    cfg = _glu_cfg()
    for zero_past in (True, False):
        x, fill, wi, wg, wo = _buffers(5, C, 64, 96, fills, dtype,
                                       zero_past=zero_past)
        got = me.moe_experts_plain(x, fill, wi, wg, wo)
        want = moe_mod._expert_ffn({"wi": wi, "wg": wg, "wo": wo}, cfg, x)
        below = torch.arange(C)[None, :] < fill[:, None]
        assert got.dtype == dtype and got.shape == (5, C, 64)
        assert torch.equal(got[below], want[below])
        assert bool((got[~below] == 0).all())
        if zero_past:  # the dispatch's buffers: equal everywhere
            assert torch.equal(got, want)


def test_entry_takes_the_plain_version_on_cpu():
    x, fill, wi, wg, wo = _buffers(6, 2, 128, 64, [0, 1, 2, 2, 0, 1], BF16)
    before = me.moe_experts.launches
    got = me.moe_experts(x, fill, wi, wg, wo)
    assert torch.equal(got, me.moe_experts_plain(x, fill, wi, wg, wo))
    assert me.moe_experts.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "fill"])
def test_entry_raises_on_what_neither_version_takes(bad):
    x, fill, wi, wg, wo = _buffers(4, 2, 64, 64, [1, 0, 2, 1], BF16)
    if bad == "shape":
        args, err = (x, fill, wi, wg, wo[:, :32]), ValueError
    elif bad == "dtype":
        args, err = (x, fill, wi.float(), wg, wo), TypeError
    else:
        args, err = (x, fill.float(), wi, wg, wo), TypeError
    with pytest.raises(err):
        me.moe_experts(*args)


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

DEEPSEEK = (256, 1, 7168, 2048)   # E, C, d, f of deepseek-v3-671b's decode


@pytest.mark.parametrize("case,args,want", [
    ("deepseek-decode", ("cuda", BF16, *DEEPSEEK, False, "silu"), "kernel"),
    ("deepseek-b64", ("cuda", BF16, 256, 3, 7168, 2048, False, "silu"),
     "kernel"),
    ("deepseek-prefill", ("cuda", BF16, 256, 637, 7168, 2048, False,
                          "silu"), "bmm"),
    ("rows-at-limit", ("cuda", BF16, 256, 16, 7168, 2048, False, "silu"),
     "kernel"),
    ("rows-past-limit", ("cuda", BF16, 256, 17, 7168, 2048, False, "silu"),
     "bmm"),
    ("dbrx-zoo", ("cuda", BF16, 16, 2, 6144, 10752, False, "silu"),
     "kernel"),
    ("dbrx-b16", ("cuda", BF16, 16, 5, 6144, 10752, False, "silu"),
     "kernel"),
    ("float32", ("cuda", F32, *DEEPSEEK, False, "silu"), "bmm"),
    ("mixed-dtypes", ("cuda", None, *DEEPSEEK, False, "silu"), "bmm"),
    ("needs-grad", ("cuda", BF16, *DEEPSEEK, True, "silu"), "bmm"),
    ("cpu", ("cpu", BF16, *DEEPSEEK, False, "silu"), "bmm"),
    ("gelu", ("cuda", BF16, *DEEPSEEK, False, "gelu"), "bmm"),
    ("no-gate", ("cuda", BF16, *DEEPSEEK, False, None), "bmm"),
    ("d-not-64", ("cuda", BF16, 256, 1, 7000, 2048, False, "silu"), "bmm"),
    ("too-many-experts", ("cuda", BF16, 1025, 1, 7168, 2048, False,
                          "silu"), "bmm"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_expert_route_pins_each_case(case, args, want):
    assert ep.expert_route(*args) == want, case


def _dispatch_inputs(T=6, k=2, E=8, d=64, f=64, dtype=BF16, seed=3):
    cfg = _glu_cfg()
    rng = np.random.RandomState(seed)
    xf = torch.as_tensor(rng.randn(T, d).astype(np.float32)).to(dtype)
    idx = torch.as_tensor(np.stack([rng.choice(E, k, replace=False)
                                    for _ in range(T)]).astype(np.int64))
    weights = torch.as_tensor(rng.rand(T, k).astype(np.float32))
    _, _, wi, wg, wo = _buffers(E, 1, d, f, [0] * E, dtype, seed=seed + 1)
    return cfg, xf, weights, idx, wi, wg, wo


def _routes(reg):
    return {r: reg.counter("moe.expert_route", route=r).value
            for r in ("kernel", "bmm")}


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bf16"])
@pytest.mark.parametrize("C,offset", [(1, None), (2, None), (3, None),
                                      (2, "offset")])
def test_dispatch_on_the_kernel_route_equals_bmm(monkeypatch, dtype, C,
                                                 offset):
    """The dispatch body with the route forced to the kernel (on the CPU
    the entry takes the plain version) gives the bmm route's output bit for
    bit, drops included, with and without an offset of earlier tokens'
    assignments (the mesh form of the scatter path); each call counts its
    route once."""
    cfg, xf, weights, idx, wi, wg, wo = _dispatch_inputs(dtype=dtype)
    off = None
    if offset:
        off = torch.as_tensor(np.random.RandomState(5).randint(
            0, 3, size=8).astype(np.int64))
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        want = ep._local_dispatch_ffn(cfg, xf, weights, idx, wi, wg, wo, 0,
                                      8, C, off)
        monkeypatch.setattr(ep, "expert_route", lambda *a: "kernel")
        seen = []
        real = me.moe_experts
        monkeypatch.setattr(me, "moe_experts", lambda *a: seen.append(
            a[1].clone()) or real(*a))
        got = ep._local_dispatch_ffn(cfg, xf, weights, idx, wi, wg, wo, 0, 8,
                                     C, off)
    finally:
        obs_metrics.pop_registry(reg)
    assert torch.equal(got, want)
    assert _routes(reg) == {"kernel": 1.0, "bmm": 1.0}
    (fill,) = seen
    assert fill.dtype == torch.int32 and fill.shape == (8,)
    counts = torch.bincount(idx.reshape(-1), minlength=8)
    if off is None:
        assert torch.equal(fill, torch.clamp(counts, max=C).to(torch.int32))
    else:
        end = torch.clamp(counts + off, max=C)
        assert torch.equal(fill, torch.where(counts > 0, end, 0).to(
            torch.int32))


def test_fills_cover_every_kept_row():
    """`_fills` against the dispatch's own destinations: every kept row of
    each expert lies below its fill, and an expert with no kept row has
    fill 0 where no offset moves its rows."""
    cfg, xf, weights, idx, wi, wg, wo = _dispatch_inputs(T=20, k=3)
    for C, off in ((1, None), (4, None), (3, torch.tensor(
            [0, 1, 2, 3, 0, 1, 2, 3]))):
        a = idx.reshape(-1)
        onehot = torch.nn.functional.one_hot(a, 8).to(torch.int32)
        counted = torch.cumsum(onehot, dim=0)
        pos = (counted - onehot).gather(1, a[:, None])[:, 0]
        if off is not None:
            pos = pos + off[a]
        keep = pos < C
        fill = ep._fills(counted, off, 0, 8, C)
        assert bool((pos[keep] < fill[a[keep]]).all())
        assert bool((fill <= C).all())
        if off is None:
            hit = torch.zeros(8, dtype=torch.bool)
            hit[a[keep]] = True
            assert torch.equal(fill > 0, hit)


def test_experts_run_is_what_the_route_read(monkeypatch):
    """Under a tracer, `block.moe`'s `experts_run` is E on the bmm route
    and the experts given a row on the kernel route (a device scalar, an
    int when read)."""
    cfg, xf, weights, idx, wi, wg, wo = _dispatch_inputs()
    runs = []
    for route in ("bmm", "kernel"):
        monkeypatch.setattr(ep, "expert_route", lambda *a, r=route: r)
        tracer = obs_trace.Tracer()
        obs_trace.activate(tracer)
        try:
            with obs_trace.span("block.moe"):
                ep._local_dispatch_ffn(cfg, xf, weights, idx, wi, wg, wo, 0,
                                       8, 1)
        finally:
            obs_trace.deactivate(tracer)
        runs.append(tracer.events[0]["args"]["experts_run"])
    assert runs == [8, len(set(idx.reshape(-1).tolist()))]
    assert all(type(n) is int for n in runs)


def test_scatter_on_the_kernel_route_matches_the_reference(monkeypatch):
    """`moe_forward_scatter` at bf16 with the route forced to the kernel
    (the plain version on the CPU) and on its own route (bmm) against the
    reference package's scatter MoE on the same numpy inputs, at a width
    the kernel takes (d 128, f 128) and a decode's C = 1: within the bf16
    tolerance of tests/test_torch_zoo.py, and the two routes equal."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import moe as j_moe
    rng = np.random.RandomState(4)
    cfgs = []
    for get in (get_smoke_config, j_smoke):
        c = get("deepseek-v3-671b").replace(activation_dtype="bfloat16")
        cfgs.append(c.replace(moe=dataclasses.replace(c.moe,
                                                      d_ff_expert=128)))
    tcfg, jcfg = cfgs
    mo, d = tcfg.moe, tcfg.d_model
    E, ff, fs = mo.num_experts, mo.d_ff_expert, mo.d_ff_shared
    p = {"router": rng.randn(d, E) / np.sqrt(d),
         "wi": rng.randn(E, d, ff) / np.sqrt(d),
         "wg": rng.randn(E, d, ff) / np.sqrt(d),
         "wo": rng.randn(E, ff, d) / np.sqrt(ff),
         "shared_wi": rng.randn(d, fs) / np.sqrt(d),
         "shared_wg": rng.randn(d, fs) / np.sqrt(d),
         "shared_wo": rng.randn(fs, d) / np.sqrt(fs)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.randn(3, 1, d) * 0.5).astype(np.float32)
    assert moe_mod.capacity(tcfg, 3) == 1
    # the engine's tree: bf16 weights, the router read in float32
    tp = {k: torch.as_tensor(v) if k == "router" else
          torch.as_tensor(v).to(BF16) for k, v in p.items()}
    tx = torch.as_tensor(x).to(BF16)
    with torch.inference_mode():
        bmm, _ = moe_mod.moe_forward(tp, tcfg, tx, "scatter")
        monkeypatch.setattr(ep, "expert_route", lambda *a: "kernel")
        kern, _ = moe_mod.moe_forward(tp, tcfg, tx, "scatter")
    assert torch.equal(kern, bmm)
    ref, _ = j_moe.moe_forward({k: jnp.asarray(v) for k, v in p.items()},
                               jcfg, jnp.asarray(x).astype(jnp.bfloat16),
                               "scatter")
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(kern.float().numpy() - ref)
    assert (err <= 3e-2 * np.abs(ref).max()).all(), err.max()


# ---------------------------------------------------------------------------
# The binding and the launch
# ---------------------------------------------------------------------------


def test_binding_reads_the_packed_arguments_in_order(monkeypatch):
    """The C entry unpacks `ARGS` from its int64 array in the wrapper's
    order, and its ctypes signature is (array address, stream)."""
    src = (build.CSRC_DIR / "moe_experts.cu").read_text()
    body = src.split('extern "C" cudaError_t repro_moe_experts', 1)[1]
    sig = re.match(r"\(([^)]*)\)", body).group(1)
    assert [s.split()[-1].lstrip("*") for s in sig.split(",")] == \
        ["a", "stream"]
    read = {int(i): n for n, i in re.findall(r"p\.(\w+) = [^;]*a\[(\d+)\]",
                                             body)}
    assert [read[i] for i in range(len(read))] == list(me.ARGS)
    fn = types.SimpleNamespace()
    monkeypatch.setattr(build, "load", lambda n: types.SimpleNamespace(
        repro_moe_experts=fn))
    assert me._kernel.__wrapped__() is fn
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def test_no_new_header_in_csrc():
    """build.library_path hashes every csrc/*.cuh into every library: the
    experts kernel includes none, so that it rebuilds no other kernel."""
    src = (build.CSRC_DIR / "moe_experts.cu").read_text()
    assert not re.search(r'#include\s+"', src)
    assert sorted(p.name for p in build.CSRC_DIR.glob("*.cuh")) == [
        "decode_attention.cuh", "hopper.cuh"]


def _fake_launch(monkeypatch, err=0):
    """CPU tensors through the CUDA branch: the launch records the packed
    arguments in place of calling the kernels."""
    calls = []

    def kernel(ptr, stream):
        n = len(me.ARGS)
        calls.append((list(array.array("q", ctypes.string_at(ptr, 8 * n))),
                      stream))
        return err

    monkeypatch.setattr(me, "_kernel", lambda: kernel)
    monkeypatch.setattr(me.da, "_raw_stream", lambda: 7)
    monkeypatch.setattr(me, "_scratch", {})
    return calls


def test_launch_passes_the_shapes_strides_and_scratch(monkeypatch):
    """The weights are read in place through their strides (wi and wg
    slices of one tensor); x and fill are passed as they are; h is one
    scratch reused by the next call; the launch counts one call."""
    calls = _fake_launch(monkeypatch)
    x, fill, _, _, wo = _buffers(4, 2, 128, 192, [1, 0, 2, 1], BF16)
    both = torch.zeros(4, 128, 2, 192, dtype=BF16)
    wi, wg = both[:, :, 0], both[:, :, 1]
    before = me.moe_experts.launches
    out = me._launch(x, fill, wi, wg, wo)
    me._launch(x, fill, wi, wg, wo)
    (a1, s1), (a2, _) = calls
    got = dict(zip(me.ARGS, a1))
    assert [got[n] for n in ("E", "C", "d", "f")] == [4, 2, 128, 192]
    assert [got[n] for n in ("wi_e", "wi_k", "wg_e", "wg_k")] == \
        [128 * 384, 384, 128 * 384, 384]
    assert [got[n] for n in ("wo_e", "wo_k")] == [192 * 128, 128]
    assert got["wi"] == wi.data_ptr() and got["wg"] == wg.data_ptr()
    assert got["x"] == x.data_ptr() and got["fill"] == fill.data_ptr()
    assert got["out"] == out.data_ptr() and out.shape == (4, 2, 128)
    assert got["h"] == dict(zip(me.ARGS, a2))["h"] and s1 == 7
    assert me.moe_experts.launches == before + 2


def test_launch_copies_what_the_kernel_cannot_read_in_place(monkeypatch):
    """A weight whose rows are not contiguous is copied; an int64 fill is
    taken as int32; a launch error raises and counts nothing."""
    calls = _fake_launch(monkeypatch)
    x, fill, wi, wg, wo = _buffers(4, 2, 128, 192, [1, 0, 2, 1], BF16)
    wo_t = wo.transpose(1, 2).contiguous().transpose(1, 2)
    me._launch(x, fill.long(), wi, wg, wo_t)
    got = dict(zip(me.ARGS, calls[0][0]))
    assert got["wo"] != wo_t.data_ptr() and got["wo_k"] == 128
    assert got["fill"] != fill.data_ptr()
    calls = _fake_launch(monkeypatch, err=1)
    before = me.moe_experts.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        me._launch(x, fill, wi, wg, wo)
    assert me.moe_experts.launches == before


# ---------------------------------------------------------------------------
# chip_smoke.py's phases
# ---------------------------------------------------------------------------


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_moe_check_rehearses_on_cpu():
    """chip_smoke.py's `moe_experts_check` on the CPU, where the entry
    takes its plain version (no launch): every case within the tolerance,
    rows past fill 0; a planted fault (one filled expert's fill set to 0)
    reads far past the row limit."""
    cs = _chip_smoke()
    out = cs.moe_experts_check(me, "cpu")
    assert out["cases"] == 11 and out["launches"] == 0
    gen = torch.Generator().manual_seed(1)
    x, fill, wi, wg, wo = cs.moe_inputs(8, 2, 128, 128, 4, 2, gen, "cpu")
    want = me.moe_experts_plain(x, fill, wi, wg, wo)
    planted = fill.clone()
    planted[int(torch.nonzero(fill)[0, 0])] = 0
    fault = cs.row_rel_err(me.moe_experts(x, planted, wi, wg, wo), want)
    assert fault > cs.MOE_REL_TOL


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _card_inputs(E, C, d, f, tokens, top_k, seed):
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cs, cs.moe_inputs(E, C, d, f, tokens, top_k, gen, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f,tokens,top_k", [
    (256, 1, 7168, 2048, 16, 8),
    (16, 2, 6144, 10752, 4, 4),
], ids=["deepseek-v3-671b.decode", "dbrx-132b.decode"])
def test_cuda_kernel_matches_plain(E, C, d, f, tokens, top_k):
    """At deepseek-v3-671b's decode (about 100 of 256 experts filled) and
    dbrx-132b's: within 3e-2 elementwise and 1e-2 of each (expert, row)'s
    norm, rows past fill exactly 0; one filled expert skipped (its fill set
    to 0) reads far past the row limit."""
    _card()
    cs, (x, fill, wi, wg, wo) = _card_inputs(E, C, d, f, tokens, top_k, 9)
    before = me.moe_experts.launches
    got = me.moe_experts(x, fill, wi, wg, wo)
    torch.cuda.synchronize()
    assert me.moe_experts.launches == before + 1
    want = me.moe_experts_plain(x, fill, wi, wg, wo)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)
    assert cs.row_rel_err(got, want) <= 1e-2
    past = torch.arange(C, device="cuda")[None, :] >= fill[:, None]
    assert bool((got[past] == 0).all())
    planted = fill.clone()
    planted[int(torch.nonzero(fill)[0, 0])] = 0
    assert cs.row_rel_err(me.moe_experts(x, planted, wi, wg, wo),
                          want) > 0.5


@pytest.mark.cuda
def test_cuda_launches_equal_the_kernel_route_count():
    """A smoke deepseek-v3-671b decode step (bf16 weights, d 128, f 64: the
    kernel's widths) on the card takes the kernel pair once an MoE layer,
    and `moe.expert_route` counts exactly those calls `kernel`; its prefill
    takes bmm where C exceeds the kernel's rows."""
    _card()
    cfg = get_smoke_config("deepseek-v3-671b")
    model = build_model(cfg)
    params = model.cast_params(model.init(0, "cuda"))
    tokens = torch.randint(1, cfg.vocab_size, (2, 40), dtype=torch.int32,
                           device="cuda")
    moe_layers = cfg.num_layers - cfg.moe.first_dense_layers
    with torch.inference_mode():
        state, _ = model.prefill(params, {"tokens": tokens})
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.push_registry(reg)
        before = me.moe_experts.launches
        try:
            model.decode_step(params, state, tokens[:, 0])
            torch.cuda.synchronize()
        finally:
            obs_metrics.pop_registry(reg)
    assert me.moe_experts.launches - before == moe_layers
    assert _routes(reg) == {"kernel": float(moe_layers), "bmm": 0.0}
