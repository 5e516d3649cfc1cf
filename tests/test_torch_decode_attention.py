"""The decode attention entry (`repro_torch.kernels.decode_attention.
decode_attention`) and the models' route to it, on the CPU.

`decode_attend` takes the hand-written Hopper kernel for CUDA bf16 inputs
that `decode_route` accepts (D == Dv, D % 8 == 0, D <= 256, G dividing H),
and `decode_attend_partial` (the loop) for everything else. The kernel
runs only on a card: its plain version, `decode_attention_plain`, is the
loop on checked inputs (one max over the whole cache, P rounded to bf16,
float32 sums), and CPU tensors take it. Here it is held against the
reference package's `decode_attend` on the same numpy inputs:
  * float32 inputs within rtol = atol = 1e-4: summation order and exp's
    last bits only;
  * bf16 inputs within rtol = atol = 3e-2, the reference's own bf16
    tolerance (tests/test_kernels.py), as for the prefill kernel: P rounds
    to bf16 against another running max, and the output rounds once more.
The route predicate is asked about a card's tensors by their device type,
dtype and shapes alone. The `cuda` tests at the end hold the kernel to the
plain version on a card and skip here.
"""
import array
import ctypes
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import ParamBuilder  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = {F32: 1e-4, BF16: 3e-2}
ROOT = Path(__file__).resolve().parents[1]


def _case(B, Sc, H, G, D, kept, ring=False, seed=0):
    """numpy q [B, H, D], k, v [B, Sc, G, D], positions [B, Sc] and cur
    [B]: row b keeps its last kept - b slots' positions (at least 1); a
    ring holds positions cur - Sc + 1 .. cur at slot position % Sc, else
    slots 0 .. n - 1 hold positions 0 .. n - 1 and the rest are -1."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, Sc, G, D).astype(np.float32)
    v = rng.randn(B, Sc, G, D).astype(np.float32)
    slot = np.arange(Sc, dtype=np.int32)
    n = np.maximum(kept - np.arange(B, dtype=np.int32), 1)
    if ring:
        cur = n + Sc - 1
        pos = cur[:, None] - (cur[:, None] - slot[None, :]) % Sc
    else:
        cur = n - 1
        pos = np.where(slot[None, :] < n[:, None], slot[None, :], -1)
    return q, k, v, pos.astype(np.int32), cur.astype(np.int32)


def _torch(case, dtype):
    q, k, v, pos, cur = case
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype), torch.from_numpy(pos),
            torch.from_numpy(cur))


# (name, B, Sc, H, G, D, kept, window, ring)
CASES = [
    ("glm4-gqa", 3, 300, 32, 2, 128, 250, 0, False),       # G 2, R 16
    ("mqa-d256-ring", 2, 200, 10, 1, 256, 200, 64, True),  # window, wrap
    ("mqa-d256-empty", 2, 200, 10, 1, 256, 120, 64, True),
    ("whisper-cross", 2, 300, 6, 6, 64, 300, 0, False),    # all visible
    ("two-head-tiles", 2, 90, 40, 2, 80, 70, 0, False),    # R 20
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,B,Sc,H,G,D,kept,window,ring", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_the_jax_reference(name, B, Sc, H, G, D, kept, window,
                                         ring, dtype):
    """The plain version (what CPU tensors take) against the reference
    package's `decode_attend` on the same numpy inputs: float32 within
    1e-4, bf16 within the reference's 3e-2; q's dtype and layout kept."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import attention as j_attn
    case = _case(B, Sc, H, G, D, kept, ring, seed=D)
    if name == "mqa-d256-empty":
        case[3][1] = -1                          # a row with nothing kept
    jd, td = jnp.dtype(dtype), {"float32": F32, "bfloat16": BF16}[dtype]
    q, k, v, pos, cur = case
    want = j_attn.decode_attend(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                jnp.asarray(v, jd), jnp.asarray(pos),
                                jnp.asarray(cur), window=window)
    got = da.decode_attention(*_torch(case, td), window=window)
    assert got.dtype == td and got.shape == (B, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[td], atol=TOL[td])


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_row_with_no_kept_slot_is_exactly_zero(dtype):
    q, k, v, pos, cur = _torch(_case(3, 70, 8, 2, 64, 60), dtype)
    pos[1] = -1                  # every slot empty
    pos[2] = cur[2] + 1          # every slot in the future
    for fn in (da.decode_attention_plain, attn.decode_attend):
        out = fn(q, k, v, pos, cur)
        assert torch.equal(out[1:], torch.zeros_like(out[1:]))
        assert bool((out[0] != 0).any())


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_decode_attend_equals_the_loop_on_cpu(dtype):
    """On the CPU `decode_attend` and the plain version are the loop's
    partials divided out, bit for bit."""
    q, k, v, pos, cur = _torch(_case(2, 100, 16, 2, 64, 90), dtype)
    got = attn.decode_attend(q, k, v, pos, cur, window=30)
    o, _, l = attn.decode_attend_partial(q, k, v, pos, cur, window=30)
    assert torch.equal(got, (o / torch.where(l == 0, 1.0, l)[..., None])
                       .to(dtype))
    assert torch.equal(
        da.decode_attention_plain(q, k, v, pos, cur, window=30), got)


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v, p, c: (q[0], k, v, p, c), "q \\[B, H, D\\]"),
    (lambda q, k, v, p, c: (q, k[:, :, :1].expand(-1, -1, 3, -1),
                            v[:, :, :1].expand(-1, -1, 3, -1), p, c),
     "G dividing H"),
    (lambda q, k, v, p, c: (q, k, v[..., :32], p, c), "q \\[B, H, D\\]"),
    (lambda q, k, v, p, c: (q, k, v, p[:, :5], c), "kv_positions"),
    (lambda q, k, v, p, c: (q, k, v, p, c[:1]), "cur_pos"),
    (lambda q, k, v, p, c: (q, k.half(), v, p, c), "float32 or three"),
], ids=["q-rank", "g-not-dividing", "dv", "positions", "cur", "dtype"])
def test_entry_checks_its_inputs(bad, match):
    args = _torch(_case(2, 20, 4, 2, 64, 20), F32)
    with pytest.raises((ValueError, TypeError), match=match):
        da.decode_attention(*bad(*args))
    with pytest.raises(ValueError, match="window"):
        da.decode_attention(*args, window=-1)


def test_cpu_tensors_count_no_launch():
    before = da.decode_attention.launches
    da.decode_attention(*_torch(_case(1, 8, 4, 2, 64, 8), BF16))
    assert da.decode_attention.launches == before


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


def test_plan_at_the_benchmark_decodes():
    """glm4-9b.chat's decode (64 rows, 1288 slots) is one split of 128 CTAs
    (its 128 (row, kv head) units fill the card); glm4-9b.longprompt's (16
    rows, 4120 slots) 4 splits of 65 tiles; 8 warps, 16-slot tiles and 3
    stages in either, within a block's shared memory."""
    chat = da.decode_plan(64, 1288, 32, 2, 128)
    assert (chat.warps, chat.kv_tile, chat.stages, chat.splits, chat.ctas,
            chat.ws_floats) == (8, 16, 3, 1, 128, 0)
    long = da.decode_plan(16, 4120, 32, 2, 128)
    assert (long.splits, long.tiles_per_split, long.ctas) == (4, 65, 128)
    assert long.ws_floats == 32 * 4 * 16 * 132
    for p in (chat, long):
        assert p.smem_bytes == da._smem(128, 3) <= da.SMEM_LIMIT


@pytest.mark.parametrize("D", [64, 80, 120, 128, 192, 256])
@pytest.mark.parametrize("B,Sc,H,G", [(1, 1, 8, 1), (2, 2048, 10, 1),
                                      (64, 1288, 32, 2), (4, 131072, 8, 8)])
def test_plan_fits_every_zoo_head_dim(D, B, Sc, H, G):
    """Every zoo head dim fits 2 to 4 stages; the splits cover the tiles
    with none empty and at most 128 tiles (the kernel's positions buffer)
    each."""
    p = da.decode_plan(B, Sc, H, G, D)
    tiles = -(-Sc // da.KV_TILE)
    assert 2 <= p.stages <= da.MAX_STAGES and p.smem_bytes <= da.SMEM_LIMIT
    assert p.warps == (8 if p.d_pad <= 128 else 4)
    assert (p.splits - 1) * p.tiles_per_split < tiles \
        <= p.splits * p.tiles_per_split
    assert p.tiles_per_split <= da.MAX_SPLIT_TILES
    assert p.ctas == p.units * p.splits == B * G * -(-(H // G) // 16) \
        * p.splits


def test_splits_fill_the_card_and_no_more():
    """As few splits as fill the card's CTA slots: one wave, each CTA's
    streams as short as the waves allow."""
    assert da._splits(128, 81, 132, 8) == 1      # chat: 128 units fill it
    assert da._splits(32, 258, 132, 8) == 4      # longprompt
    assert da._splits(1, 10, 132, 8) == 2        # a tile a stream
    assert da._splits(2, 8192, 132, 8) == 64     # long ring: every split
    assert da._splits(1000, 300, 132, 8) == 3    # past 128 tiles a split


@pytest.mark.parametrize("args,match", [
    ((2, 64, 8, 2, 64, 64, F32), "reads bf16"),
    ((2, 64, 8, 2, 192, 128, BF16), "D == Dv"),
    ((2, 64, 8, 2, 36, 36, BF16), "D % 8"),
    ((2, 64, 8, 2, 264, 264, BF16), "D % 8 == 0 and D <= 256"),
    ((2, 64, 8, 3, 64, 64, BF16), "G dividing"),
    ((0, 64, 8, 2, 64, 64, BF16), "B, Sc, H, G >= 1"),
    ((1, 131073 + 16, 8, 2, 64, 64, BF16), "cache slots"),
])
def test_refusal_names_the_reason(args, match):
    assert re.search(match, da.decode_refusal(*args))
    if args[4] == args[5] and args[6] is BF16:
        with pytest.raises(ValueError, match=match):
            da.decode_plan(*args[:5])


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


def _shapes(B, Sc, H, G, D, Dv=None):
    return (B, H, D), (B, Sc, G, D), (B, Sc, G, D if Dv is None else Dv)


@pytest.mark.parametrize("device,dtype,shapes,route", [
    ("cuda", BF16, _shapes(64, 1288, 32, 2, 128), "kernel"),   # chat
    ("cuda", BF16, _shapes(16, 4120, 32, 2, 128), "kernel"),   # longprompt
    ("cuda", BF16, _shapes(8, 2048, 10, 1, 256), "kernel"),    # MQA, D 256
    ("cuda", BF16, _shapes(4, 1500, 6, 6, 64), "kernel"),      # whisper x
    ("cpu", BF16, _shapes(64, 1288, 32, 2, 128), "loop"),      # CPU tensors
    ("cuda", F32, _shapes(64, 1288, 32, 2, 128), "loop"),      # float32
    ("cuda", None, _shapes(2, 64, 8, 2, 128), "loop"),         # mixed
    ("cuda", BF16, _shapes(2, 64, 8, 2, 192, 128), "loop"),    # Dv != D
    ("cuda", BF16, _shapes(2, 64, 8, 2, 36), "loop"),          # D % 8 != 0
    ("cuda", BF16, _shapes(2, 64, 8, 2, 264), "loop"),         # D > 256
    ("cuda", BF16, _shapes(2, 64, 6, 4, 64), "loop"),          # G !| H
    ("meta", BF16, _shapes(2, 64, 8, 2, 64), "loop"),
], ids=["chat", "longprompt", "mqa-d256", "whisper-cross", "cpu", "f32",
        "mixed", "dv", "d36", "d264", "g-not-dividing", "meta"])
def test_route_predicate(device, dtype, shapes, route):
    assert attn.decode_route(device, dtype, *shapes) == route


def test_route_predicate_needs_one_batch_and_head_dim():
    q, k, v = _shapes(2, 64, 8, 2, 64)
    assert attn.decode_route("cuda", BF16, q, (3, 64, 2, 64), v) == "loop"
    assert attn.decode_route("cuda", BF16, q, (2, 64, 2, 32), v) == "loop"


def test_every_zoo_gqa_decode_takes_the_kernel_on_a_card():
    """Every zoo head dim is a multiple of 8 and at most 256 and every
    kv-head count divides its head count, so every GQA, MQA, sliding and
    local decode, and the cross attention over encoder positions, takes
    the kernel at bf16 on a card; MLA decodes in latent space and asks no
    route."""
    seen = 0
    for name in ARCH_IDS:
        cfg = get_config(name)
        if cfg.mla is not None or not cfg.num_heads:
            continue
        hd = cfg.resolved_head_dim
        shapes = _shapes(4, 2048, cfg.num_heads, cfg.num_kv_heads, hd)
        assert attn.decode_route("cuda", BF16, *shapes) == "kernel", name
        seen += 1
    assert seen >= 8


def _attention_params(cfg, seed=0, cross=False):
    b = ParamBuilder(torch.Generator().manual_seed(seed), "float32")
    attn.init_attention(b.child("attn"), cfg, cross=cross)
    return b.params["attn"]


@pytest.fixture()
def kernel_spy(monkeypatch):
    """Every route picks the kernel, and the kernel is its plain version,
    recording each call: what a card would route, without a card."""
    calls = []

    def fake_kernel(q, k, v, pos, cur, window=0, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), window))
        return da.decode_attention_plain(q, k, v, pos, cur, window=window,
                                         scale=scale)

    attn.decode_route.cache_clear()
    monkeypatch.setattr(attn, "decode_route", lambda *a, **k: "kernel")
    monkeypatch.setattr(da, "decode_attention", fake_kernel)
    return calls


def test_decode_and_cross_attention_take_the_kernel_and_mla_not(kernel_spy):
    """With the route set to the kernel, `attention_decode` calls it once
    with the config's window, `cross_attention_decode` once over the
    encoder rows, and MLA's decode never."""
    cfg = get_smoke_config("glm4-9b")
    p = _attention_params(cfg)
    x = torch.randn(2, 12, cfg.d_model)
    pos = torch.arange(12, dtype=torch.int32)
    _, cache = attn.attention_prefill(p, cfg, x, pos, cache_len=16)
    cur = torch.full((2,), 12, dtype=torch.int32)
    attn.attention_decode(p, cfg, x[:, :1], cache, cur, window=5)
    H, G, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    assert kernel_spy == [((2, H, D), (2, 16, G, D), 5)]
    attn.cross_attention_decode(p, cfg, x[:, :1], {"k": cache["k"],
                                                   "v": cache["v"]})
    assert kernel_spy[1] == ((2, H, D), (2, 16, G, D), 0)
    ds = get_smoke_config("deepseek-v3-671b")
    b = ParamBuilder(torch.Generator().manual_seed(0), "float32")
    attn.init_mla(b.child("attn"), ds)
    pm = b.params["attn"]
    xd = torch.randn(2, 12, ds.d_model)
    _, mc = attn.mla_prefill(pm, ds, xd, pos, cache_len=16)
    attn.mla_decode(pm, ds, xd[:, :1], mc, cur)
    assert len(kernel_spy) == 2


def _routes(reg):
    return {r: reg.counter("attn.decode_route", route=r).value
            for r in ("kernel", "loop")}


def test_route_counter_counts_one_loop_a_call_on_cpu():
    q, k, v, pos, cur = _torch(_case(2, 40, 8, 2, 64, 30), BF16)
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        for n in range(1, 4):
            attn.decode_attend(q, k, v, pos, cur)
            assert _routes(reg) == {"kernel": 0.0, "loop": float(n)}
    finally:
        obs_metrics.pop_registry(reg)


@pytest.mark.parametrize("arch", ["glm4-9b", "deepseek-v3-671b"])
def test_route_counter_over_a_model_decode_step(arch):
    """One `Model.decode_step` on the CPU counts one `loop` for each GQA
    layer, and none for MLA's."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 12), dtype=torch.int32)
    state, _ = model.prefill(params, {"tokens": tokens})
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        model.decode_step(params, state, tokens[:, 0])
    finally:
        obs_metrics.pop_registry(reg)
    want = 0 if cfg.mla is not None else cfg.num_layers
    assert _routes(reg) == {"kernel": 0.0, "loop": float(want)}


_MESH_SCRIPT = r"""
import json, sys
import torch
torch.set_num_threads(1)
import numpy as np
from repro_torch.distributed import decode_attention as dd
from repro_torch.kernels import decode_attention as da
from repro_torch.launch.mesh import init_process_group, make_host_mesh
from repro_torch.models import attention as attn
init_process_group("cpu", init_method="file://" + sys.argv[1], rank=0,
                   world_size=1)
calls = []
partial = dd.decode_attend_partial
def spy(*a, **k):
    calls.append(tuple(a[0].shape))
    return partial(*a, **k)
def no_kernel(*a, **k):
    raise AssertionError("the sequence-sharded decode took the kernel")
dd.decode_attend_partial = spy
da.decode_attention = no_kernel
attn.decode_route = lambda *a, **k: "kernel"
g = torch.Generator().manual_seed(0)
q = torch.randn(2, 8, 64, generator=g).to(torch.bfloat16)
k, v = (torch.randn(2, 40, 2, 64, generator=g).to(torch.bfloat16)
        for _ in range(2))
pos = torch.arange(40, dtype=torch.int32).expand(2, 40).contiguous()
cur = torch.tensor([30, 39], dtype=torch.int32)
attend = dd.make_distributed_attend_fn(make_host_mesh(1))
got = attend(q, k, v, pos, cur, window=0)
got = got.full_tensor() if hasattr(got, "full_tensor") else got
o, _, l = partial(q, k, v, pos, cur)
want = (o / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)
torch.distributed.destroy_process_group()
print("MESH", json.dumps({"calls": calls,
                          "err": float((got.float() - want.float()).abs().max())}))
"""


def test_sequence_sharded_decode_reaches_the_loop(tmp_path):
    """`make_distributed_attend_fn` (the sequence-sharded mesh decode)
    still runs `decode_attend_partial` on each rank's shard and combines
    the partials, with the route set to the kernel: its LSE combine needs
    the partials, which the kernel does not return (a one-rank gloo group
    in a subprocess: it joins and leaves a process group)."""
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT,
                          str(tmp_path / "rendezvous")], env=_dist_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.split("MESH ", 1)[1])
    assert line["calls"] == [[2, 8, 64]] and line["err"] == 0.0


def _dist_env():
    import os
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return env


def test_decode_entry_on_four_ranks_shards(tmp_path):
    """`sharding.on_shards` runs the decode entry on each of four gloo
    ranks' shards (tests/_torch_decode_mesh_worker.py), as `decode_attend`
    does under a mesh: with 2 kv heads each rank takes its one group of
    the caches, with 4 its own kv head, with 1 the one; the gathered output
    equals the entry on the whole inputs."""
    worker = ROOT / "tests" / "_torch_decode_mesh_worker.py"
    init, out = tmp_path / "rendezvous", tmp_path / "out.json"
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), "4",
                               str(init), str(out)], env=_dist_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for e in errs]
    cases = json.loads(out.read_text())
    assert set(cases) == {"group_of_2", "heads_sharded", "one_kv_head"}
    for name, case in cases.items():
        assert case["row_rel_err"] == 0.0, (name, case)
        assert case["launches"] == 0, (name, case)


_DECODE_MESH_REHEARSAL = r"""
import json, sys, tempfile
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import chip_smoke
import repro_torch.configs as configs
from repro_torch.models import attention
configs.get_config = configs.get_smoke_config
attention.decode_route = lambda *a: "kernel"
with tempfile.TemporaryDirectory() as tmp:
    out = chip_smoke.decode_mesh("cpu", tmp, prompt=24)
print("DECODE_MESH", json.dumps(out, default=str))
"""


def test_chip_smoke_decode_mesh_rehearses_on_cpu():
    """chip_smoke.py's `decode_mesh` at glm4-9b's smoke size on a one-rank
    gloo group (a subprocess: the phase joins and leaves a process group),
    with the route set to the kernel as on a card: both decode steps call
    the entry (its plain version on the CPU) once a layer, the meshed one
    on the DTensors' local shards, and their logits agree."""
    out = subprocess.run([sys.executable, "-c",
                          _DECODE_MESH_REHEARSAL.format(root=str(ROOT))],
                         env=_dist_env(), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.split("DECODE_MESH ", 1)[1])
    layers = get_smoke_config("glm4-9b").num_layers
    assert (line["backend"], line["mesh"]) == ("gloo",
                                               {"data": 1, "model": 1})
    for side in ("plain", "meshed"):
        assert line[f"{side}_routes"] == {"kernel": float(layers),
                                          "loop": 0.0}
        assert line[f"{side}_launches"] == 0
    assert line["logits_row_rel_err"] <= 1e-2


# ---------------------------------------------------------------------------
# The binding and the launch
# ---------------------------------------------------------------------------


def test_binding_reads_the_packed_arguments_in_order(monkeypatch):
    """The C entry unpacks `ARGS` from its int64 array in the wrapper's
    order, and its ctypes signature is (array address, float scale,
    stream)."""
    src = (build.CSRC_DIR / "flash_attention_wgmma.cu").read_text()
    body = src.split('extern "C" cudaError_t repro_decode_attention', 1)[1]
    sig = re.match(r"\(([^)]*)\)", body).group(1)
    assert [s.split()[-1].lstrip("*") for s in sig.split(",")] == \
        ["a", "scale", "stream"]
    read = {int(i): a or b for a, b, i in re.findall(
        r"(?:p\.(\w+)|const int (\w+)) = [^;]*a\[(\d+)\]", body)}
    names = {"pos": "kv_positions", "cur": "cur_pos"}
    assert [names.get(read[i], read[i]) for i in range(len(read))] == \
        list(da.ARGS)
    fn = types.SimpleNamespace()
    monkeypatch.setattr(build, "load", lambda n: types.SimpleNamespace(
        repro_decode_attention=fn))
    assert da._kernel.__wrapped__() is fn
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def _fake_launch(monkeypatch, err=0):
    """CPU tensors through the CUDA branch: the launch records the packed
    arguments in place of calling the kernel."""
    calls = []

    def kernel(ptr, scale, stream):
        n = len(da.ARGS)
        calls.append((list(array.array("q", ctypes.string_at(ptr, 8 * n))),
                      scale, stream))
        return err

    monkeypatch.setattr(da, "_kernel", lambda: kernel)
    monkeypatch.setattr(da, "_raw_stream", lambda: 7)
    monkeypatch.setattr(da.torch.cuda, "current_device", lambda: 0)
    return calls


def test_launch_passes_the_strides_and_the_plan(monkeypatch):
    """q, k and v are read in place: the launch passes each one's strides
    in elements (k and v slices of one tensor), the positions' strides,
    then the plan's d_pad, stages, splits and tiles a split, the window
    and the scale, on the current stream."""
    calls = _fake_launch(monkeypatch)
    q = torch.zeros(2, 1, 16, 128, dtype=BF16)[:, 0]
    kv = torch.zeros(2, 300, 2, 2, 128, dtype=BF16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    pos = torch.zeros(2, 300, dtype=torch.int32)
    cur = torch.zeros(2, dtype=torch.int64)
    out = da._launch(q, k, v, pos, cur, window=64, scale=0.125)
    (args, scale, stream), = calls
    got = dict(zip(da.ARGS, args))
    p = da.decode_plan(2, 300, 16, 2, 128)
    assert [got[n] for n in ("B", "Sc", "H", "G", "D")] == [2, 300, 16, 2,
                                                            128]
    assert [got[n] for n in ("q_b", "q_h")] == [16 * 128, 128]
    assert [got[n] for n in ("k_b", "k_s", "k_h")] == [300 * 512, 512, 128]
    assert [got[n] for n in ("v_b", "v_s", "v_h")] == [300 * 512, 512, 128]
    assert got["k"] == k.data_ptr() and got["v"] == v.data_ptr()
    assert [got[n] for n in ("p_b", "p_s")] == [300, 1]
    assert [got[n] for n in ("d_pad", "stages", "splits", "tiles_per_split",
                             "window")] == [p.d_pad, p.stages, p.splits,
                                            p.tiles_per_split, 64]
    assert got["out"] == out.data_ptr() and out.shape == (2, 16, 128)
    assert got["cur_pos"] != cur.data_ptr()       # int64 taken as int32
    assert scale == 0.125 and stream == 7


def test_split_launch_passes_the_scratch_and_zeroed_counters(monkeypatch):
    calls = _fake_launch(monkeypatch)
    monkeypatch.setattr(da, "_scratch", {})
    q, k, v, pos, cur = _torch(_case(1, 2100, 8, 1, 128, 2100), BF16)
    p = da.decode_plan(1, 2100, 8, 1, 128)
    assert p.splits > 1
    da._launch(q, k, v, pos, cur, window=0, scale=None)
    got = dict(zip(da.ARGS, calls[0][0]))
    ws, counters = da._scratch[q.device]
    assert got["ws"] == ws.data_ptr() and ws.numel() >= p.ws_floats
    assert got["counters"] == counters.data_ptr()
    assert counters.numel() >= p.units and not bool(counters.any())
    assert calls[0][1] == pytest.approx(128 ** -0.5)
    da._launch(q, k, v, pos, cur, window=0, scale=None)   # reused
    assert da._scratch[q.device][0] is ws


def test_launch_error_raises_with_the_plan(monkeypatch):
    """No fallback: a refused launch raises, naming the plan."""
    _fake_launch(monkeypatch, err=1)
    with pytest.raises(RuntimeError, match="decode attention kernel launch "
                       "failed.*splits="):
        da._launch(*_torch(_case(1, 64, 4, 2, 64, 64), BF16), window=0,
                   scale=None)


def test_rows_ready_reads_views_in_place_and_copies_the_rest():
    kv = torch.zeros(2, 10, 2, 4, 64, dtype=BF16)
    k = kv[:, :, 0]
    assert da._rows_ready(k)[0] is k                 # strides of 8 elements
    odd = torch.zeros(2, 10, 4, 68, dtype=BF16)[..., :60]
    fixed, st, ptr = da._rows_ready(odd)             # strides of 68
    assert fixed.is_contiguous() and torch.equal(fixed, odd)
    assert st == fixed.stride() and ptr == fixed.data_ptr()
    q = torch.zeros(3, 1, 8, 64, dtype=BF16)[:, 0]
    assert da._rows_ready(q)[0] is q                 # the decode's q
    last = torch.zeros(2, 10, 64, 4, dtype=BF16).transpose(2, 3)
    assert da._rows_ready(last)[0].is_contiguous()   # D not contiguous
    flat = torch.zeros(2 * 10 * 4 * 64 + 1, dtype=BF16)[1:]
    shifted = flat.view(2, 10, 4, 64)                # a 2-byte offset
    assert da._rows_ready(shifted)[2] % 16 == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's decode phases, rehearsed
# ---------------------------------------------------------------------------


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_decode_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's decode phases on the CPU, where the entry takes its
    plain version (no launch) and the route is the loop: the check's cases
    run and agree, and one decode step of glm4-9b's smoke config counts
    one `loop` a layer."""
    cs = _chip_smoke()
    import repro_torch.configs as configs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    out = cs.decode_attention_check(da, "cpu")
    assert (out["cases"], out["launches"], out["max_abs_err"]) == (22, 0, 0.0)
    monkeypatch.setattr(configs, "get_config", get_smoke_config)
    route = cs.decode_route_share("cpu", batch=2, prompt=16)
    layers = get_smoke_config("glm4-9b").num_layers
    assert route["routes"] == {"kernel": 0.0, "loop": float(layers)}
    assert route["launches"] == 0 and route["finite"]


def test_chip_smoke_row_check_sits_between_sound_and_a_dropped_tile():
    """chip_smoke.py's row check of the decode kernel: 0 for the plain
    version against itself, well under its limit for the same attention
    with P and the output unrounded (float32 inputs, then cast: a rounding
    of P against another max, as the kernel's, is no larger), and far above
    it where `planted_decode_fault` drops one 16-slot tile from every
    row."""
    cs = _chip_smoke()
    q, k, v, pos, cur = _torch(_case(3, 500, 16, 2, 128, 480), BF16)
    want = da.decode_attention_plain(q, k, v, pos, cur)
    assert cs.row_rel_err(want, want) == 0.0
    exact = da.decode_attention_plain(q.float(), k.float(), v.float(), pos,
                                      cur).to(BF16)
    sound = cs.row_rel_err(exact, want)
    dropped = cs.planted_decode_fault(pos)
    assert bool((dropped != pos).any(dim=1).all())
    fault = cs.row_rel_err(da.decode_attention_plain(q, k, v, dropped, cur),
                           want)
    assert 0 < sound < cs.DECODE_REL_TOL / 2 < 5 * cs.DECODE_REL_TOL < fault
    cs.check_decode(want, want, "sound")
    with pytest.raises(AssertionError, match="fault"):
        cs.check_decode(da.decode_attention_plain(q, k, v, dropped, cur),
                        want, "fault")


def test_chip_smoke_serve_path_counts_the_decode_kernel(monkeypatch):
    """chip_smoke.py's `drive_serve_path` resets and reads the decode kernel's
    launches with the probe's kernels, and counts `attn.decode_route` by
    route: with the route set to the kernel as on a card, every decode
    attention call of a smoke RecurrentGemma-2B's serving is counted
    `kernel` (the entry takes its plain version on the CPU: no launch)."""
    cs = _chip_smoke()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rg_lru as lru
    monkeypatch.setattr(attn, "decode_route", lambda *a: "kernel")
    da.decode_attention.launches = 5
    cfg = get_smoke_config("recurrentgemma-2b")
    serve, _, _ = cs.drive_serve_path("cpu", cfg, (mm, fa, lru),
                                      requests=2, prompt=12, new=3, slots=2)
    assert serve["launches"]["decode_attention"] == 0
    local_layers = sum(k == "attention" for k in cfg.block_pattern) * \
        cfg.num_layers // len(cfg.block_pattern)
    assert serve["steps"] >= 1 and serve["decode_routes"] == {
        "kernel": float(serve["steps"] * local_layers), "loop": 0.0}


def test_chip_smoke_row_check_flags_a_zero_row_made_nonzero():
    cs = _chip_smoke()
    want = torch.zeros(2, 4, 8)
    got = want.clone()
    assert cs.row_rel_err(got, want) == 0.0
    got[1, 2, 3] = 1e-3
    assert cs.row_rel_err(got, want) == float("inf")


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,Sc,H,G,D,kept,window,ring", [
    ("glm4-9b.chat", 64, 1288, 32, 2, 128, 1146, 0, False),
    ("glm4-9b.longprompt", 16, 4120, 32, 2, 128, 4078, 0, False),
    ("d256-window-ring", 4, 2048, 10, 1, 256, 2048, 700, True),
], ids=["chat", "longprompt", "d256-window-ring"])
def test_cuda_kernel_matches_plain(name, B, Sc, H, G, D, kept, window, ring):
    _card()
    q, k, v, pos, cur = (t.to("cuda") for t in _torch(
        _case(B, Sc, H, G, D, kept, ring, seed=9), BF16))
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, pos, cur, window=window)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_plain(q, k, v, pos, cur, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.cuda
def test_cuda_fully_masked_rows_are_zero():
    _card()
    q, k, v, pos, cur = (t.to("cuda") for t in _torch(
        _case(3, 300, 32, 2, 128, 250), BF16))
    pos[1] = -1
    pos[2] = cur[2] + 1
    got = da.decode_attention(q, k, v, pos, cur)
    torch.cuda.synchronize()
    assert bool((got[1:] == 0).all()) and bool((got[0] != 0).any())


@pytest.mark.cuda
def test_cuda_one_launch_a_layer_in_a_glm4_decode_step():
    """A glm4-9b decode step (smoke config, bf16 weights) on the card takes
    the kernel once a layer, and `attn.decode_route` says so."""
    _card()
    cfg = get_smoke_config("glm4-9b")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    tokens = torch.randint(1, cfg.vocab_size, (2, 12), dtype=torch.int32,
                           device="cuda")
    state, _ = model.prefill(params, {"tokens": tokens})
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    before = da.decode_attention.launches
    try:
        model.decode_step(params, state, tokens[:, 0])
        torch.cuda.synchronize()
    finally:
        obs_metrics.pop_registry(reg)
    assert da.decode_attention.launches - before == cfg.num_layers
    assert _routes(reg) == {"kernel": float(cfg.num_layers), "loop": 0.0}
