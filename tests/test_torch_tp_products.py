"""Who computes what under tensor parallelism: every product of an
activation with a weight runs on this rank's shard of the weight.

One subprocess joins a fake 8-rank process group (`launch.dryrun.
join_fake_group`) and the (2, 2, 2) ("pod", "data", "model") mesh, on
meta tensors. For each of five architectures at smoke size under the
fsdp_tp plan (glm4-9b: attention and MLP; deepseek-v3-671b: MLA, the
router, the routed and the shared experts; recurrentgemma-2b: the
recurrent block, one kv head; xlstm-350m: both xLSTM cells;
llama-3.2-vision-90b: cross attention) it runs one train step, then one
prefill and one decode step, once on the mesh and once without it. A
`TorchDispatchMode` records the operands of every local `mm`, `bmm`,
`addmm` and `baddbmm`, and follows each param's local tensor through the
ops that take it alone (the ZeRO-3 gather, casts, views, the einsums'
reshapes), so it knows which operand is which weight.

The tests hold each weight that reaches a product to its share: a weight
the rules shard over "model" (a TP dim that the axis divides) enters as
its 1/2 shard, and so do wk and wv where their kv heads divide the axis
(each rank computes the kv heads its attention body reads); every other
weight enters whole. The weights that reach a product are the same on the
mesh as without it, where each enters whole.

The values: four gloo ranks (tests/_torch_tp_worker.py) on the (2, 2)
("data", "model") mesh run one train step and a prefill with two decode
steps of four of the archs (float32 activations), on the mesh and
without it. The loss, grad norm, every first moment and every step's
logits agree within 1e-4 of the plain value's largest magnitude."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_tp_worker.py"
WORLD = 4
VALUE_ARCHS = ("recurrentgemma-2b", "xlstm-350m", "deepseek-v3-671b",
               "llama-3.2-vision-90b")
ARCHS = ("glm4-9b", "deepseek-v3-671b", "recurrentgemma-2b", "xlstm-350m",
         "llama-3.2-vision-90b")

_PROBE = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun as d
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (make_serve_prefill,
                                              make_serve_step,
                                              make_train_step,
                                              train_state_shardings)

    aten = torch.ops.aten
    PRODUCTS = {aten.mm.default: 0, aten.bmm.default: 0,
                aten.addmm.default: 1, aten.baddbmm.default: 1}


    class Products(TorchDispatchMode):
        # {weight: operand numels}: a tensor derived from one weight alone
        # keeps its name
        def __init__(self, seeds):
            super().__init__()
            self.of = {id(t): (name, t) for name, t in seeds.items()}
            self.seen = {}

        def name(self, t):
            entry = self.of.get(id(t))
            return entry[0] if entry is not None and entry[1] is t else None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented  # DTensor's local calls come back
            out = func(*args, **kwargs)
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if any(isinstance(t, FakeTensor) for t in ins):
                return out  # sharding propagation's fake calls
            if func in PRODUCTS:
                lo = PRODUCTS[func]
                for t in args[lo:lo + 2]:
                    n = self.name(t)
                    if n is not None:
                        self.seen.setdefault(n, set()).add(t.numel())
                return out
            names = {self.name(t) for t in ins}
            if len(names) == 1 and None not in names:
                (name,) = names
                for o in tree_leaves(out):
                    if isinstance(o, torch.Tensor):
                        self.of[id(o)] = (name, o)
            return out


    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        return {prefix: tree}


    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")


    def run(model, opt, state, batch, mesh, seeds):
        B = batch["tokens"].shape[0]
        serve_batch = {k: v for k, v in batch.items() if k != "targets"}
        out = {}
        with Products(seeds) as rec:
            make_train_step(model, opt, mesh=mesh)(state, batch)
        out["train"] = rec.seen
        with Products(seeds) as rec:
            st, _ = make_serve_prefill(model, max_len=24, mesh=mesh)(
                state["params"], serve_batch)
            make_serve_step(model, mesh=mesh)(state["params"], st,
                                              meta((B,)))
        out["serve"] = rec.seen
        return {m: {k: sorted(v) for k, v in seen.items()}
                for m, seen in out.items()}


    d.join_fake_group(8)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    result = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch).replace(sharding_plan="fsdp_tp")
        model = build_model(cfg)
        opt = d.make_opt(cfg)
        batch = {"tokens": meta((8, 16)), "targets": meta((8, 16))}
        if cfg.cross_attn_every:
            batch["frontend_embeddings"] = meta(
                (8, cfg.num_frontend_tokens, cfg.frontend_dim),
                torch.bfloat16)
        shard, params, opt_state = train_state_shardings(model, opt, mesh)
        state = {"params": params, "opt": opt_state, "step": meta(())}
        weights = flat(params)
        plain = run(model, opt, state, batch, None, weights)
        placed = sh.distribute(state, shard)
        local = {k: v._local_tensor for k, v in flat(placed["params"]).items()}
        on_mesh = run(model, opt, placed, batch, mesh, local)
        model_dim = mesh.mesh_dim_names.index("model")
        result[arch] = {
            "numel": {k: v.numel() for k, v in weights.items()},
            "tp": sorted(k for k, v in flat(placed["params"]).items()
                         if isinstance(v.placements[model_dim], Shard)),
            "kv_heads": cfg.num_kv_heads,
            "plain": plain, "mesh": on_mesh}
    print("PRODUCTS", json.dumps(result))
"""


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module")
def products():
    code = f"ARCHS = {ARCHS!r}\n" + textwrap.dedent(_PROBE)
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.split("PRODUCTS ", 1)[1].splitlines()[0])


def _split(rec, name: str) -> int:
    """How many ways the model axis splits the weight `name` in its
    products: 2 for a weight the rules shard over "model", and for an
    attention's wk and wv where their kv heads divide the axis; else 1."""
    kv = name.endswith(("/attn/wk", "/attn/wv"))
    if name in rec["tp"] or (kv and rec["kv_heads"] % 2 == 0):
        return 2
    return 1


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_weight_product_runs_on_this_ranks_shard(products, arch,
                                                       mode):
    rec = products[arch]
    plain, mesh = rec["plain"][mode], rec["mesh"][mode]
    # the same weights reach a product with and without the mesh, each
    # whole without it
    assert sorted(mesh) == sorted(plain)
    for name, numels in plain.items():
        assert numels == [rec["numel"][name]], (name, numels)
    want = {name: [rec["numel"][name] // _split(rec, name)] for name in mesh}
    assert mesh == want
    # the case is not vacuous: TP-sharded weights reach products, and
    # (but for recurrentgemma's one kv head) wk and wv split too
    assert sum(_split(rec, n) == 2 for n in mesh) >= 4
    kv_split = [n for n in mesh if n.endswith(("/attn/wk", "/attn/wv"))
                and _split(rec, n) == 2]
    assert bool(kv_split) == (arch in ("glm4-9b", "llama-3.2-vision-90b"))


@pytest.fixture(scope="module")
def values(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(work / "rendezvous"), str(work / "values.json")], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"rank {r} rc {c}:\n{log[-3000:]}" for r, (c, log)
        in enumerate(zip(codes, logs)) if c)
    return json.loads((work / "values.json").read_text())


@pytest.mark.parametrize("arch", VALUE_ARCHS)
def test_the_mesh_step_matches_the_plain_step(values, arch):
    rec = values[arch]
    nonzero = [rec["loss"], rec["grad_norm"], *rec["logits"]]
    assert len(rec["logits"]) == 3 and len(rec["moments"]) > 10
    assert all(size > 0 for _, size in nonzero)
    # a zero moment is a zero gradient (llama's cross-attention gates
    # start at 0), which the mesh must give exactly
    for err, size in nonzero + rec["moments"]:
        assert err <= 1e-4 * size, (arch, err, size)
