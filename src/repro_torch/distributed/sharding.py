"""Logical-axis -> mesh-axis sharding rules (port of
`repro.distributed.sharding`).

Plans:
  tp       : tensor-parallel on the "model" axis; params replicated over data.
  fsdp_tp  : tp + the params' non-TP dim sharded over the data axes (ZeRO-3
             style). Optimizer state inherits the param sharding, so it is
             fully sharded.
  dp       : batch-only parallelism; every param replicated.

Any logical dim whose size is not divisible by its mesh-axis extent falls back
to replication (e.g. 6 attention heads on a 16-way model axis).

A spec is the reference's `PartitionSpec` as a tuple, one entry per tensor
dim: None, an axis name or a tuple of axis names. `spec_for`, `make_rules`
and the `*_shardings` builders read only the mesh's axis names and sizes,
so they take a `DeviceMesh` or a plain {name: size} mapping in mesh-dim
order. `to_placements` turns a spec into DTensor placements, one per mesh
dim; `distribute` puts a tree of tensors on the mesh by a tree of
shardings.

`MESH_OPS` are the DTensor forms of the models' layout-dependent
operations (`models.common.LayoutOps`): the embedding gather
(`embedding_lookup`), the decode cache's slot write (`write_slot`), the
stacking of per-layer caches (`stack`), the attention bodies on each
rank's shards (`on_shards`), a recurrence on each rank's heads
(`on_heads`), the gathered vocab dim of the logits
(`replicate_dim`), every product of an activation with a weight on this
rank's shard of the weight (`project_in`, `project_out`), the MoE
router's count of assignments per expert (`bincount`) and the MoE
dispatch body on each rank's tokens and experts (`experts_on_shards`,
which expert parallelism also runs through). A mesh's train and serve
steps install them. Every op that multiplies by a weight, and every
attention and expert body, runs on local tensors, so how a step's work
splits over the ranks is fixed by this module, not by DTensor's sharding
propagation (which differs between torch releases).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.common import PLAIN_OPS, LayoutOps, tree_map

PyTree = Any
AxisMapping = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisMapping, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh-dim order, of a `DeviceMesh` or of a plain
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec over its axis names (`jax.sharding.NamedSharding`'s
    counterpart)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements, one per mesh dim, for `spec`: Shard(d) on each
    mesh dim named by tensor dim d's entry, Replicate on the rest. A tensor
    dim on several axes shards over them in mesh-dim order (outer first),
    as JAX lays out ("pod", "data")."""
    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh-dim "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def data_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel-ish axes present in the mesh (pod composes as DP)."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_axes_for_plan(mesh, plan: str) -> Tuple[str, ...]:
    """Axes the batch shards over. Under the pure-DP plan the model axis
    carries batch too (otherwise the model-axis ranks replicate compute)."""
    axes = data_axes(mesh)
    if plan == "dp" and "model" in axis_sizes(mesh):
        axes = axes + ("model",)
    return axes


def make_rules(plan: str, mesh) -> dict:
    dp = data_axes(mesh)
    rules = {
        "vocab": "model",
        "embed": None,
        "mlp": "model",
        "mlp2": None,
        "heads": "model",
        "kv_heads": None,     # kv heads < model-axis size for all our GQA archs
        "head_dim": None,
        "experts": "model",
        "expert_mlp": None,
        "layers": None,
        "conv": None,
        None: None,
    }
    if plan == "fsdp_tp":
        rules["embed"] = dp  # ZeRO-3: shard the non-TP dim over data axes
    elif plan == "dp":
        rules = {k: None for k in rules}
    elif plan != "tp":
        raise ValueError(plan)
    return rules


def _extent(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    return math.prod(sizes[a] for a in axes)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], rules: dict,
             mesh) -> Spec:
    """The spec of a tensor of `shape` with logical `axes`, dropping mesh
    axes that don't divide or repeat."""
    sizes = axis_sizes(mesh)
    used: set = set()
    entries: list = []
    for dim, ax in zip(shape, axes):
        mapping: AxisMapping = rules.get(ax, None)
        if mapping is None:
            entries.append(None)
            continue
        maxes = (mapping,) if isinstance(mapping, str) else tuple(mapping)
        maxes = tuple(a for a in maxes if a in sizes and a not in used)
        if not maxes:
            entries.append(None)
            continue
        if dim % _extent(sizes, maxes) != 0:
            # try progressively smaller prefixes of the axis tuple
            ok = None
            for cut in range(len(maxes) - 1, 0, -1):
                if dim % _extent(sizes, maxes[:cut]) == 0:
                    ok = maxes[:cut]
                    break
            if ok is None:
                entries.append(None)
                continue
            maxes = ok
        used.update(maxes)
        entries.append(maxes if len(maxes) > 1 else maxes[0])
    return tuple(entries)


def param_shardings(params: PyTree, axes_tree: PyTree, mesh,
                    plan: str) -> PyTree:
    """A NamedSharding tree matching params (meta or concrete leaves)."""
    rules = make_rules(plan, mesh)
    return tree_map(lambda p, a: NamedSharding(
        mesh, spec_for(p.shape, a, rules, mesh)), params, axes_tree)


def batch_sharding(mesh, ndim: int, batch_dim: int = 0,
                   batch_size: Optional[int] = None,
                   axes: Optional[Tuple[str, ...]] = None) -> NamedSharding:
    sizes = axis_sizes(mesh)
    dp = axes if axes is not None else data_axes(mesh)
    entries: list = [None] * ndim
    # largest axis prefix that divides the batch (e.g. batch 256 on 512
    # ranks under the dp plan -> shard over (pod, data), model replicated)
    while dp:
        if batch_size is None or batch_size % _extent(sizes, dp) == 0:
            entries[batch_dim] = dp if len(dp) > 1 else dp[0]
            break
        dp = dp[:-1]
    return NamedSharding(mesh, tuple(entries))


def batch_shardings(tree: PyTree, mesh,
                    axes: Optional[Tuple[str, ...]] = None) -> PyTree:
    """Shard every leaf of a batch tree along its leading (batch) dim
    (replicated when the batch does not divide the data axes, e.g.
    batch=1)."""
    return tree_map(lambda x: batch_sharding(
        mesh, len(x.shape), batch_size=x.shape[0] if len(x.shape) else None,
        axes=axes), tree)


def decode_state_shardings(state_specs: PyTree, mesh, batch_size: int,
                           seq_shard_threshold: int = 8192) -> PyTree:
    """Shardings for a decode state tree.

    Batch dim -> data axes (when divisible). KV-cache sequence dims with
    extent >= threshold -> "model" axis (the flash-decoding layout of
    `repro_torch.distributed.decode_attention`). Structure-aware: leaves
    under state["layers"]["groups"] carry a leading (layers) dim.
    """
    sizes = axis_sizes(mesh)
    dp = data_axes(mesh)
    dp_size = _extent(sizes, dp) if dp else 1
    dp_entry: AxisMapping = (dp if len(dp) > 1 else dp[0]) if dp else None
    if batch_size % max(dp_size, 1) != 0:
        dp_entry = None  # e.g. long_500k batch=1: replicate over data axes
    model_size = sizes.get("model", 1)

    def one(leaf, batch_dim: int):
        shp = leaf.shape
        nd = len(shp)
        entries: list = [None] * nd
        if nd > batch_dim:
            entries[batch_dim] = dp_entry
        for d in range(batch_dim + 1, nd):
            if shp[d] >= seq_shard_threshold and shp[d] % model_size == 0:
                entries[d] = "model"
                break
        return NamedSharding(mesh, tuple(entries))

    out: dict = {}
    layers = state_specs["layers"]
    out_layers: dict = {}
    for section in ("prefix", "suffix"):
        out_layers[section] = tree_map(lambda l: one(l, 0),
                                       layers.get(section, {}))
    if "groups" in layers:
        out_layers["groups"] = tree_map(lambda l: one(l, 1),
                                        layers["groups"])
    out["layers"] = out_layers
    out["cur"] = NamedSharding(mesh, (dp_entry,))
    for k in state_specs:
        if k not in out:
            out[k] = tree_map(lambda l: one(l, 0), state_specs[k])
    return out


def replicate_dim(x: DTensor, dim: int) -> DTensor:
    """x with tensor dim `dim` whole on every rank: a mesh dim that shards
    it, or holds a pending reduction, is made Replicate; the rest keep
    their placements. A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    keep = [Replicate() if p.is_partial() or (isinstance(p, Shard)
                                             and p.dim == dim) else p
            for p in x.placements]
    return x.redistribute(x.device_mesh, keep)


def local_shard(x: torch.Tensor, mesh, placements,
                grad=None) -> torch.Tensor:
    """This rank's part of x with `placements` on `mesh`, its gradient
    arriving with the placements `grad` (default: `placements`); a plain
    tensor is taken as replicated (the same values on every rank)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements).to_local(grad_placements=grad)


def embedding_lookup(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """table[tokens] for a DTensor table [V, d], laid out as the tokens'
    batch shards (tokens [B, ...]; a plain tensor is taken as replicated).
    Each rank gathers its own tokens' rows from the whole table: the
    backward of `aten.index` is `aten.index_put`, whose sharding rule
    fails in some torch releases (2.11: "Shard dim -1 ... must be
    normalized"). The table's gradient is a partial sum over the ranks
    that hold different tokens, reduced back onto the table's shards."""
    mesh = table.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in getattr(tokens, "placements", [Replicate()] * mesh.ndim)]
    local = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(p, Shard) else Replicate()
                         for p in rows])
    return DTensor.from_local(local[local_shard(tokens, mesh, rows)], mesh,
                              rows, run_check=False)


def stack(xs) -> torch.Tensor:
    """torch.stack(xs) along a new leading dim; DTensors on each rank's
    shards (each laid out as xs[0] first): `aten.stack`'s sharding rule
    fails in some torch releases (2.11: "list index out of range" on 40
    replicated caches). Other tensors (the meta tensors of an abstract
    init, caches the model made itself) stack as on one device."""
    if not isinstance(xs[0], DTensor):
        return PLAIN_OPS.stack(xs)
    mesh, placements = xs[0].device_mesh, xs[0].placements
    local = torch.stack([x.redistribute(mesh, placements).to_local()
                         for x in xs])
    return DTensor.from_local(
        local, mesh, [Shard(p.dim + 1) if isinstance(p, Shard) else p
                      for p in placements], run_check=False)


def on_shards(fn, q: DTensor, k: DTensor, v: DTensor, rows=(),
              q_heads: int = 2, **kw) -> DTensor:
    """fn(q, k, v, *rows, **kw) on each rank's shards of DTensor inputs (a
    mesh's train or serve step), its output [B, ..., H, Dv] a DTensor laid
    out as q. q keeps the mesh dims that shard its batch dim (0) or its
    heads dim (`q_heads`) where each rank's query heads then meet whole kv
    groups: where the kv heads divide the mesh dim, k and v shard their kv
    heads (dim 2) alike; where the mesh dim is a multiple of the kv heads
    (glm4-9b's 2 on 16), each rank's query heads lie in one group, and it
    takes that group of k and v (their gradients partial over the ranks).
    Every other mesh dim is replicated, and k, v and `rows` ([B, ...]:
    positions) follow q's batch dims. A layout choice: the chunked einsums
    fold the batch and head dims into one, and DTensor's planner takes
    minutes an op on such a dim sharded over three mesh axes. Plain inputs
    (tensors the model made itself) go to fn as they are."""
    if not isinstance(q, DTensor):
        return PLAIN_OPS.on_shards(fn, q, k, v, rows, q_heads, **kw)
    mesh = q.device_mesh
    G = k.shape[2]
    qp, kvp, kv_grad, rowp = [], [], [], []
    group = None  # (mesh dim, its ranks a kv group spans)
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        batch = isinstance(p, Shard) and p.dim == 0
        heads = (isinstance(p, Shard) and p.dim == q_heads
                 and (G % n == 0 or (n % G == 0 and group is None)))
        qp.append(p if batch or heads else Replicate())
        if heads and G % n:
            group = (i, n // G)
            kvp.append(Replicate())
            kv_grad.append(Partial())
        else:
            kvp.append(p if batch else Shard(2) if heads else Replicate())
            kv_grad.append(kvp[-1])
        rowp.append(p if batch else Replicate())

    k_l, v_l = (local_shard(t, mesh, kvp, kv_grad) for t in (k, v))
    if group is not None:
        i, span = group
        g = mesh.get_coordinate()[i] // span
        k_l, v_l = k_l[:, :, g:g + 1], v_l[:, :, g:g + 1]
    out = fn(local_shard(q, mesh, qp), k_l, v_l,
             *(local_shard(r, mesh, rowp) for r in rows), **kw)
    return DTensor.from_local(out, mesh, qp, run_check=False)


def on_heads(fn, acts, weights, n_heads: int, head_dims=None,
             out_head_dims=None):
    """fn(*acts, *weights) on each rank's shards (the xLSTM cells' bodies):
    the acts keep the mesh dims that shard the first DTensor act's batch
    dim (0); on the TP axis, where the heads divide it, each act takes its
    shard of its heads dim (`head_dims`, default the last) and the weights
    [n_heads, ...] theirs of dim 0; every other mesh dim is replicated.
    fn's outputs leave as DTensors laid out alike (`out_head_dims`); the
    weights' gradients are partial over the batch shards. A step over the
    sequence runs as local ops, none of which needs a DTensor rule (torch
    2.13 has none for `log_sigmoid_backward`). Plain inputs go to fn as
    they are."""
    lead = next((a for a in acts if isinstance(a, DTensor)), None)
    if lead is None:
        return PLAIN_OPS.on_heads(fn, acts, weights, n_heads)
    mesh = lead.device_mesh
    batch = _mesh_dims(mesh, lead.placements, 0)
    tp = _tp_mesh_dim(mesh)
    heads = tp is not None and tp not in batch and \
        n_heads % mesh.size(tp) == 0

    def places(heads_dim, on_batch, on_tp):
        return [on_batch if i in batch else on_tp(heads_dim)
                if heads and i == tp else Replicate()
                for i in range(mesh.ndim)]

    def act_places(t, dims, j):
        return places(t.dim() - 1 if dims is None else dims[j] % t.dim(),
                      Shard(0), Shard)

    outs = fn(*(local_shard(a, mesh, act_places(a, head_dims, j))
                for j, a in enumerate(acts)),
              *(local_shard(w, mesh, places(0, Replicate(), Shard),
                            places(0, Partial(), Shard)) for w in weights))
    return tuple(DTensor.from_local(o, mesh, act_places(o, out_head_dims, j),
                                    run_check=False)
                 for j, o in enumerate(outs))


def write_slot(cache: DTensor, slot: torch.Tensor,
               value: torch.Tensor) -> DTensor:
    """A copy of the DTensor `cache` [B, Sc, ...] with row b's slot[b]
    set to value[b]: the advanced-index write of a decode step, which has
    no DTensor sharding rule. Only the rank whose shard holds (b, slot[b])
    writes it; placements other than a shard of the batch or the sequence
    dim are first replicated. A plain cache (one the model made itself,
    such as a prefill's positions) is written as on one device."""
    if not isinstance(cache, DTensor):
        return PLAIN_OPS.write_slot(cache, slot, value)
    mesh = cache.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
            for p in cache.placements]
    cache = cache.redistribute(mesh, keep)
    rows = [p if p == Shard(0) else Replicate() for p in keep]

    local = cache.to_local().clone()
    # this shard's first sequence slot: the mesh dims that shard dim 1
    # split it in turn, outer first, into chunks of ceil(size / k)
    lo, size, coord = 0, cache.shape[1], mesh.get_coordinate()
    for i, p in enumerate(keep):
        if p == Shard(1):
            size = -(-size // mesh.size(i))
            lo += coord[i] * size
    n = local.shape[1]
    slot_l = local_shard(slot, mesh, rows).long()
    val_l = local_shard(value, mesh, rows).to(local.dtype)
    inside = (slot_l >= lo) & (slot_l < lo + n)
    b = torch.arange(local.shape[0], device=local.device)
    at = torch.where(inside, slot_l - lo, 0)
    mask = inside.reshape(-1, *([1] * (val_l.dim() - 1)))
    local[b, at] = torch.where(mask, val_l, local[b, at])
    return DTensor.from_local(local, mesh, keep, run_check=False,
                              shape=cache.shape, stride=cache.stride())


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending reductions (`Partial`, the output of a
    row-parallel product) carried out to `Replicate`, the other
    placements kept. A layout choice: left pending, the residual add
    after it has DTensor choose a reduce-scatter onto the sequence dim,
    and the next product's fold of that dim with the batch dim makes a
    `_StridedShard`, on which DTensor's planner takes minutes an op on a
    ("pod", "data", "model") mesh. A plain tensor as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _labels(eq: Optional[str], x: torch.Tensor) -> Tuple[str, str, str]:
    """The einsum labels (x's, w's, the output's) of torch.einsum(eq, x, w),
    or of torch.matmul(x, w) for a 2-D w when eq is None."""
    if eq is None:
        batch = "abcdefgh"[:x.dim() - 1]
        return batch + "k", "kn", batch + "n"
    ins, out = eq.replace(" ", "").split("->")
    xl, wl = ins.split(",")
    return xl, wl, out


def _tp_mesh_dim(mesh) -> Optional[int]:
    """The mesh dim of the tensor-parallel axis: the hints' where a step
    set some, else "model"; None where the mesh has no such axis."""
    from repro_torch.distributed.act_sharding import current
    h = current()
    name = h.tp if h is not None else "model"
    names = list(mesh.mesh_dim_names)
    return names.index(name) if name in names else None


def _project(x, w, eq: Optional[str], contracted: bool,
             split: Optional[str] = None):
    """The product of x with the weight w on this rank's shards, the
    output a DTensor (or, for plain x and w, the one-device product).

    On the tensor-parallel mesh dim, w keeps its shard of its TP dim (the
    weight's placement, which the rules give where the dim divides the
    axis); x is made whole there, or cut to the same shard where the dim
    is also x's; the output is sharded on that dim where it keeps it, else
    a `Partial` sum. A w whole on that dim (a weight with no TP dim, kv
    heads) is multiplied whole on every model rank, unless the caller
    names its label `split`: then each rank takes its shard of that dim
    where the dim divides the axis (a local cut), and else its share of
    x's first batch dim that divides it (the batch, else the sequence),
    the output gathered whole over the axis (one all-gather; the
    reference's layout of k and v, at 1/n of the work). On every other
    mesh dim, w is gathered whole (an fsdp shard of its embed dim, if the
    ZeRO-3 hook has not gathered it), and x keeps its shard of a batch
    dim (a label of x and the output, not of w) and is made whole on any
    other. `contracted` says which the caller expects of the TP dim; a
    weight laid out otherwise raises.

    The local tensors carry the gradient placements autograd needs: x's
    partial over the model ranks where it was made whole for a
    column-parallel product, w's partial over the ranks that hold
    different rows of x."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return PLAIN_OPS.project_in(x, w, eq)
    mesh = (w if isinstance(w, DTensor) else x).device_mesh
    # a pending reduction of x (a mean's `Partial(avg)` from DTensor's own
    # rules) is carried out first: the gradient's `Partial(sum)` cannot be
    # redistributed back onto an average
    x = settle(x)
    xl, wl, ol = _labels(eq, x)
    tp = _tp_mesh_dim(mesh)
    rep = [Replicate()] * mesh.ndim
    x_now = list(x.placements) if isinstance(x, DTensor) else list(rep)
    w_now = list(w.placements) if isinstance(w, DTensor) else list(rep)
    rows = None
    if tp is not None and split is not None and \
            not isinstance(w_now[tp], Shard):
        n = mesh.size(tp)
        if w.shape[wl.index(split)] % n == 0:
            w_now[tp] = Shard(wl.index(split))
        elif not isinstance(x_now[tp], Shard):
            rows = next((d for d, c in enumerate(xl) if c in ol
                         and c not in wl and x.shape[d] % (n * math.prod(
                             mesh.size(i) for i in _mesh_dims(mesh, x_now,
                                                              d))) == 0),
                        None)
            if rows is not None:
                x_now[tp] = Shard(rows)
    xp, xg, wp, wg, op = [], [], [], [], []
    for i in range(mesh.ndim):
        pw, px = w_now[i], x_now[i]
        if i == tp and type(pw) is Shard:
            t = wl[pw.dim]
            if (t not in ol) != contracted:
                raise ValueError(
                    f"the weight's TP dim {t!r} of {eq or 'matmul'} is "
                    f"{'kept' if t in ol else 'contracted'}: use "
                    f"project_{'in' if t in ol else 'out'}")
            wp.append(pw)
            wg.append(pw)
            if t in xl:
                xp.append(Shard(xl.index(t)))
                xg.append(xp[-1])
            else:
                xp.append(Replicate())
                xg.append(Partial())
            op.append(Shard(ol.index(t)) if t in ol else Partial())
        elif type(px) is Shard and xl[px.dim] in ol and xl[px.dim] not in wl:
            xp.append(px)
            xg.append(px)
            wp.append(Replicate())
            wg.append(Partial())
            op.append(Shard(ol.index(xl[px.dim])))
        else:
            xp.append(Replicate())
            xg.append(Replicate())
            wp.append(Replicate())
            wg.append(Replicate())
            op.append(Replicate())
    y = PLAIN_OPS.project_in(local_shard(x, mesh, xp, xg),
                             local_shard(w, mesh, wp, wg), eq)
    out = DTensor.from_local(y, mesh, op, run_check=False)
    if rows is not None:
        op[tp] = Replicate()
        out = out.redistribute(mesh, op)
    return out


def project_in(x, w, eq: Optional[str] = None,
               split: Optional[str] = None):
    """`LayoutOps.project_in` under a mesh: a column-parallel product (or
    one batched over the weight's TP dim) on this rank's shard of w, its
    output sharded over the TP axis on that dim (`_project`)."""
    return _project(x, w, eq, contracted=False, split=split)


def project_out(x, w, eq: Optional[str] = None):
    """`LayoutOps.project_out` under a mesh: a row-parallel product on
    this rank's shards of x and w, the partial sums settled (`settle`:
    one all-reduce over the TP axis)."""
    return settle(_project(x, w, eq, contracted=True))


def _mesh_dims(mesh, placements, dim: int) -> list:
    """The mesh dims whose placement shards tensor dim `dim`."""
    return [i for i, p in enumerate(placements)
            if type(p) is Shard and p.dim == dim]


def _linear_coordinate(mesh, dims) -> int:
    """This rank's block index along the mesh dims `dims`, outer first
    (the order in which Shard(d) over several mesh dims lays out dim d)."""
    coord, out = mesh.get_coordinate(), 0
    for i in dims:
        out = out * mesh.size(i) + coord[i]
    return out


def bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """float32 [n], how often each of 0..n-1 occurs in the DTensor ids:
    each rank counts its shard of the leading dim (DTensor has no sharding
    rule for `aten.bincount`, and the count has no meta kernel), the
    partial counts are summed into a replicated DTensor. A plain ids is
    counted as on one device."""
    if not isinstance(ids, DTensor):
        return PLAIN_OPS.bincount(ids, n)
    mesh = ids.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in ids.placements]
    local = PLAIN_OPS.bincount(local_shard(ids, mesh, rows), n)
    return DTensor.from_local(
        local, mesh, [Partial() if isinstance(p, Shard) else Replicate()
                      for p in rows], run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def experts_on_shards(fn, xf, weights, idx, wi, wg, wo, *, mesh=None,
                      token_axes: Optional[Tuple[str, ...]] = None,
                      expert_axes: Optional[Tuple[str, ...]] = None,
                      in_order: bool = True):
    """The MoE dispatch body fn(xf, weights, idx, wi, wg, wo, shard_id,
    E_loc, offset) -> [T_loc, d] on each rank's tokens and experts (the
    reference's `shard_map` of expert parallelism, and the mesh form of
    the scatter path).

    Tokens xf [T, d], routing weights and ids [T, k] go to the rank as its
    shard of dim 0 over `token_axes` (default: the mesh dims that shard
    xf's dim 0); the expert weights wi/wg [E, d, f] and wo [E, f, d] as
    their shard of the experts dim over `expert_axes` (default: the mesh
    dims that shard wi's dim 0; none where they do not divide E), every
    other dim whole: an fsdp-sharded embed dim is all-gathered over the
    data axes here (ZeRO-3), unless the step's hook already gathered it.
    A mesh dim on both lists keeps the experts and replicates the tokens.
    shard_id is the rank's block index along the expert axes, E_loc =
    E / their size. With `in_order`, `offset` [E] counts each expert's
    assignments from the tokens of the blocks before this rank's (a
    capacity in the global token order, as on one device); else None.

    The body's output, a partial sum over this rank's experts, leaves as a
    DTensor `Partial` on the expert axes and is redistributed to xf's
    placements: one all-reduce. Each local input carries the gradient
    placements autograd needs: the tokens' and routing weights' partial
    over the expert axes, the weights' partial over the token axes. Plain
    inputs are taken as replicated (the same values on every rank), and
    then the result is a plain tensor."""
    mesh = mesh if mesh is not None else xf.device_mesh
    names = list(mesh.mesh_dim_names)
    if expert_axes is not None:
        exp = sorted(names.index(a) for a in expert_axes)
    elif isinstance(wi, DTensor):
        exp = _mesh_dims(mesh, wi.placements, 0)
    else:
        exp = []
    E = wi.shape[0]
    if E % math.prod(mesh.size(i) for i in exp):
        exp = []
    if token_axes is not None:
        tok = sorted(names.index(a) for a in token_axes)
    elif isinstance(xf, DTensor):
        tok = _mesh_dims(mesh, xf.placements, 0)
    else:
        tok = []
    tok = [i for i in tok if i not in exp]

    def places(on_tok, on_exp):
        return [on_tok if i in tok else on_exp if i in exp else Replicate()
                for i in range(mesh.ndim)]

    rows, rows_grad = places(Shard(0), Replicate()), places(Shard(0),
                                                            Partial())
    w_place, w_grad = places(Replicate(), Shard(0)), places(Partial(),
                                                            Shard(0))
    x_l = local_shard(xf, mesh, rows, rows_grad)
    idx_l = local_shard(idx, mesh, rows)
    offset = None
    if in_order and tok:
        counts = DTensor.from_local(
            PLAIN_OPS.bincount(idx_l, E)[None], mesh,
            places(Shard(0), Replicate()), run_check=False).full_tensor()
        offset = counts[:_linear_coordinate(mesh, tok)].sum(0).long()
    y = fn(x_l, local_shard(weights, mesh, rows, rows_grad), idx_l,
           local_shard(wi, mesh, w_place, w_grad),
           None if wg is None else local_shard(wg, mesh, w_place, w_grad),
           local_shard(wo, mesh, w_place, w_grad),
           _linear_coordinate(mesh, exp),
           E // math.prod(mesh.size(i) for i in exp), offset)
    out = DTensor.from_local(y, mesh, rows_grad, run_check=False,
                             shape=xf.shape, stride=xf.stride())
    if isinstance(xf, DTensor):
        return out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                       for p in xf.placements])
    return out.full_tensor()


def _experts_form(fn, xf, weights, idx, wi, wg, wo, in_order=True,
                  expert_axes=None):
    """`LayoutOps.experts` under a mesh: DTensor tokens through
    `experts_on_shards`, plain ones (a model's own tensors) as on one
    device."""
    if not isinstance(xf, DTensor):
        return PLAIN_OPS.experts(fn, xf, weights, idx, wi, wg, wo)
    return experts_on_shards(fn, xf, weights, idx, wi, wg, wo,
                             expert_axes=expert_axes, in_order=in_order)


# The models' layout-dependent operations on a mesh's DTensors, installed
# by the train and serve steps under a mesh (`models.common.use_layout`).
MESH_OPS = LayoutOps(take_rows=embedding_lookup, write_slot=write_slot,
                     stack=stack, on_shards=on_shards, on_heads=on_heads,
                     whole_dim=replicate_dim, project_in=project_in,
                     project_out=project_out, bincount=bincount,
                     experts=_experts_form)


def distribute(tree: PyTree, shardings: PyTree) -> PyTree:
    """Each leaf on its sharding's mesh with its placements: a DTensor is
    redistributed; a plain tensor, which must hold the same values on every
    rank (the same seed, data or file), is split locally, with no
    communication and, where a rank keeps the whole tensor, no copy."""
    def one(x: torch.Tensor, s: NamedSharding):
        if isinstance(x, DTensor):
            return x.redistribute(s.mesh, s.placements)
        return distribute_tensor(x, s.mesh, s.placements,
                                 src_data_rank=None)
    return tree_map(one, tree, shardings)
