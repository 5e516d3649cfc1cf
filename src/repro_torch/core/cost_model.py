"""The cost model C() and the pluggable `CostModel` interface (PyTorch port
of `repro.core.cost_model`).

Paper §4.2: "the representative one used in Ansor, which is an MLP with two
hidden layers, with 512 neurons for each. We train the MLP cost model with
ranking loss". Params stay a flat mapping of tensors with the reference's
keys (`w0, b0, w1, b1, w2, b2`), because the lottery-ticket machinery
(core/lottery.py, core/adaptation.py) masks raw parameter updates by name;
Adam is implemented locally for the same reason.

Labels are per-task-normalized throughputs (Ansor convention); the pairwise
logistic ranking loss compares records within the same task.

Differences from the reference, all in idiom rather than arithmetic:
  * `jax.random` keys become `torch.Generator`s. Pair indices are drawn with
    `torch.randint`, so they differ from JAX's; `pairwise_rank_loss` and
    `train_step` take explicit `pairs=(ii, jj)` so a test can hand them the
    indices JAX drew.
  * Parameter initialization draws on a CPU generator and then moves to the
    model's `torch_device`, so a seed gives the same params on every device.
  * Scoring needs no shape buckets: eager PyTorch compiles nothing per batch
    length, so `batched_predict` is `predict` (rows are independent). The
    buckets stay for training batches, where padding decides which pairs
    `pairwise_rank_loss` samples.
"""
from __future__ import annotations

import abc
import dataclasses
import json
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.moses import CostModelConfig
from repro_torch.core.placement import TorchDevice, resolve_torch_device

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]
Pairs = Tuple[Any, Any]


def as_generator(rng: Union[int, torch.Generator]) -> torch.Generator:
    """An int seed becomes a fresh CPU generator; generators pass through."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def params_device(params: Params) -> torch.device:
    return next(iter(params.values())).device


def init_mlp_params(cfg: CostModelConfig, rng: Union[int, torch.Generator],
                    torch_device: TorchDevice = "cuda") -> Params:
    dev = resolve_torch_device(torch_device)
    gen = as_generator(rng)
    dims = (cfg.feature_dim, *cfg.hidden_dims, 1)
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((din, dout), generator=gen) * (1.0 / np.sqrt(din))
        params[f"w{i}"] = w.to(dev)
        params[f"b{i}"] = torch.zeros((dout,), device=dev)
    return params


def mlp_forward(params: Params, x: torch.Tensor, return_hidden: bool = False):
    """x: [B, F] -> scores [B]. Optionally returns the last hidden layer
    (used by the adversarial domain discriminator, Eq. 6)."""
    n_layers = len([k for k in params if k.startswith("w")])
    h = x
    hidden = None
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
            hidden = h
    score = h[..., 0]
    if return_hidden:
        return score, hidden
    return score


def sample_pairs(batch_len: int, n_pairs: int, generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform pair indices in [0, batch_len), on the generator's device."""
    ii = torch.randint(0, batch_len, (n_pairs,), generator=generator,
                       device=generator.device)
    jj = torch.randint(0, batch_len, (n_pairs,), generator=generator,
                       device=generator.device)
    return ii, jj


def pairwise_rank_loss(scores: torch.Tensor, labels: torch.Tensor,
                       group_ids: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       n_pairs: int = 2048,
                       valid: Optional[torch.Tensor] = None,
                       pairs: Optional[Pairs] = None) -> torch.Tensor:
    """Pairwise logistic ranking loss within task groups.

    scores/labels: [B]; group_ids: [B] int (task index of each record);
    valid: optional [B] {0,1} mask — padded rows (from bucket-padded batches)
    carry 0 and never contribute a pair. `pairs` gives the sampled (ii, jj)
    explicitly; otherwise `n_pairs` are drawn from `generator`.
    """
    if pairs is None:
        ii, jj = sample_pairs(scores.shape[0], n_pairs, generator)
    else:  # host-side integer arrays, e.g. the indices JAX drew
        ii, jj = (torch.tensor(np.asarray(p), dtype=torch.long)
                  for p in pairs)
    ii, jj = ii.to(scores.device), jj.to(scores.device)
    if valid is not None:
        # bucket padding appends pad rows at the END (see Records.batches /
        # pad_rows); fold sampled indices onto the real prefix so the full
        # n_pairs budget lands on real rows (as the reference does)
        n_real = valid.to(torch.long).sum().clamp_min(1)
        ii = ii % n_real
        jj = jj % n_real
    same = (group_ids[ii] == group_ids[jj]) & (ii != jj)
    sign = torch.sign(labels[ii] - labels[jj])
    margin = (scores[ii] - scores[jj]) * sign
    per_pair = F.softplus(-margin)
    w = same.to(torch.float32) * (sign != 0)
    if valid is not None:
        w = w * valid[ii] * valid[jj]
    return (per_pair * w).sum() / w.sum().clamp_min(1.0)


def mse_loss(scores: torch.Tensor, labels: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    err = torch.square(scores - labels)
    if valid is not None:
        return (err * valid).sum() / valid.sum().clamp_min(1.0)
    return err.mean()


def model_loss(params: Params, batch: Batch,
               generator: Optional[torch.Generator],
               loss_kind: str = "rank", n_pairs: int = 2048,
               forward: Optional[Callable] = None,
               pairs: Optional[Pairs] = None) -> torch.Tensor:
    fwd = forward if forward is not None else mlp_forward
    scores = fwd(params, batch["x"])
    valid = batch.get("m")
    if loss_kind == "rank":
        return pairwise_rank_loss(scores, batch["y"], batch["g"], generator,
                                  n_pairs, valid=valid, pairs=pairs)
    return mse_loss(scores, batch["y"], valid=valid)


# ---------------------------------------------------------------------------
# Shape buckets: training batches are padded to a few fixed sizes exactly as
# in the reference, because the padded length decides which pairs
# `pairwise_rank_loss` samples (indices are drawn over the padded length and
# folded onto the real prefix).
# ---------------------------------------------------------------------------

SHAPE_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_size(n: int) -> int:
    """Smallest bucket >= n (multiples of the largest bucket past the end)."""
    for b in SHAPE_BUCKETS:
        if n <= b:
            return b
    top = SHAPE_BUCKETS[-1]
    return ((n + top - 1) // top) * top


def pad_rows(x: np.ndarray, n_to: int) -> np.ndarray:
    """Zero-pad a [N, ...] array to [n_to, ...] rows."""
    if len(x) == n_to:
        return x
    pad = np.zeros((n_to - len(x),) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad])


# ---------------------------------------------------------------------------
# Dataset containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Records:
    """A set of measured program records (the paper's S / T-hat)."""
    x: np.ndarray           # [N, F] features
    y: np.ndarray           # [N] per-task-normalized throughput
    g: np.ndarray           # [N] task group id
    raw_throughput: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.x)

    @staticmethod
    def concat(rs: List["Records"]) -> "Records":
        """The non-empty sets stacked in order (raw throughputs dropped, as
        in the reference)."""
        rs = [r for r in rs if len(r)]
        return Records(
            np.concatenate([r.x for r in rs]),
            np.concatenate([r.y for r in rs]),
            np.concatenate([r.g for r in rs]),
        )

    def batches(self, batch_size: int, rng: np.random.RandomState,
                pad: bool = False, torch_device: TorchDevice = "cpu"
                ) -> Iterator[Batch]:
        """Shuffled minibatches as tensors on `torch_device`. With pad=True
        each batch is zero-padded to a bucket length (see SHAPE_BUCKETS) and
        carries an "m" {0,1} mask (padded rows get group id -1 and mask 0).
        The shuffle is the reference's numpy permutation."""
        idx = rng.permutation(len(self.x))
        for s in range(0, len(idx), batch_size):
            sel = idx[s: s + batch_size]
            x, y, g = self.x[sel], self.y[sel], self.g[sel]
            m = np.ones(len(sel), np.float32)
            if pad:
                b = bucket_size(len(sel))
                x, y, m = pad_rows(x, b), pad_rows(y, b), pad_rows(m, b)
                g = np.concatenate(
                    [g, np.full(b - len(sel), -1, g.dtype)])
            yield {k: torch.as_tensor(v, device=torch_device)
                   for k, v in (("x", x), ("y", y), ("g", g), ("m", m))}


class RecordsBuilder:
    """Incremental `Records` accumulator for the online tuning loop: feature
    rows are appended once per measurement and only the per-task normalized
    labels are re-derived on `snapshot()`."""

    def __init__(self):
        self._x: List[np.ndarray] = []
        self._raw: List[float] = []
        self._g: List[int] = []

    def __len__(self) -> int:
        return len(self._x)

    def append(self, feats: np.ndarray, raw_throughput: float,
               group: int = 0) -> None:
        """Add one measured record: its feature row and raw throughput."""
        self._x.append(np.asarray(feats, np.float32))
        self._raw.append(float(raw_throughput))
        self._g.append(int(group))

    def snapshot(self) -> Records:
        """Materialize a `Records` view with fresh per-task normalization."""
        if not self._x:
            raise ValueError("snapshot() of an empty builder")
        raw = np.asarray(self._raw, np.float32)
        g = np.asarray(self._g, np.int32)
        return Records(x=np.stack(self._x), y=normalize_per_task(raw, g),
                       g=g, raw_throughput=raw)


def normalize_per_task(raw: np.ndarray, groups: np.ndarray) -> np.ndarray:
    y = np.zeros_like(raw, dtype=np.float32)
    for g in np.unique(groups):
        m = groups == g
        top = raw[m].max()
        y[m] = raw[m] / max(top, 1e-12)
    return y


# ---------------------------------------------------------------------------
# Plain training (pre-training on the source-device dataset; also the
# Ansor-Random / Tenset-Finetune baselines' update path)
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    m: Params
    v: Params
    count: int


def adam_init(params: Params) -> AdamState:
    return AdamState({k: torch.zeros_like(p) for k, p in params.items()},
                     {k: torch.zeros_like(p) for k, p in params.items()}, 0)


def adam_moments(grads: Params, state: AdamState, b1: float = 0.9,
                 b2: float = 0.999) -> Tuple[AdamState, float, float]:
    """New first/second moments and the bias corrections for step `count`.

    The corrections are computed in float32 as the reference computes
    `1 - b ** count.astype(float32)`."""
    count = state.count + 1
    m = {k: b1 * state.m[k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state.v[k] + (1 - b2) * g * g for k, g in grads.items()}
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    return AdamState(m, v, count), bc1, bc2


@torch.no_grad()
def adam_update(grads: Params, state: AdamState, params: Params,
                lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> Tuple[Params, AdamState]:
    """One Adam step with bias correction by `count`; returns new tensors
    (params passed in are never modified)."""
    new_state, bc1, bc2 = adam_moments(grads, state, b1, b2)
    new_params = {
        k: p - lr * (new_state.m[k] / bc1)
        / (torch.sqrt(new_state.v[k] / bc2) + eps)
        for k, p in params.items()}
    return new_params, new_state


def loss_and_grad(fn: Callable[[Params], torch.Tensor], params: Params
                  ) -> Tuple[torch.Tensor, Params]:
    """`jax.value_and_grad` over a flat param mapping."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(params: Params, opt: AdamState, batch: Batch,
               cfg: CostModelConfig, lr: float,
               generator: Optional[torch.Generator] = None,
               forward: Optional[Callable] = None,
               pairs: Optional[Pairs] = None
               ) -> Tuple[Params, AdamState, torch.Tensor]:
    """Loss, gradient and one Adam step on one batch."""
    loss, grads = loss_and_grad(
        lambda p: model_loss(p, batch, generator, cfg.loss,
                             cfg.rank_pairs_per_batch, forward, pairs),
        params)
    params, opt = adam_update(grads, opt, params, lr=lr)
    return params, opt, loss


def train_cost_model(params: Params, records: Records, cfg: CostModelConfig,
                     epochs: Optional[int] = None, lr: Optional[float] = None,
                     seed: int = 0, pad: bool = False,
                     forward: Optional[Callable] = None
                     ) -> Tuple[Params, List[float]]:
    """Vanilla full-parameter training (pre-training & baseline fine-tuning)
    on the device the params live on.

    pad=True bucket-pads minibatches (see Records.batches), as the online
    update path of the reference does. `forward` swaps the scoring network
    (defaults to the paper's MLP).
    """
    dev = params_device(params)
    rng_np = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt = adam_init(params)
    lr = lr if lr is not None else cfg.lr
    losses = []
    for _ in range(epochs if epochs is not None else cfg.max_epochs):
        ep_loss = torch.zeros((), device=dev)
        nb = 0
        for batch in records.batches(cfg.batch_size, rng_np, pad=pad,
                                     torch_device=dev):
            params, opt, loss = train_step(params, opt, batch, cfg, lr, gen,
                                           forward)
            ep_loss += loss
            nb += 1
        losses.append(float(ep_loss) / max(nb, 1))
    return params, losses


@torch.no_grad()
def predict(params: Params, x: np.ndarray,
            forward: Optional[Callable] = None) -> np.ndarray:
    """Scores [N] for features [N, F], computed where the params live."""
    x = np.asarray(x, np.float32)
    if len(x) == 0:
        return np.zeros((0,), np.float32)
    fwd = forward if forward is not None else mlp_forward
    xt = torch.as_tensor(x, device=params_device(params))
    return fwd(params, xt).cpu().numpy()


# eager PyTorch needs no per-length recompilation guard (see module doc)
batched_predict = predict


def rank_correlation(params: Params, records: Records,
                     predict_fn: Callable = None) -> float:
    """Mean per-task Spearman-like rank agreement (top-1 regret proxy).

    `predict_fn` defaults to the MLP scoring path; pass
    `cost_model.predict` to evaluate another registered model family."""
    scores = (predict_fn or predict)(params, records.x)
    taus = []
    for g in np.unique(records.g):
        m = records.g == g
        if m.sum() < 3:
            continue
        s, y = scores[m], records.y[m]
        rs = np.argsort(np.argsort(s)).astype(np.float64)
        ry = np.argsort(np.argsort(y)).astype(np.float64)
        c = np.corrcoef(rs, ry)[0, 1]
        if np.isfinite(c):
            taus.append(c)
    return float(np.mean(taus)) if taus else 0.0


def pairwise_rank_accuracy(scores: np.ndarray, labels: np.ndarray,
                           groups: np.ndarray, max_pairs: int = 8192,
                           seed: int = 0) -> float:
    """Fraction of same-group record pairs `scores` orders the same way as
    `labels` (pairs with tied labels are skipped; 0.5 = chance).

    The calibration signal the continual-learning subsystem reads: unlike
    `rank_correlation` it is defined for two-record groups, degrades smoothly
    and is directly interpretable as "how often does the model pick the
    faster of two programs". Exhaustive when the total pair count fits in
    `max_pairs`; otherwise a deterministic seeded subsample. Returns NaN when
    no comparable pair exists (callers must treat that as "no signal", not
    as drift)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    groups = np.asarray(groups)
    ii_all, jj_all = [], []
    for g in np.unique(groups):
        idx = np.nonzero(groups == g)[0]
        if len(idx) < 2:
            continue
        a, b = np.triu_indices(len(idx), k=1)
        ii_all.append(idx[a])
        jj_all.append(idx[b])
    if not ii_all:
        return float("nan")
    ii = np.concatenate(ii_all)
    jj = np.concatenate(jj_all)
    keep = labels[ii] != labels[jj]
    ii, jj = ii[keep], jj[keep]
    if len(ii) == 0:
        return float("nan")
    if len(ii) > max_pairs:
        sel = np.random.RandomState(seed).choice(len(ii), size=max_pairs,
                                                 replace=False)
        ii, jj = ii[sel], jj[sel]
    agree = np.sign(scores[ii] - scores[jj]) == np.sign(labels[ii]
                                                        - labels[jj])
    return float(agree.mean())


def rank_accuracy(params: Params, records: Records,
                  predict_fn: Callable = None, max_pairs: int = 8192,
                  seed: int = 0) -> float:
    """Pairwise rank accuracy of a parameter set on a record set (see
    `pairwise_rank_accuracy`), scored where the params live. `predict_fn`
    defaults to the MLP scoring path; pass `cost_model.batched_predict`
    for other families."""
    if len(records) == 0:
        return float("nan")
    scores = (predict_fn or predict)(params, records.x)
    return pairwise_rank_accuracy(scores, records.y, records.g,
                                  max_pairs=max_pairs, seed=seed)


def _host64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
    return np.asarray(t, np.float64)


def param_distance(a: Params, b: Params, mask: Optional[Params] = None
                   ) -> float:
    """Relative L2 distance ||a - b|| / max(||b||, eps) between two param
    mappings with the same keys and shapes, optionally restricted to entries
    where `mask` == 1 (the lottery mask: how far a refreshed model moved
    *within the transferable ticket* vs overall — lineage metadata for the
    hub). Sums in float64 in sorted-key order, the reference's leaf order."""
    num = 0.0
    den = 0.0
    for k in sorted(a):
        da, db = _host64(a[k]), _host64(b[k])
        if mask is not None:
            m = _host64(mask[k])
            da, db = da * m, db * m
        num += float(np.sum((da - db) ** 2))
        den += float(np.sum(db ** 2))
    return float(np.sqrt(num) / max(np.sqrt(den), 1e-12))


# ---------------------------------------------------------------------------
# CostModel interface + registry: the pluggable model-family boundary. The
# tuner, session, MosesAdapter and AC talk to this API; nothing above this
# module reaches the MLP free functions directly.
# ---------------------------------------------------------------------------


COST_MODELS: Dict[str, type] = {}


def register_cost_model(name: str):
    """Class decorator: register a `CostModel` subclass under `name` so
    `tune(..., cost_model="name")` / `resolve_cost_model("name")` find it."""
    def deco(cls):
        cls.name = name
        COST_MODELS[name] = cls
        return cls
    return deco


def resolve_cost_model(spec=None, cfg: Optional[CostModelConfig] = None,
                       torch_device: TorchDevice = "cuda") -> "CostModel":
    """Resolve a registered name / instance / None into a `CostModel`.

    None -> the paper default ("mlp"). Instances pass through untouched (their
    own cfg is authoritative), but must live on `torch_device`: a mismatch
    raises rather than silently running elsewhere."""
    dev = resolve_torch_device(torch_device)
    if isinstance(spec, CostModel):
        if spec.torch_device != dev:
            raise ValueError(
                f"cost model lives on {spec.torch_device}, but "
                f"torch_device={dev} was asked for")
        return spec
    if spec is None:
        spec = "mlp"
    if spec not in COST_MODELS:
        raise KeyError(f"unknown cost model {spec!r}; registered: "
                       f"{sorted(COST_MODELS)}")
    return COST_MODELS[spec](cfg if cfg is not None else CostModelConfig(),
                             torch_device=dev)


# Reserved .npz key under which `save_params` embeds a JSON metadata blob;
# the format is the reference's, so files cross between the two packages.
PARAMS_META_KEY = "__meta__"


def save_params(path: str, params: Params,
                meta: Optional[Dict[str, Any]] = None) -> None:
    """Persist a flat param mapping as .npz, with optional JSON metadata
    embedded under `PARAMS_META_KEY`."""
    arrs = {k: np.asarray(v.detach().cpu()) for k, v in params.items()}
    if meta is not None:
        arrs[PARAMS_META_KEY] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), np.uint8).copy()
    np.savez(path, **arrs)


def load_params(path: str, torch_device: TorchDevice = "cuda"
                ) -> Tuple[Params, Dict[str, Any]]:
    """Inverse of `save_params` (and of the reference's): returns (params on
    `torch_device`, meta). Files without metadata load with an empty meta."""
    dev = resolve_torch_device(torch_device)
    meta: Dict[str, Any] = {}
    with np.load(path) as z:
        params = {}
        for k in z.files:
            if k == PARAMS_META_KEY:
                meta = json.loads(bytes(z[k].tolist()).decode())
            else:
                params[k] = torch.as_tensor(z[k], device=dev)
    return params, meta


class CostModel(abc.ABC):
    """The swappable scoring-model policy around the fixed search loop.

    Params stay an explicit flat mapping (the lottery-ticket machinery masks
    raw parameter updates), so every method is `params`-first; the instance
    carries the architecture, its config and the `torch_device` its params
    live on. `forward` must support `return_hidden=True` for the adversarial
    domain discriminator.
    """

    name = "abstract"

    def __init__(self, cfg: Optional[CostModelConfig] = None,
                 torch_device: TorchDevice = "cuda"):
        self.cfg = cfg if cfg is not None else CostModelConfig()
        self.torch_device = resolve_torch_device(torch_device)

    # --- architecture -----------------------------------------------------
    @abc.abstractmethod
    def init(self, rng: Union[int, torch.Generator]) -> Params:
        """Fresh parameters on `torch_device` from a seed or generator."""

    @abc.abstractmethod
    def forward(self, params: Params, x: torch.Tensor,
                return_hidden: bool = False):
        """x: [B, F] -> scores [B] (+ last hidden layer when asked)."""

    @property
    def hidden_dim(self) -> int:
        """Width of the hidden representation `forward` exposes (the
        adversarial discriminator's input dimension)."""
        return self.cfg.hidden_dims[-1]

    # --- scoring ----------------------------------------------------------
    def predict(self, params: Params, x: np.ndarray) -> np.ndarray:
        return predict(params, x, forward=self.forward)

    def batched_predict(self, params: Params, x: np.ndarray) -> np.ndarray:
        return predict(params, x, forward=self.forward)

    # --- training / lifecycle ---------------------------------------------
    def train(self, params: Params, records: Records,
              epochs: Optional[int] = None, lr: Optional[float] = None,
              seed: int = 0, pad: bool = False) -> Tuple[Params, List[float]]:
        """Adam + ranking loss over `records`; returns (params, losses)."""
        return train_cost_model(self.clone_params(params), records, self.cfg,
                                epochs=epochs, lr=lr, seed=seed, pad=pad,
                                forward=self.forward)

    def clone_params(self, params: Params) -> Params:
        """A copy on `torch_device`, so strategies never mutate shared
        pretrained params."""
        return {k: torch.as_tensor(v).to(self.torch_device, torch.float32,
                                         copy=True)
                for k, v in params.items()}

    def save(self, params: Params, path: str,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Persist params as .npz, tagged with the model family name."""
        save_params(path, params, meta={"model": self.name, **(meta or {})})

    def load(self, path: str) -> Params:
        params, meta = load_params(path, self.torch_device)
        if meta.get("model") not in (None, self.name):
            raise ValueError(
                f"{path} holds params for model family {meta['model']!r}, "
                f"not {self.name!r}")
        return params


@register_cost_model("mlp")
class MLPCostModel(CostModel):
    """Paper §4.2 default: the Ansor MLP (2x512, ranking loss)."""

    def init(self, rng: Union[int, torch.Generator]) -> Params:
        return init_mlp_params(self.cfg, rng, self.torch_device)

    def forward(self, params, x, return_hidden: bool = False):
        return mlp_forward(params, x, return_hidden=return_hidden)


@register_cost_model("residual-mlp")
class ResidualMLPCostModel(CostModel):
    """Deeper residual scorer proving the `CostModel` API (TLP/Pruner-style
    swap): input projection to `width`, `depth` residual ReLU blocks, linear
    head. Narrower than the paper MLP by default, so it doubles as a cheap
    draft scorer (Pruner's draft-then-verify explorer). Params are keyed
    `w_in, b_in, w0, b0, ..., w_out, b_out`, as the reference's."""

    def __init__(self, cfg: Optional[CostModelConfig] = None,
                 width: int = 256, depth: int = 3,
                 torch_device: TorchDevice = "cuda"):
        super().__init__(cfg, torch_device=torch_device)
        self.width = width
        self.depth = depth

    @property
    def hidden_dim(self) -> int:
        return self.width

    def init(self, rng: Union[int, torch.Generator]) -> Params:
        gen = as_generator(rng)
        f, w = self.cfg.feature_dim, self.width

        def normal(din, dout):
            return (torch.randn((din, dout), generator=gen)
                    / np.sqrt(din)).to(self.torch_device)

        params = {"w_in": normal(f, w),
                  "b_in": torch.zeros((w,), device=self.torch_device)}
        for i in range(self.depth):
            params[f"w{i}"] = normal(w, w)
            params[f"b{i}"] = torch.zeros((w,), device=self.torch_device)
        params["w_out"] = normal(w, 1)
        params["b_out"] = torch.zeros((1,), device=self.torch_device)
        return params

    def forward(self, params, x, return_hidden: bool = False):
        # depth is recovered from the params so `forward` stays pure
        blocks = len([k for k in params
                      if k.startswith("w") and k not in ("w_in", "w_out")])
        h = x @ params["w_in"] + params["b_in"]
        for i in range(blocks):
            h = h + torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
        score = (h @ params["w_out"] + params["b_out"])[..., 0]
        if return_hidden:
            return score, h
        return score
