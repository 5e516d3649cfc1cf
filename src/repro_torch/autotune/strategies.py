"""Strategy plugins: the paper's adaptation schemes as registered classes
(PyTorch port of `repro.autotune.strategies`).

Moses' framing (paper §3.4–§3.6) is that the *adaptation scheme* is a policy
around a fixed search loop — which baselines §4.4 compares are just different
policies. This module makes that literal: each scheme is a `Strategy`
subclass registered with `@register_strategy("name")`, and `tune()` drives
whichever instance it is handed through a fixed protocol:

    prepare(ctx)        once per tuning job: build params/adapter state from
                        the `StrategyContext` (cost model, pretrained params,
                        source pool, seeds)
    begin_task(wl)      once per subgraph: reset per-task state (AC state)
    plan(trials)        split the task's trial budget into measurement-batch
                        sizes + prediction-only trials (moses: via the AC)
    on_round(...)       after each measured batch: update the model, report
                        model-update cost and whether to early-terminate
    adapt(params, target, source)
                        the scheme's model update proper — lottery-ticket
                        phases for moses, full fine-tune for the baselines

Strategies never touch MLP internals; every model access goes through the
`CostModel` interface in `ctx.cost_model`, so any registered model family
(see `core/cost_model.py`) slots under any strategy. New schemes — a
TLP-style sequence-model policy, a Pruner-style draft-then-verify explorer —
are one registered class, no tuner changes.

Writing your own:

    @register_strategy("my-scheme")
    class MyStrategy(Strategy):
        def prepare(self, ctx):
            super().prepare(ctx)
            self.params = ctx.cost_model.init(ctx.seed)
        def on_round(self, builder, feats, round_idx):
            self.params = self.adapt(self.params, builder.snapshot(), None)
            return RoundUpdate(self.ctx.model_update_cost, False)
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.autotune.space import Workload
from repro_torch.configs.moses import MosesConfig
from repro_torch.core.ac import ACState, AdaptiveController
from repro_torch.core.adaptation import MosesAdapter
from repro_torch.core.cost_model import CostModel, Records, RecordsBuilder

PyTree = Any

STRATEGY_REGISTRY: Dict[str, type] = {}


def register_strategy(name: str):
    """Class decorator: register a `Strategy` subclass under `name` so
    string specs in `tune()` / `TuneSession.run()` resolve to it."""
    def deco(cls):
        cls.name = name
        STRATEGY_REGISTRY[name] = cls
        return cls
    return deco


def resolve_strategy(spec) -> "Strategy":
    """Registered name -> fresh instance; instances pass through untouched
    (a `Strategy` carries per-job state, so names always resolve fresh)."""
    if isinstance(spec, Strategy):
        return spec
    if isinstance(spec, str):
        if spec not in STRATEGY_REGISTRY:
            raise KeyError(f"unknown strategy {spec!r}; registered: "
                           f"{sorted(STRATEGY_REGISTRY)}")
        return STRATEGY_REGISTRY[spec]()
    raise TypeError(f"strategy must be a name or Strategy, got {type(spec)}")


def strategy_name(spec) -> str:
    return spec if isinstance(spec, str) else spec.name


@dataclasses.dataclass
class StrategyContext:
    """Everything a strategy may draw on, fixed for one tuning job.
    `device` is the simulated tuning target; tensors live on the cost
    model's `torch_device`."""
    cfg: MosesConfig
    cost_model: CostModel
    device: str
    seed: int
    pretrained_params: Optional[PyTree] = None
    source_pool: Optional[Records] = None
    ratio_override: Optional[float] = None
    model_update_cost: float = 2.0


class RoundUpdate(NamedTuple):
    """What a measurement round's model update reports back to the loop."""
    cost_seconds: float = 0.0   # model-update time added to search_time
    terminate: bool = False     # stop measuring; go prediction-only (§3.5)


class Strategy(abc.ABC):
    """Base adaptation policy. Stateful per tuning job: `prepare()` binds the
    context and builds model state, which then persists across the job's
    tasks (the online model keeps learning from task to task, as in the
    paper's pipeline)."""

    name = "abstract"
    requires_pretrained = False
    uses_model = True   # False => vendor-default config, no search (raw)

    def __init__(self):
        self.ctx: Optional[StrategyContext] = None
        self.params: Optional[PyTree] = None

    def prepare(self, ctx: StrategyContext) -> None:
        if self.requires_pretrained:
            assert ctx.pretrained_params is not None, (
                f"strategy {self.name!r} needs pretrained_params")
        self.ctx = ctx

    def begin_task(self, wl: Workload) -> None:
        """Reset per-task state; default none."""

    def task_state(self):
        """Snapshot of the strategy's per-task mutable state (the AC state
        for moses), or None for strategies without any. The scheduled
        engine swaps this in/out around `on_round` when several interleaved
        tasks share one strategy instance, so per-task semantics (e.g. §3.5
        early termination) survive the sharing."""
        return None

    def set_task_state(self, state) -> None:
        """Restore a `task_state()` snapshot; default no-op."""

    def plan(self, trials: int) -> Tuple[List[int], int]:
        """Split a task's trial budget into measurement-batch sizes and
        prediction-only trials. Default: every trial is measured, in
        fixed-size rounds of `top_k_measure`."""
        per_round = self.ctx.cfg.top_k_measure
        return [per_round] * max(1, trials // per_round), 0

    def adapt(self, params: PyTree, target: Records,
              source: Optional[Records], round_idx: int = 0) -> PyTree:
        """Update `params` from target-device records (+ optional source
        pool). Default: frozen model."""
        return params

    def on_round(self, builder: RecordsBuilder, feats, round_idx: int
                 ) -> RoundUpdate:
        """Hook after each measured batch; default: no update, keep going."""
        return RoundUpdate()


@register_strategy("raw")
class RawStrategy(Strategy):
    """Baseline 1: vendor-default config, no tuning at all."""
    uses_model = False


@register_strategy("ansor-random")
class AnsorRandomStrategy(Strategy):
    """Baseline 2: randomly-initialized cost model trained online from
    target measurements only."""

    def prepare(self, ctx: StrategyContext) -> None:
        super().prepare(ctx)
        self.params = ctx.cost_model.init(ctx.seed)

    def adapt(self, params, target, source, round_idx: int = 0):
        params, _ = self.ctx.cost_model.train(
            params, target, epochs=self.ctx.cfg.online_epochs,
            seed=self.ctx.seed + round_idx, pad=True)
        return params

    def on_round(self, builder, feats, round_idx):
        self.params = self.adapt(self.params, builder.snapshot(), None,
                                 round_idx=round_idx)
        return RoundUpdate(self.ctx.model_update_cost, False)


@register_strategy("tenset-pretrain")
class TensetPretrainStrategy(Strategy):
    """Baseline 3: source-pretrained model, frozen on the target."""
    requires_pretrained = True

    def prepare(self, ctx: StrategyContext) -> None:
        super().prepare(ctx)
        self.params = ctx.cost_model.clone_params(ctx.pretrained_params)


@register_strategy("tenset-finetune")
class TensetFinetuneStrategy(AnsorRandomStrategy):
    """Baseline 4: source-pretrained model + vanilla full fine-tune (same
    online update as ansor-random, warm-started from the source domain)."""
    requires_pretrained = True

    def prepare(self, ctx: StrategyContext) -> None:
        Strategy.prepare(self, ctx)
        self.params = ctx.cost_model.clone_params(ctx.pretrained_params)


@register_strategy("moses")
class MosesStrategy(Strategy):
    """The paper's scheme: lottery-ticket adaptation + adversarial invariant
    loss (§3.4) with AC-scheduled measurement early termination (§3.5)."""
    requires_pretrained = True

    def prepare(self, ctx: StrategyContext) -> None:
        super().prepare(ctx)
        self.adapter = MosesAdapter(
            cfg=ctx.cfg,
            params=ctx.cost_model.clone_params(ctx.pretrained_params),
            source_pool=ctx.source_pool,
            ratio_override=ctx.ratio_override,
            cost_model=ctx.cost_model)
        self.params = self.adapter.params
        self.ac = AdaptiveController(ctx.cfg.ac_train_ratio,
                                     ctx.cfg.ac_num_batches,
                                     ctx.cfg.ac_cv_threshold)
        self.ac_state = ACState()

    def begin_task(self, wl: Workload) -> None:
        self.ac_state = ACState()

    def task_state(self):
        return self.ac_state

    def set_task_state(self, state) -> None:
        self.ac_state = state if state is not None else ACState()

    def plan(self, trials: int) -> Tuple[List[int], int]:
        return self.ac.plan(trials)

    def adapt(self, params, target, source, round_idx: int = 0):
        # source records flow in through the adapter's adversarial term;
        # `source` is accepted for protocol symmetry but the pool is fixed
        # at prepare() time (one discriminator per job)
        self.adapter.adapt(target, epochs=self.ctx.cfg.online_epochs)
        return self.adapter.params

    def on_round(self, builder, feats, round_idx):
        self.params = self.adapt(self.params, builder.snapshot(),
                                 self.ctx.source_pool, round_idx=round_idx)
        self.ac_state = self.ac.observe(self.ac_state, self.ctx.cost_model,
                                        self.params, feats)
        return RoundUpdate(self.ctx.model_update_cost,
                           self.ac_state.terminated)


# registration order == the paper's presentation order (Table 1 columns)
STRATEGIES = tuple(STRATEGY_REGISTRY)
