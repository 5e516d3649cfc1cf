"""Paper configuration: Moses auto-tuning / cost-model adaptation hyperparameters.

Mirrors Section 4 of the paper:
  - cost model: MLP with two hidden layers x 512, ranking loss
  - max epoch 30, lr alpha = 0.001, distilling boundary threshold theta = 0.5
  - transferable-parameter ratio default 0.5 (ablated over {0.01, 0.3, 0.5, 0.7})
  - trials: small=200, large=2000 (paper: 20000/5000; knob below)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class CostModelConfig:
    feature_dim: int = 164          # Ansor feature dimensionality (paper §2.2)
    hidden_dims: Tuple[int, ...] = (512, 512)
    lr: float = 1e-3                # paper: alpha = 0.001
    max_epochs: int = 30            # paper: max epoch 30
    batch_size: int = 512
    loss: str = "rank"              # pairwise ranking loss (Ansor-style)
    rank_pairs_per_batch: int = 2048
    seed: int = 0


@dataclass(frozen=True)
class MosesConfig:
    cost_model: CostModelConfig = field(default_factory=CostModelConfig)
    # lottery-ticket adaptation (paper §3.4)
    distill_threshold: float = 0.5      # theta on normalized xi = |w * grad_w|
    transferable_ratio: float = 0.5     # rho: top fraction by xi ranking (Fig. 6)
    use_ratio_ranking: bool = True      # paper's ranking mechanism (vs raw threshold)
    variant_weight_decay: float = 0.05  # wd() strength for domain-variant params (Eq. 7)
    adversarial_beta: float = 0.05      # beta in Eq. 6 (small)
    adaptation_lr: float = 1e-3
    adaptation_epochs: int = 30
    # adaptive controller (paper §3.5)
    ac_train_ratio: float = 0.5         # p: fraction of trials backed by measurements
    ac_num_batches: int = 4             # q
    ac_cv_threshold: float = 0.08       # terminate measurement when CV < this
    # online update depth per tuning round (paper trains with max epoch 30;
    # each online round is a partial pass)
    online_epochs: int = 12
    # search (Ansor-style evolutionary, paper §2.2)
    population_size: int = 128
    evolution_rounds: int = 4
    mutation_prob: float = 0.85
    top_k_measure: int = 16             # programs measured per tuning round
    eps_greedy: float = 0.05
    # trials
    small_trials: int = 200             # paper Table 1 "Small Trials (200)"
    large_trials: int = 2000            # paper: 20000 (2060) / 5000 (TX2); scaled for CI
    # devices (simulated; see autotune/devices.py)
    source_device: str = "tpu_v5p"      # plays the role of K80 (source domain)
    target_devices: Tuple[str, ...] = ("tpu_v5e", "tpu_edge")  # ~2060, ~TX2
    seed: int = 0


DEFAULT = MosesConfig()
