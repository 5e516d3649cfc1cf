"""Deterministic synthetic data pipeline (verbatim copy of `repro.train.data`,
imports repointed).

Generates a reproducible token stream per (seed, host) so multi-host training
reads disjoint shards without coordination. Provides the modality-stub inputs
(encoder frame embeddings / vision tokens) required by whisper / vlm archs,
per the assignment spec ("input_specs() provides precomputed frame/patch
embeddings").

The stream has learnable structure (a noisy Markov chain over a random
transition table) so small-model training loss actually decreases — used by
examples/train_lm.py to show end-to-end learning.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    markov_order: bool = True
    noise: float = 0.1


def _transition_table(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    # sparse-ish deterministic successor table: each token has 4 likely successors
    succ = rng.randint(0, vocab, size=(vocab, 4))
    return succ


def data_iterator(cfg: ModelConfig, dcfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    vocab = cfg.vocab_size
    rng = np.random.RandomState(dcfg.seed * 1009 + dcfg.host_id)
    succ = _transition_table(vocab, dcfg.seed)
    B, S = dcfg.batch_size, dcfg.seq_len
    step = 0
    while True:
        if dcfg.markov_order:
            toks = np.empty((B, S + 1), np.int32)
            toks[:, 0] = rng.randint(0, vocab, size=B)
            choice = rng.randint(0, 4, size=(B, S))
            noise_mask = rng.rand(B, S) < dcfg.noise
            noise_tok = rng.randint(0, vocab, size=(B, S))
            for t in range(S):
                nxt = succ[toks[:, t], choice[:, t]]
                toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        else:
            toks = rng.randint(0, vocab, size=(B, S + 1)).astype(np.int32)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
        }
        if cfg.is_encoder_decoder:
            batch["encoder_embeddings"] = rng.randn(
                B, cfg.encoder_seq_len, cfg.frontend_dim or cfg.d_model
            ).astype(np.float32) * 0.1
        elif cfg.cross_attn_every > 0:
            batch["frontend_embeddings"] = rng.randn(
                B, cfg.num_frontend_tokens, cfg.frontend_dim or cfg.d_model
            ).astype(np.float32) * 0.1
        step += 1
        yield batch
