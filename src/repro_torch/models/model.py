"""Top-level language model: embeddings, stacks, prefill/decode (port of
`repro.models.model`).

build_model(cfg) returns a Model with functions over a nested dict of
tensors:
    init(seed, torch_device) -> params
    forward(params, batch) -> (logits, aux)
    prefill(params, batch) -> (state, last_logits)
    decode_step(params, state, tokens[B]) -> (state, logits[B, V])
    cast_params(params) -> params with each weight the model only reads at
        the activation dtype cast to it once

Batch keys: tokens int32 [B,S]. The loss (training), the encoder, the
frontends and absolute positions wait (ROADMAP Queue 1 item 11);
build_model raises for a config that needs them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import TorchDevice, resolve_torch_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ParamBuilder, apply_norm, dtype_of,
                                       init_norm)

PyTree = Any

# leaves the model reads in float32 arithmetic whatever the activation
# dtype; norm subtrees ("ln_*", "final_norm") are kept whole
FLOAT32_LEAVES = ("lambda_raw", "q_norm_scale", "k_norm_scale")


def cache_length(cfg: ModelConfig, context_len: int) -> int:
    """KV-cache capacity for a decode shape with `context_len` of context."""
    if cfg.attention_kind == "sliding" and cfg.sliding_window > 0:
        return min(context_len, cfg.sliding_window)
    if cfg.attention_kind == "local" and cfg.local_window > 0:
        return min(context_len, cfg.local_window)
    return context_len


def _is_norm(name: str) -> bool:
    return name.startswith("ln_") or name in ("final_norm", "encoder_norm")


def _cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = v if _is_norm(k) else _cast_tree(v, dtype)
        else:
            out[k] = v if k in FLOAT32_LEAVES else v.to(dtype)
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, torch_device: TorchDevice = "cuda") -> PyTree:
        """Params drawn on `torch_device` from a generator seeded with
        `seed`, in the order the reference builds them."""
        dev = resolve_torch_device(torch_device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return self._build(gen, abstract=False)[0]

    def abstract_params_and_axes(self):
        """(meta-device tensor tree, axes tree) without allocating anything."""
        return self._build(None, abstract=True)

    def _build(self, generator, abstract: bool):
        cfg = self.cfg
        b = ParamBuilder(generator, cfg.param_dtype, abstract=abstract)
        V = cfg.padded_vocab_size
        b.param("embed", (V, cfg.d_model), ("vocab", "embed"), scale=1.0)
        if not cfg.tie_embeddings:
            b.param("lm_head", (cfg.d_model, V), ("embed", "vocab"),
                    scale=1.0 / math.sqrt(cfg.d_model))
        init_norm(b, "final_norm", cfg.d_model, cfg.norm)
        tfm.init_stack(b, cfg)
        return b.params, b.axes

    def cast_params(self, params: PyTree) -> PyTree:
        """The tree the serving engine runs on: every weight the model reads
        only after a cast to the activation dtype (`w.to(x.dtype)` in the
        projections, the embedding gather and the tied logits) cast once;
        norm params and FLOAT32_LEAVES are the given tensors. The results
        are the same, bit for bit, as with `params`: only the per-call cast
        goes."""
        return _cast_tree(params, dtype_of(self.cfg.activation_dtype))

    # ------------------------------------------------------------- internals
    def _embed(self, params, tokens):
        """tokens [B,S] -> [B,S,d] in the activation dtype (positions enter
        through RoPE; build_model rejects configs without it)."""
        cfg = self.cfg
        x = params["embed"][tokens].to(dtype_of(cfg.activation_dtype))
        if cfg.family == "hybrid":  # gemma-family embedding scaling
            # the scale rounded to the activation dtype first, as the
            # reference does (50.596 -> 50.5 in bf16)
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg.norm)
        if cfg.tie_embeddings:
            logits = torch.matmul(x, params["embed"].to(x.dtype).T)
        else:
            logits = torch.matmul(x, params["lm_head"].to(x.dtype))
        logits = logits.to(dtype_of(cfg.logits_dtype))
        if cfg.padded_vocab_size != cfg.vocab_size:
            pad = cfg.padded_vocab_size - cfg.vocab_size
            neg = torch.full((*logits.shape[:-1], pad), -1e30,
                             dtype=logits.dtype, device=logits.device)
            logits = torch.cat([logits[..., : cfg.vocab_size], neg], dim=-1)
        return logits

    # --------------------------------------------------------------- forward
    def forward(self, params, batch):
        """(logits [B, S, V], aux): aux is 0, as for every ported block."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
        x = tfm.stack_forward(params, self.cfg, x, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), aux

    # --------------------------------------------------------------- serving
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Processes batch['tokens'] [B,S]; returns (state, last_logits).

        max_len: total planned sequence length (context + decode steps); the
        KV cache is sized for it (default S + 64 headroom).
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        clen = cache_length(cfg, max_len if max_len is not None else S + 64)
        x, caches = tfm.stack_prefill(params, cfg, x, positions, clen)
        logits = self._logits(params, x[:, -1:])[:, 0]
        state = {"layers": caches,
                 "cur": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)}
        return state, logits

    def decode_step(self, params, state, tokens):
        """tokens: [B] int32 -> (new_state, logits [B, V])."""
        cur = state["cur"]
        x = self._embed(params, tokens[:, None])
        x, caches = tfm.stack_decode(params, self.cfg, x, state["layers"],
                                     cur)
        logits = self._logits(params, x)[:, 0]
        new_state = dict(state)
        new_state["layers"] = caches
        new_state["cur"] = cur + 1
        return new_state, logits


def build_model(cfg: ModelConfig) -> Model:
    """The Model of `cfg`; raises NotImplementedError where the config needs
    a part that is not ported (`transformer.check_supported`)."""
    tfm.check_supported(cfg)
    return Model(cfg=cfg)
