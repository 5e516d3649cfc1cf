"""Top-level language model: embeddings, stacks, prefill/decode (port of
`repro.models.model`).

build_model(cfg) returns a Model with functions over a nested dict of
tensors:
    init(seed, torch_device) -> params
    forward(params, batch) -> (logits, aux)
    loss(params, batch) -> (total, {"ce", "zloss", "aux", "ppl_proxy"})
    prefill(params, batch) -> (state, last_logits)
    decode_step(params, state, tokens[B]) -> (state, logits[B, V])
    cast_params(params) -> params with each weight the model only reads at
        the activation dtype cast to it once
    init_with_axes(seed, torch_device) -> (params, logical-axes tree)
    init_decode_state_specs(batch, context) -> the decode state's tree as
        meta tensors (the reference's ShapeDtypeStructs)

`input_specs(cfg, shape)` gives meta tensors for every input of an (arch,
shape) cell of the dry run.

Under an active `obs.trace.Tracer`, `prefill` and `decode_step` open the
spans `model.prefill` / `model.decode_step`, with `model.embed` and
`model.logits` inside; the blocks' spans (`transformer.py`) nest between.
`forward` and `loss` open none.

Batch keys: tokens int32 [B,S]; the encoder-decoder (whisper) adds
encoder_embeddings [B, enc_len, frontend_dim] (the stub frontend's frames),
the VLM frontend_embeddings [B, N_img, frontend_dim]; `loss` also reads
targets int32 [B,S] and an optional float loss_mask [B,S].
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.placement import TorchDevice, resolve_torch_device
from repro_torch.distributed import act_sharding
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import cache_length
from repro_torch.models.common import (ParamBuilder, apply_norm, dtype_of,
                                       init_norm, layout, meta, sinusoid_at,
                                       sinusoidal_positions)
from repro_torch.obs import trace as obs_trace

PyTree = Any


def _cast_tree(tree: dict, float32_read: dict, dtype: torch.dtype) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cast_tree(v, float32_read[k], dtype)
        else:
            out[k] = v if float32_read[k] else v.to(dtype)
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, torch_device: TorchDevice = "cuda") -> PyTree:
        """Params drawn on `torch_device` from a generator seeded with
        `seed`, in the order the reference builds them."""
        return self.init_with_axes(seed, torch_device)[0]

    def init_with_axes(self, seed: int = 0,
                       torch_device: TorchDevice = "cuda"):
        """(params, axes): `init`'s params and the tree of their logical
        axis names (tuples, one name or None per dim)."""
        dev = resolve_torch_device(torch_device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return self._build(gen, abstract=False)[:2]

    def abstract_params_and_axes(self):
        """(meta-device tensor tree, axes tree) without allocating anything."""
        return self._build(None, abstract=True)[:2]

    def float32_read(self) -> PyTree:
        """A tree of booleans beside the params: True for each leaf the
        model reads in float32 arithmetic (`ParamBuilder.float32_read`)."""
        return self._build(None, abstract=True)[2]

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
        if cfg.is_encoder_decoder:
            enc = b.child("encoder")
            tfm.init_stack(enc, cfg, kinds_override=self._encoder_kinds())
            init_norm(b, "encoder_norm", cfg.d_model, cfg.norm)
        return b.params, b.axes, b.float32_read

    def _encoder_kinds(self):
        return ["encoder_attention"] * self.cfg.encoder_layers

    def cast_params(self, params: PyTree) -> PyTree:
        """The tree the serving engine runs on: every weight the model reads
        only after a cast to the activation dtype (`w.to(x.dtype)` in the
        projections, the embedding gather and the tied logits) cast once;
        the leaves it reads in float32 (`float32_read`: norm params, gates,
        the MoE router, the sLSTM's recurrent matrices, ...) are the given
        tensors. The results are the same, bit for bit, as with `params`:
        only the per-call cast goes."""
        return _cast_tree(params, self.float32_read(),
                          dtype_of(self.cfg.activation_dtype))

    # ------------------------------------------------------------- internals
    def _embed(self, params, tokens, positions=None):
        """tokens [B,S] -> [B,S,d] in the activation dtype; positions [S]
        or [B,S] (default 0..S-1) for the sinusoidal absolute positions of
        a config without RoPE (whisper; xLSTM uses none)."""
        cfg = self.cfg
        x = layout().take_rows(params["embed"], tokens)
        x = x.to(dtype_of(cfg.activation_dtype))
        if cfg.family == "hybrid":  # gemma-family embedding scaling
            # the scale rounded to the activation dtype first, as the
            # reference does (50.596 -> 50.5 in bf16)
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        if not cfg.use_rope and cfg.family != "ssm":
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=x.device)
            # [S, d] or, at decode, [B, 1, d]: broadcast over the batch
            x = x + sinusoid_at(positions, cfg.d_model, x.dtype)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg.norm)
        # column-parallel: under a mesh each model rank computes its shard
        # of the vocab (`loss` makes the dim whole before the gold gather)
        w = (params["embed"].to(x.dtype).T if cfg.tie_embeddings
             else params["lm_head"].to(x.dtype))
        logits = layout().project_in(x, w)
        logits = logits.to(dtype_of(cfg.logits_dtype))
        if cfg.padded_vocab_size != cfg.vocab_size:
            pad = cfg.padded_vocab_size - cfg.vocab_size
            neg = torch.full((*logits.shape[:-1], pad), -1e30,
                             dtype=logits.dtype, device=logits.device)
            logits = torch.cat([logits[..., : cfg.vocab_size], neg], dim=-1)
        return logits

    def _encode(self, params, encoder_embeddings):
        cfg = self.cfg
        x = encoder_embeddings.to(dtype_of(cfg.activation_dtype))
        S = x.shape[1]
        x = x + sinusoidal_positions(S, cfg.d_model, x.dtype, x.device)[None]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        x, _ = tfm.stack_forward(params["encoder"], cfg, x, positions, {},
                                 kinds_override=self._encoder_kinds())
        return apply_norm(params["encoder_norm"], x, cfg.norm)

    def _extras(self, params, batch) -> dict:
        """The blocks' extras: the batch's own, plus the cross-attention
        source (the encoder's output, or the frontend embeddings cast to
        the activation dtype)."""
        cfg = self.cfg
        extras = dict(batch.get("extras", {}))
        if cfg.is_encoder_decoder:
            extras["kv_src"] = self._encode(params,
                                            batch["encoder_embeddings"])
        elif cfg.cross_attn_every > 0:
            extras["kv_src"] = batch["frontend_embeddings"].to(
                dtype_of(cfg.activation_dtype))
        return extras

    def _gather_outside_stack(self, params):
        """Under hints with `zero3_gather`, the leaves outside the stack
        (embedding, norms, lm_head, the encoder) gathered to their TP-only
        placements (`act_sharding.gather_params`); `stack_forward` gathers
        the stack's blocks one at a time. Without hints, `params`."""
        if act_sharding.current() is None:
            return params
        axes = _param_axes(self.cfg)
        top = {k: v for k, v in params.items() if k != "stack"}
        return {**params, **act_sharding.gather_params(
            top, {k: axes[k] for k in top})}

    # --------------------------------------------------------------- forward
    def forward(self, params, batch):
        """(logits [B, S, V], aux): aux is the MoE blocks' summed load-
        balancing loss (0 without MoE)."""
        params = self._gather_outside_stack(params)
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
        extras = self._extras(params, batch)
        x, aux = tfm.stack_forward(params, self.cfg, x, positions, extras)
        return self._logits(params, x), aux

    def loss(self, params, batch):
        """(total, metrics): the masked mean cross entropy of the float32
        logits, plus 1e-4 * logz^2 (the z-loss) and the MoE blocks' aux
        loss. The metrics are 0-d tensors of the same autograd graph:
        detach them before keeping them past the backward pass."""
        logits, aux = self.forward(params, batch)
        targets = batch["targets"]
        # the vocab dim whole before the gold-logit gather (under a mesh
        # the logits are vocab-sharded)
        logits32 = layout().whole_dim(logits.float(), logits.dim() - 1)
        logz = torch.logsumexp(logits32, dim=-1)
        gold = logits32.gather(-1, targets[..., None].long())[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=logits.device)
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = ((logz - gold) * mask).sum() / denom
        zloss = 1e-4 * ((logz ** 2) * mask).sum() / denom
        total = ce + zloss + aux
        return total, {"ce": ce, "zloss": zloss, "aux": aux,
                       "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}

    # --------------------------------------------------------------- serving
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Processes batch['tokens'] [B,S] (and the batch's encoder or
        frontend embeddings); returns (state, last_logits).

        max_len: total planned sequence length (context + decode steps); the
        KV cache is sized for it (default S + 64 headroom).
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        with obs_trace.span("model.prefill"):
            with obs_trace.span("model.embed"):
                x = self._embed(params, tokens)
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
            extras = self._extras(params, batch)
            clen = cache_length(cfg,
                                max_len if max_len is not None else S + 64)
            x, caches = tfm.stack_prefill(params, cfg, x, positions, clen,
                                          extras)
            with obs_trace.span("model.logits"):
                logits = self._logits(params, x[:, -1:])[:, 0]
            state = {"layers": caches,
                     "cur": torch.full((B,), S, dtype=torch.int32,
                                       device=x.device)}
        return state, logits

    def decode_step(self, params, state, tokens):
        """tokens: [B] int32 -> (new_state, logits [B, V]). The blocks read
        `state["extras"]` where the state has one; the returned state drops
        it, as the reference's does."""
        cur = state["cur"]
        with obs_trace.span("model.decode_step"):
            with obs_trace.span("model.embed"):
                x = self._embed(params, tokens[:, None],
                                positions=cur[:, None])
            extras = dict(state.get("extras", {}))
            x, caches = tfm.stack_decode(params, self.cfg, x,
                                         state["layers"], cur, extras)
            with obs_trace.span("model.logits"):
                logits = self._logits(params, x)[:, 0]
            new_state = {k: v for k, v in state.items() if k != "extras"}
            new_state["layers"] = caches
            new_state["cur"] = cur + 1
        return new_state, logits


    # ------------------------------------------------------------- specs
    def init_decode_state_specs(self, batch_size: int, context_len: int):
        """A tree of meta tensors matching what prefill(context_len)
        returns (shapes and dtypes, nothing allocated)."""
        cfg = self.cfg
        caches = tfm.walk_stack(cfg, lambda kind, p, c: tfm.block_cache_spec(
            cfg, kind, batch_size, context_len))
        return {"layers": caches, "cur": meta((batch_size,), torch.int32)}


@functools.lru_cache(maxsize=64)
def _param_axes(cfg: ModelConfig) -> PyTree:
    """The logical-axes tree of the config's params."""
    return Model(cfg).abstract_params_and_axes()[1]


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)


# ---------------------------------------------------------------------------
# input_specs for the dry-run
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta-tensor stand-ins (the reference's ShapeDtypeStructs) for every
    model input of this (arch, shape).

    train   -> kwargs for train_step(params, batch)
    prefill -> kwargs for serve_prefill(params, batch)
    decode  -> kwargs for serve_step(params, state, tokens)
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    adt = dtype_of(cfg.activation_dtype)
    model = build_model(cfg)

    def frontend(batch_keys: Dict[str, Any]):
        if cfg.is_encoder_decoder:
            batch_keys["encoder_embeddings"] = meta(
                (B, cfg.encoder_seq_len, cfg.frontend_dim or cfg.d_model),
                adt)
        elif cfg.cross_attn_every > 0:
            batch_keys["frontend_embeddings"] = meta(
                (B, cfg.num_frontend_tokens, cfg.frontend_dim or cfg.d_model),
                adt)
        return batch_keys

    if shape.kind == "train":
        return {"batch": frontend({"tokens": meta((B, S), i32),
                                   "targets": meta((B, S), i32)})}
    if shape.kind == "prefill":
        return {"batch": frontend({"tokens": meta((B, S), i32)})}
    if shape.kind == "decode":
        # the cross caches are inside the layer caches
        return {"state": model.init_decode_state_specs(B, S),
                "tokens": meta((B,), i32)}
    raise ValueError(shape.kind)
