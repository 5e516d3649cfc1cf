"""Distributed decode attention: KV cache sequence-sharded over the "model"
mesh axis, flash-decoding-style partial softmax + LSE combine (port of
`repro.distributed.decode_attention`).

Why: at decode_32k, a GQA cache with kv_heads < model-axis size cannot be
head-sharded 16-way; replicating it across the model axis costs 16x HBM and
an all-gather per step. Sharding the cache's *sequence* dim instead keeps
per-rank memory flat; each rank computes attention over its sequence slice
for ALL heads (q is tiny and replicated), then the partials are combined
with a log-sum-exp reduction over the "model" group
(`attention.combine_partials`).

The reference runs the body under `shard_map`; here it runs on each rank's
local shards (`DTensor.to_local`) after the inputs are redistributed to
the layout the body needs. The step's cache write on the DTensor cache is
`sharding.write_slot`: each rank writes only the rows of its own shard.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (data_axes, local_shard,
                                              to_placements)
from repro_torch.models.attention import (combine_partials,
                                          decode_attend_partial)


def _on_mesh(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    return local_shard(x, mesh, to_placements(spec, mesh))


def make_distributed_attend_fn(mesh, batch_sharded: bool = True):
    """Returns attend_fn(q, k_cache, v_cache, kv_positions, cur_pos, window)
    matching the contract of models.attention.decode_attend, with the cache
    seq-sharded on the "model" axis."""
    dp = data_axes(mesh)
    dp_entry = (dp if len(dp) > 1 else dp[0]) if (dp and batch_sharded) \
        else None
    group = mesh.get_group("model")

    def attend(q, k_cache, v_cache, kv_positions, cur_pos, window=0,
               scale=None):
        qspec = (dp_entry, None, None)           # [B, H, D] replicated on model
        kvspec = (dp_entry, "model", None, None)  # [B, Sc, G, D] seq-sharded
        pspec = (dp_entry, "model")
        cspec = (dp_entry,)
        q_ = _on_mesh(q, mesh, qspec)
        o, m, l = decode_attend_partial(
            q_, _on_mesh(k_cache, mesh, kvspec),
            _on_mesh(v_cache, mesh, kvspec),
            _on_mesh(kv_positions, mesh, pspec),
            _on_mesh(cur_pos, mesh, cspec), window=window, scale=scale)
        out = combine_partials(o, m, l, group).to(q_.dtype)
        return DTensor.from_local(out, mesh, to_placements(qspec, mesh),
                                  run_check=False)

    return attend
