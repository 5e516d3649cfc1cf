"""Cross-pod pipeline parallelism (GPipe-style) over the "pod" mesh axis
(port of `repro.distributed.pipeline`).

An optional plan for the multi-pod mesh: instead of treating pods as an outer
data-parallel axis, map pipeline STAGES onto pods. Microbatches stream
through stages; activations hop pods by point-to-point sends on the pod
group. This is the standard large-scale recipe when cross-pod bandwidth is
much lower than in-pod bandwidth: pipeline traffic is O(activations) per hop
instead of O(gradients) per step.

Implementation: each rank of the "pod" sub-group is one stage and runs
`stage_fn(stage, x)` in a GPipe schedule of (num_micro + num_stages - 1)
ticks; the reference's `ppermute` to stage + 1 is a send/recv pair on the
pod group (`dist.batch_isend_irecv`), and one all-reduce over "pod" of the
last stage's outputs (zeros elsewhere) gives every pod the result. Bubble
fraction = (S-1)/(M+S-1), reported by `bubble_fraction`. The schedule is a
forward pass: the hand-offs carry no autograd.

The dry run's default plan keeps pods as data parallel.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)


def pipeline_apply(
    stage_fn: Callable[[int, torch.Tensor], torch.Tensor],
    x_micro: torch.Tensor,       # [num_micro, micro_batch, ...]
    mesh,
    num_stages: int,
    axis: str = "pod",
) -> torch.Tensor:
    """Runs x through `num_stages` sequential stages mapped onto `axis`.

    stage_fn(stage: int, x) -> x must be shape-preserving (standard
    transformer-stage contract). x_micro holds the same values on every
    rank. Returns the final output in microbatch layout [num_micro,
    micro_batch, ...] on every rank.
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if sizes[axis] != num_stages:
        raise ValueError(f"num_stages={num_stages} must equal the size of "
                         f"the {axis!r} axis ({sizes})")
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    num_micro = x_micro.shape[0]
    ticks = num_micro + num_stages - 1
    nxt = (dist.get_global_rank(group, stage + 1)
           if stage < num_stages - 1 else None)
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(ticks):
        # stage 0 ingests microbatch t (when in range)
        injected = (x_micro[min(t, num_micro - 1)].to(buf.dtype)
                    if stage == 0 else buf)
        active = 0 <= t - stage < num_micro
        # an inactive stage passes its input through
        y = stage_fn(stage, injected) if active else injected
        # the last stage emits microbatch (t - num_stages + 1)
        if active and stage == num_stages - 1:
            outs[t - num_stages + 1] = y.to(outs.dtype)
        # hand activations to the next stage
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prv is not None:
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        for req in (dist.batch_isend_irecv(ops) if ops else ()):
            req.wait()
    # results live on the last pod; share them back to every pod
    if stage != num_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs
