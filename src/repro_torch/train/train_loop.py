"""Train and serve steps and the fault-tolerant training loop (port of
`repro.train.train_loop`).

make_train_step(model, opt, microbatches, mesh) -> (train_state, batch) ->
    (train_state, metrics)
make_serve_prefill / make_serve_step -> the serving entry points

TrainState = {"params", "opt": AdamW state, "step": 0-d int32 tensor}

The reference jits each step over a mesh and donates the train state;
PyTorch runs eagerly, and a train step writes the new params, moments and
step into the state's own tensors (`AdamW.update`), so the step holds one
copy of the state, plus the gradients until it returns.

Without a mesh everything runs on one device. With a `DeviceMesh`
(`launch.mesh`), the state's leaves are DTensors placed by
`train_state_shardings` (params per the config's sharding plan, AdamW's
m/v/master inheriting them, count and step replicated), the batch is
sharded along its batch dim (`distributed.sharding.batch_shardings`), and
the step runs on DTensors under `implicit_replication` (the plain tensors
the model makes, such as positions, masks and constants, join as
replicated) and with the models' layout operations in their DTensor forms
(`distributed.sharding.MESH_OPS`). A train step runs under the caller's
hints, or without any under hints of its own with the ZeRO-3 gather on:
each block's weights are gathered to their TP-only placements inside its
remat region (`act_sharding.gather_params`). The gradients are
redistributed to their params' placements (a pending reduction becomes a
reduce-scatter) before the in-place update, and the metrics come back as
plain tensors. `make_serve_step(distributed_cache=
True, mesh=...)` decodes against a sequence-sharded KV cache
(`distributed.decode_attention`).

The training loop (run_training) adds: checkpoint/restart, the straggler
watchdog (step-time anomaly detection), the `train.step_seconds` histogram,
the optional kernel probe, and the preemption hook used by tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.placement import TorchDevice, resolve_torch_device
from repro_torch.distributed.act_sharding import is_dtensor
from repro_torch.models.common import tree_leaves, tree_map, use_layout
from repro_torch.models.model import Model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamW

PyTree = Any


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def _on(batch: Dict[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors) as tensors on `dev`."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _on_mesh(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, Any]:
    """Under a mesh, the batch sharded along its batch dim (every rank
    holds the same whole batch); without one, the batch as it is."""
    if mesh is None:
        return batch
    from repro_torch.distributed import sharding as sh
    return sh.distribute(batch, sh.batch_shardings(batch, mesh))


@contextlib.contextmanager
def _mesh_context(mesh, train: bool = False):
    """Under a mesh, `implicit_replication` (the plain tensors the model
    makes join its DTensors as replicated) and the DTensor layout ops; for
    a train step also hints, the caller's or else ones with the ZeRO-3
    gather on and the activations left to propagation. A layout choice,
    not a fallback: with weights sharded over two data axes, DTensor's
    sharding propagation lays activations out over them too, and its
    redistribution planner then takes minutes an op on a ("pod", "data",
    "model") mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import act_sharding
    from repro_torch.distributed import sharding as sh
    hints = act_sharding.current()
    if train and hints is None:
        hints = act_sharding.Hints(mesh, sh.data_axes(mesh), "model",
                                   zero3_gather=True,
                                   constrain_activations=False)
    with implicit_replication(), use_layout(sh.MESH_OPS), \
            act_sharding.use_hints(hints):
        yield


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _device_of(t: torch.Tensor) -> torch.device:
    """The device of this rank's data of `t`."""
    return t.to_local().device if is_dtensor(t) else t.device


def train_state_shardings(model: Model, opt: AdamW, mesh):
    """(shardings, params, opt state) for {"params", "opt", "step"}, the
    trees as meta tensors (nothing allocated): params per the config's
    sharding plan, AdamW's m/v/master inheriting them, count and step
    replicated."""
    from repro_torch.distributed import sharding as sh
    params_shape, axes = model.abstract_params_and_axes()
    p_shard = sh.param_shardings(params_shape, axes, mesh,
                                 model.cfg.sharding_plan)
    opt_shape = opt.init(params_shape)
    replicated = sh.NamedSharding(mesh, ())
    opt_shards = {k: replicated if k == "count" else p_shard
                  for k in opt_shape}
    return ({"params": p_shard, "opt": opt_shards, "step": replicated},
            params_shape, opt_shape)


def loss_and_grads(model: Model, params: PyTree, batch):
    """(loss, metrics, grads) of `model.loss` at `params` on a batch of
    tensors, all detached: the gradients with respect to aliases of the param tensors (`detach` shares their
    storage), so the params themselves never require grad, and the graph
    is freed once the gradients are out."""
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(req, batch)
    # a leaf the loss does not read gets zeros, as under jax.grad
    grads = iter(torch.autograd.grad(loss, tree_leaves(req),
                                     materialize_grads=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def make_train_step(model: Model, opt: AdamW, microbatches: int = 1,
                    mesh=None):
    """The train step. With microbatches > 1 the batch is split along dim 0
    and the float32 gradients accumulated over the splits, then averaged,
    as the reference's `lax.scan` does; the metrics are then the loss and
    the optimizer's. The state's tensors are updated in place and the
    state returned. Under a mesh the state's leaves are DTensors
    (`init_train_state(mesh=...)`) and each split is sharded over the
    batch's mesh axes."""

    def grads_of(params, batch):
        loss, metrics, grads = loss_and_grads(model, params,
                                              _on_mesh(batch, mesh))
        if mesh is not None:
            grads = tree_map(lambda g, p: g.redistribute(
                p.device_mesh, p.placements), grads, params)
        return loss, metrics, grads

    def step_fn(train_state, batch):
        params = train_state["params"]
        dev = _device_of(train_state["step"])
        batch = _on(batch, dev)
        with _mesh_context(mesh, train=True):
            if microbatches > 1:
                gacc = tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(microbatches):
                    micro = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                             for k, v in batch.items()}
                    l, _, g = grads_of(params, micro)
                    tree_map(lambda a, b: a.add_(b), gacc, g)
                    loss = loss + l
                    del g
                grads = tree_map(lambda g: g.div_(microbatches), gacc)
                loss = loss / microbatches
                metrics: Dict[str, torch.Tensor] = {}
            else:
                loss, metrics, grads = grads_of(params, batch)
            _, _, opt_metrics = opt.update(grads, train_state["opt"], params)
            del grads
            train_state["step"].add_(1)
        out = {"loss": loss, **metrics, **opt_metrics}
        return train_state, {k: _full(v) for k, v in out.items()}

    return step_fn


def init_train_state(model: Model, opt: AdamW, seed: int = 0,
                     torch_device: TorchDevice = "cuda",
                     mesh=None) -> PyTree:
    """The params from `model.init(seed)`, AdamW's state and step 0. Under
    a mesh every rank draws the same params and keeps its shards of each
    leaf (`train_state_shardings`)."""
    dev = resolve_torch_device(torch_device)
    params = model.init(seed, dev)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if mesh is None:
        return state
    from repro_torch.distributed import sharding as sh
    return sh.distribute(state, train_state_shardings(model, opt, mesh)[0])


def abstract_train_state(model: Model, opt: AdamW) -> PyTree:
    """The train state's tree as meta tensors (shapes and dtypes, nothing
    allocated): the `like` of a restore."""
    params, _ = model.abstract_params_and_axes()
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# Fault-tolerant training loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    keep_n: int = 3
    async_checkpoint: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0   # step slower than factor*median -> warn
    straggler_window: int = 20
    profile_kernels: bool = False   # run tuned-vs-default kernel probe once
    device: str = "tpu_v5e"


def run_training(model: Model, opt: AdamW,
                 data_iter: Iterator[Dict[str, np.ndarray]],
                 loop: LoopConfig,
                 seed: int = 0,
                 train_state: Optional[PyTree] = None,
                 fail_at_step: Optional[int] = None,
                 log_fn: Callable[[str], None] = print,
                 torch_device: TorchDevice = "cuda",
                 mesh=None):
    """Runs training with checkpoint/restart on `torch_device`, over `mesh`
    where one is given (each rank passes its own device). Returns
    (train_state, history), one dict of floats per step.

    fail_at_step simulates a node failure (raises) — tests restart from the
    latest checkpoint and verify continuation. A step fetches its metrics
    to the host together, once.
    """
    dev = resolve_torch_device(torch_device)
    ckpt = CheckpointManager(loop.checkpoint_dir, keep_n=loop.keep_n,
                             async_save=loop.async_checkpoint)
    step_fn = (make_train_step(model, opt) if mesh is None else
               make_train_step(model, opt, mesh=mesh))
    if train_state is None:
        latest = ckpt.latest_step()
        if latest is not None:
            train_state = ckpt.restore(
                latest, abstract_train_state(model, opt), dev,
                shardings=None if mesh is None else
                train_state_shardings(model, opt, mesh)[0])
            log_fn(f"[restart] restored step {latest} from "
                   f"{loop.checkpoint_dir}")
        else:
            train_state = init_train_state(model, opt, seed, dev, mesh)

    if loop.profile_kernels:
        from repro_torch.kernels.profile import model_workloads, profile_kernels
        profile_kernels(device=loop.device,
                        workloads=model_workloads(model.cfg),
                        torch_device=dev)

    from repro_torch.obs import metrics as obs_metrics
    step_hist = obs_metrics.current().histogram("train.step_seconds")
    history = []
    times: list = []
    step = int(_full(train_state["step"]))
    while step < loop.total_steps:
        batch = _on(next(data_iter), dev)
        t0 = time.perf_counter()
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"simulated node failure at step {step}")
        train_state, metrics = step_fn(train_state, batch)
        names = list(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        dt = time.perf_counter() - t0
        step_hist.observe(dt)
        times.append(dt)
        if len(times) > loop.straggler_window:
            times.pop(0)
            med = float(np.median(times))
            if dt > loop.straggler_factor * med:
                log_fn(f"[straggler] step {step} took {dt:.3f}s "
                       f"(median {med:.3f}s) — mitigation hook fired")
        step += 1
        history.append({"step": step, **dict(zip(names, values))})
        if step % loop.log_every == 0:
            log_fn(f"step {step:6d} loss {history[-1]['loss']:.4f} "
                   f"gnorm {history[-1].get('grad_norm', 0):.3f} "
                   f"{dt*1e3:.0f}ms")
        if step % loop.checkpoint_every == 0 or step == loop.total_steps:
            ckpt.save(step, train_state)
    ckpt.wait()
    return train_state, history


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def make_serve_prefill(model: Model, max_len: Optional[int] = None,
                       mesh=None):
    def fn(params, batch):
        with _mesh_context(mesh):
            return model.prefill(params, batch, max_len=max_len)
    return fn


def make_serve_step(model: Model, distributed_cache: bool = False,
                    mesh=None, batch_sharded: bool = True):
    """The decode step. distributed_cache=True attends against a KV cache
    sequence-sharded on the mesh's "model" axis (the reference's
    flash-decoding layout, `distributed.decode_attention`; its batch dim
    over the data axes unless `batch_sharded` is False); it needs the
    mesh."""
    if mesh is None:
        if distributed_cache:
            raise ValueError("distributed_cache=True needs a mesh")

        def plain(params, state, tokens):
            return model.decode_step(params, state, tokens)
        return plain
    extras = {}
    if distributed_cache:
        from repro_torch.distributed.decode_attention import \
            make_distributed_attend_fn
        extras["attend_fn"] = make_distributed_attend_fn(
            mesh, batch_sharded=batch_sharded)

    def fn(params, state, tokens):
        st = dict(state)
        st["extras"] = {**state.get("extras", {}), **extras}
        with _mesh_context(mesh):
            return model.decode_step(params, st, tokens)
    return fn
