"""Train and serve steps and the fault-tolerant training loop (port of
`repro.train.train_loop`).

make_train_step(model, opt, microbatches) -> (train_state, batch) ->
    (train_state, metrics)
make_serve_prefill / make_serve_step -> the serving entry points

TrainState = {"params", "opt": AdamW state, "step": 0-d int32 tensor}

The reference jits each step over a mesh and donates the train state;
PyTorch runs eagerly on one card, and a train step writes the new params,
moments and step into the state's own tensors (`AdamW.update`), so the
step holds one copy of the state, plus the gradients until it returns.

The training loop (run_training) adds: checkpoint/restart, the straggler
watchdog (step-time anomaly detection), the `train.step_seconds` histogram,
the optional kernel probe, and the preemption hook used by tests.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.placement import TorchDevice, resolve_torch_device
from repro_torch.models.common import tree_leaves, tree_map
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


def make_train_step(model: Model, opt: AdamW, microbatches: int = 1):
    """The train step. With microbatches > 1 the batch is split along dim 0
    and the float32 gradients accumulated over the splits, then averaged,
    as the reference's `lax.scan` does; the metrics are then the loss and
    the optimizer's. The state's tensors are updated in place and the
    state returned."""

    def step_fn(train_state, batch):
        params = train_state["params"]
        batch = _on(batch, train_state["step"].device)
        if microbatches > 1:
            gacc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=train_state["step"].device)
            for i in range(microbatches):
                micro = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                         for k, v in batch.items()}
                l, _, g = loss_and_grads(model, params, micro)
                tree_map(lambda a, b: a.add_(b), gacc, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g.div_(microbatches), gacc)
            loss = loss / microbatches
            metrics: Dict[str, torch.Tensor] = {}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        _, _, opt_metrics = opt.update(grads, train_state["opt"], params)
        del grads
        train_state["step"].add_(1)
        return train_state, {"loss": loss, **metrics, **opt_metrics}

    return step_fn


def init_train_state(model: Model, opt: AdamW, seed: int = 0,
                     torch_device: TorchDevice = "cuda") -> PyTree:
    dev = resolve_torch_device(torch_device)
    params = model.init(seed, dev)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


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
                 torch_device: TorchDevice = "cuda"):
    """Runs training with checkpoint/restart on `torch_device`. Returns
    (train_state, history), one dict of floats per step.

    fail_at_step simulates a node failure (raises) — tests restart from the
    latest checkpoint and verify continuation. A step fetches its metrics
    to the host together, once.
    """
    dev = resolve_torch_device(torch_device)
    ckpt = CheckpointManager(loop.checkpoint_dir, keep_n=loop.keep_n,
                             async_save=loop.async_checkpoint)
    step_fn = make_train_step(model, opt)
    if train_state is None:
        latest = ckpt.latest_step()
        if latest is not None:
            train_state = ckpt.restore(
                latest, abstract_train_state(model, opt), dev)
            log_fn(f"[restart] restored step {latest} from "
                   f"{loop.checkpoint_dir}")
        else:
            train_state = init_train_state(model, opt, seed, dev)

    if loop.profile_kernels:
        from repro_torch.kernels.profile import model_workloads, profile_kernels
        profile_kernels(device=loop.device,
                        workloads=model_workloads(model.cfg),
                        torch_device=dev)

    from repro_torch.obs import metrics as obs_metrics
    step_hist = obs_metrics.current().histogram("train.step_seconds")
    history = []
    times: list = []
    step = int(train_state["step"])
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


def make_serve_prefill(model: Model, max_len: Optional[int] = None):
    def fn(params, batch):
        return model.prefill(params, batch, max_len=max_len)
    return fn


def make_serve_step(model: Model, distributed_cache: bool = False):
    if distributed_cache:
        raise NotImplementedError(
            "distributed_cache (sequence-sharded decode attention) is not "
            "ported yet (ROADMAP Queue 1 item 12: the distribution layer)")

    def fn(params, state, tokens):
        return model.decode_step(params, state, tokens)
    return fn
