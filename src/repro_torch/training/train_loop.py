"""Training loop (``repro.training.train_loop``): gradient accumulation,
global-norm clipping, the cosine LR schedule, checkpoint / restart and
straggler monitoring, on one device.

Gradients come from ``loss.backward()`` on parameters marked
``requires_grad``; the optimizer (``repro_torch.core.optim``) updates
them in place.  On the card a step reads its loss back once (the
reference's ``float(metrics["loss"])``) and makes no other host sync:
the learning rate is a host float and clipping stays on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

from repro_torch.core.optim import AdamW, clip_by_global_norm, cosine_schedule
from repro_torch.models.meta import tree_leaves, tree_map
from repro_torch.runtime.device import host_to_device
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import StragglerMonitor


@dataclass
class TrainConfig:
    steps: int = 100
    base_lr: float = 3e-4
    warmup: int = 10
    grad_clip: float = 1.0
    accum: int = 1                   # gradient accumulation microsteps
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    log_every: int = 10


def _grads(params: Any) -> Any:
    """The parameters' ``.grad`` as a tree, clearing them."""
    def take(p):
        g = p.grad
        p.grad = None
        return g
    return tree_map(take, params)


def make_step_fn(model, optimizer, tcfg: TrainConfig):
    """``step_fn(params, opt_state, step, batch) -> (params, opt_state,
    metrics)``; updates params and state in place.  ``batch`` holds
    ``[B, S]`` tensors on the model's device; with ``accum > 1`` it is
    cut into ``accum`` contiguous micro-batches along B, their gradients
    summed in fp32 and divided by ``accum``."""
    schedule = cosine_schedule(tcfg.base_lr, tcfg.warmup, tcfg.steps)

    def step_fn(params, opt_state, step: int, batch: dict):
        if tcfg.accum > 1:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(tcfg.accum):
                mb = {k: v.reshape(tcfg.accum, -1, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, _ = model.loss_fn(params, mb)
                loss.backward()
                tree_map(lambda acc, g: acc.add_(g), gsum, _grads(params))
                lsum = lsum + loss.detach()
            grads = tree_map(lambda g: g / tcfg.accum, gsum)
            loss = lsum / tcfg.accum
            metrics = {}
        else:
            loss, metrics = model.loss_fn(params, batch)
            loss.backward()
            grads = _grads(params)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = schedule(step)
        params, opt_state = optimizer.apply_with_count(
            params, grads, opt_state, lr, step + 1)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return step_fn


def train(model, params, batches: Iterator[Any], tcfg: TrainConfig,
          optimizer=None, log_fn: Callable[[str], None] = print):
    """Returns (params, history); resumes from ``checkpoint_dir`` if it
    holds a checkpoint.  ``batches`` yields dicts of ``[B, S]`` arrays
    (numpy or tensors), moved to the model's device without a sync.
    ``params`` are updated in place (restored ones replace them)."""
    dev = model.device
    log_fn(f"[train] {model.cfg.name} on {dev}"
           + (f" ({torch.cuda.get_device_name(dev)})"
              if dev.type == "cuda" else ""))
    optimizer = optimizer or AdamW(lr=tcfg.base_lr)
    opt_state = optimizer.init(params)
    start_step = 0
    ckpt = None
    if tcfg.checkpoint_dir:
        ckpt = CheckpointManager(tcfg.checkpoint_dir)
        if ckpt.latest_step() is not None:
            (params, opt_state), extra = ckpt.restore((params, opt_state))
            start_step = int(extra.get("step", ckpt.latest_step()))
            log_fn(f"[train] resumed from step {start_step}")
    for p in tree_leaves(params):
        p.requires_grad_(True)

    step_fn = make_step_fn(model, optimizer, tcfg)
    monitor = StragglerMonitor()
    history: list[dict] = []
    step = start_step
    for batch in batches:
        if step >= tcfg.steps:
            break
        t0 = time.perf_counter()
        batch = {k: v if isinstance(v, torch.Tensor)
                 else host_to_device(v, dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, step, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.record(step, dt)
        history.append({"step": step, "loss": loss, "sec": dt})
        if step % tcfg.log_every == 0:
            log_fn(f"[train] step {step:5d} loss {loss:8.4f} "
                   f"({dt*1e3:6.1f} ms)")
        step += 1
        if ckpt and (step % tcfg.checkpoint_every == 0
                     or monitor.should_checkpoint_now()):
            ckpt.save_async(step, (params, opt_state), {"step": step})
    if ckpt:
        ckpt.save(step, (params, opt_state), {"step": step})
        ckpt.wait()
    return params, history
