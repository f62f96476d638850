"""First-order optimizers (``repro.core.optim.optimizer``): ``SGD``,
``Adam`` and ``AdamW`` with the reference's order of rounding, in its two
call styles:

* imperative (paper Listing 9): ``opt = SGD(model.params(), lr=0.1,
  momentum=0.9)``, then ``loss.backward(); opt.step(); opt.zeroGrad()``
  over the module's tape ``Variable``s;
* functional (the production loop): ``new_params, new_state =
  opt.apply(params, grads, state, lr)`` over trees of tensors.

Both update in place under ``torch.no_grad()``:
every parameter tensor is overwritten with its new value and every state
dict gets its new moments, and the same trees are returned.  A training
step thus keeps one copy of the parameters, and parameters that are
autograd leaves stay leaves.

As in the reference, a state is born in the parameter's dtype (zeros)
and the update returns fp32 moments unless ``state_dtype`` is set
(``_cast`` is the identity for ``state_dtype=None``), so after the first
update ``m`` and ``v`` are fp32.  There are no fp32 master weights: the
parameter is updated in fp32 and rounded back to its dtype, then the
decoupled decay is subtracted in the parameter's dtype.

``Adafactor`` is not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.models.meta import tree_leaves, tree_map


class Optimizer:
    """Base: functional ``init`` / ``apply`` / ``apply_with_count`` +
    the imperative ``Variable`` bridge (``step`` / ``zeroGrad``)."""

    def __init__(self, params: Sequence[Any] | None = None,
                 state_dtype: torch.dtype | None = None):
        self._vars = list(params) if params is not None else None
        self._state = None
        self.state_dtype = state_dtype
        self.step_count = 0

    def init(self, params: Any) -> Any:
        return tree_map(self._init_leaf, params)

    def apply(self, params: Any, grads: Any, state: Any,
              lr: float) -> tuple[Any, Any]:
        self.step_count += 1
        return self.apply_with_count(params, grads, state, lr,
                                     self.step_count)

    def apply_with_count(self, params: Any, grads: Any, state: Any,
                         lr: float, count: int) -> tuple[Any, Any]:
        """The update with the caller's step count (1 on the first step),
        made in place; returns ``(params, state)``."""
        with torch.no_grad():
            tree_map(lambda p, g, s: self._update_leaf(p, g, s, lr, count),
                     params, grads, state)
        return params, state

    def _init_leaf(self, p: torch.Tensor) -> Any:
        raise NotImplementedError

    def _update_leaf(self, p, g, s, lr, count) -> None:
        raise NotImplementedError

    # -- imperative API (paper Listing 9) ----------------------------------------
    def step(self, lr: float | None = None) -> None:
        """Update every ``Variable`` given at construction that has a
        gradient, in place (``v.data`` keeps its tensor)."""
        if self._vars is None:
            raise RuntimeError("imperative step() needs params at __init__")
        if self._state is None:
            self._state = [self._init_leaf(v.data) for v in self._vars]
        self.step_count += 1
        use_lr = lr if lr is not None else getattr(self, "lr", None)
        with torch.no_grad():
            for v, s in zip(self._vars, self._state):
                if v.grad is not None:
                    self._update_leaf(v.data, v.grad, s, use_lr,
                                      self.step_count)

    def zeroGrad(self) -> None:  # noqa: N802 - paper-faithful name
        if self._vars is not None:
            for v in self._vars:
                v.zero_grad()

    zero_grad = zeroGrad

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.state_dtype is None else x.to(self.state_dtype)


class SGD(Optimizer):
    """SGD with momentum, weight decay and Nesterov, as the reference's:
    ``buf = momentum * buf + g``, then ``p -= lr * (g + momentum * buf)``
    (Nesterov) or ``p -= lr * buf``; the buffer lives in the parameter's
    dtype (or ``state_dtype``) and is updated in place."""

    def __init__(self, params=None, lr: float = 0.01, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False, **kw):
        super().__init__(params, **kw)
        self.lr, self.momentum = lr, momentum
        self.weight_decay, self.nesterov = weight_decay, nesterov

    def _init_leaf(self, p):
        if self.momentum == 0.0:
            return ()
        return self._cast(torch.zeros_like(p))

    def _update_leaf(self, p, g, s, lr, count) -> None:
        lr = self.lr if lr is None else lr
        if self.weight_decay:
            g = g + self.weight_decay * p
        if self.momentum == 0.0:
            p.sub_(lr * g.to(p.dtype))
            return
        s.mul_(self.momentum).add_(g.to(s.dtype))
        d = (g + self.momentum * s.to(g.dtype)) if self.nesterov \
            else s.to(g.dtype)
        p.sub_(lr * d.to(p.dtype))


SGDOptimizer = SGD  # paper-faithful alias (Listing 9)


class Adam(Optimizer):
    def __init__(self, params=None, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, **kw):
        super().__init__(params, **kw)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay

    def _init_leaf(self, p):
        return {"m": self._cast(torch.zeros_like(p)),
                "v": self._cast(torch.zeros_like(p))}

    def _adam(self, p, g, s, lr, count) -> torch.Tensor:
        """The reference's ``Adam._update_leaf``: writes the new moments
        into ``s`` and returns the new parameter in its dtype."""
        lr = self.lr if lr is None else lr
        g32 = g.float()
        m = self.b1 * s["m"].float() + (1 - self.b1) * g32
        v = self.b2 * s["v"].float() + (1 - self.b2) * g32 * g32
        mhat = m / (1 - self.b1 ** count)
        vhat = v / (1 - self.b2 ** count)
        update = mhat / (torch.sqrt(vhat) + self.eps)
        if self.weight_decay:
            update = update + self.weight_decay * p.float()
        s["m"], s["v"] = self._cast(m), self._cast(v)
        return (p.float() - lr * update).to(p.dtype)

    def _update_leaf(self, p, g, s, lr, count) -> None:
        p.copy_(self._adam(p, g, s, lr, count))


class AdamW(Adam):
    """Decoupled weight decay (the production-default optimizer)."""

    def __init__(self, params=None, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, **kw):
        super().__init__(params, lr=lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=0.0, **kw)
        self.decoupled_wd = weight_decay

    def _update_leaf(self, p, g, s, lr, count) -> None:
        lr_v = self.lr if lr is None else lr
        new_p = self._adam(p, g, s, lr, count)
        if self.decoupled_wd:
            new_p = new_p - (lr_v * self.decoupled_wd
                             * p.float()).to(p.dtype)
        p.copy_(new_p)


# -- gradient utilities ---------------------------------------------------------

def clip_by_global_norm(grads: Any,
                        max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / (norm + 1e-12)), where
    norm is the fp32 global norm; returns (grads in their dtypes, norm).
    Stays on the device: no host sync."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


# -- LR schedules ---------------------------------------------------------------
# The reference evaluates these on an int32 step inside the jitted step;
# here they run on the host and return a Python float, so the step needs
# no device value to set its learning rate.

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable[[int], float]:
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * step / max(1.0, warmup)
        frac = (step - warmup) / max(1.0, total - warmup)
        frac = min(max(frac, 0.0), 1.0)
        return base_lr * (min_ratio + (1 - min_ratio)
                          * 0.5 * (1 + math.cos(math.pi * frac)))

    return lr


def linear_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[int], float]:
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * step / max(1.0, warmup)
        return base_lr * min(max((total - step) / max(1.0, total - warmup),
                                 0.0), 1.0)

    return lr
