"""Functional bridge (``repro.core.autograd.functional``): tape autograd
over parameter trees.

``value_and_grad(fn)`` mirrors ``jax.value_and_grad`` but differentiates
with the framework's own tape: it wraps every tree leaf in a
:class:`Variable`, runs ``fn``, walks the tape, and re-assembles the
gradient tree (zeros for leaves the loss does not reach).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.models.meta import tree_map

from ..tensor import ops
from .variable import Variable


def value_and_grad(fn: Callable, *, prune=None,
                   free_on_use: bool = True) -> Callable:
    """Tape-autograd analog of jax.value_and_grad over the first argument."""

    def wrapped(params, *args, **kwargs):
        var_params = tree_map(lambda leaf: Variable(leaf, requires_grad=True),
                              params)
        loss = fn(var_params, *args, **kwargs)
        if not isinstance(loss, Variable):
            raise TypeError("fn must return a Variable loss")
        loss.backward(prune=prune, free_on_use=free_on_use)
        grads = tree_map(lambda v: v.grad if v.grad is not None
                         else ops.zeros_like(v.data), var_params)
        return loss.data, grads

    return wrapped


def grad(fn: Callable, **kw) -> Callable:
    vag = value_and_grad(fn, **kw)

    def wrapped(params, *args, **kwargs):
        return vag(params, *args, **kwargs)[1]

    return wrapped
