"""Variable + dynamic-tape autograd (``repro.core.autograd.variable``;
paper §4.2, Listing 4).

A :class:`Variable` wraps a backend tensor; operators record VJP closures
onto a dynamic tape (parent links), "in a design similar to Paszke et al.
[2017] while being lightweight enough to allow implementations of other
autograd paradigms".

The tape is the framework's own: it does not use ``torch.autograd``.
Each op runs eagerly through the session's backend and records one
node; ``loss.backward()`` walks the nodes in reverse topological order,
so under ``session(backend="hopper")`` the backward's matmuls launch the
same kernel as the forward's.  Held against the reference tape in
tests/test_torch_autograd.py.

The §5.2.1 customization hooks are first-class:

* **graph pruning** — ``backward(prune=fn)`` stops gradient flow into
  subgraphs the predicate rejects (e.g. sparse beam-search lattices);
* **pre-fused gradients** — :func:`fused` records a *single* tape node
  (one VJP closure) for an arbitrary composite, collapsing common op
  sequences;
* **custom node lifetime** — ``free_on_use=True`` drops VJP residual
  references as soon as each node's backward has run, instead of keeping
  the whole graph alive until the walk finishes.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Sequence

import torch

from ..tensor import ops

_uid = itertools.count()


class _GradState(threading.local):
    def __init__(self):
        self.enabled = True


_GRAD_STATE = _GradState()


class no_grad:
    """Context manager disabling tape recording."""

    def __enter__(self):
        self._prev = _GRAD_STATE.enabled
        _GRAD_STATE.enabled = False
        return self

    def __exit__(self, *exc):
        _GRAD_STATE.enabled = self._prev
        return False


def grad_enabled() -> bool:
    return _GRAD_STATE.enabled


class Node:
    """A tape node: VJP closure + parent links.

    ``Node`` count is the tape size — the §5.2.1 study manipulates graphs
    with millions of these, so the slots layout is deliberately minimal.
    """

    __slots__ = ("parents", "vjp", "name", "uid")

    def __init__(self, parents: Sequence["Variable"], vjp: Callable,
                 name: str):
        self.parents = tuple(parents)
        self.vjp = vjp
        self.name = name
        self.uid = next(_uid)


class Variable:
    """Tensor + optional grad + tape linkage (paper's VARIABLE)."""

    __slots__ = ("data", "requires_grad", "grad", "node", "__weakref__")

    def __init__(self, data, requires_grad: bool = False,
                 node: Node | None = None):
        self.data = data
        self.requires_grad = requires_grad
        self.grad = None
        self.node = node

    # -- paper API ---------------------------------------------------------
    def tensor(self):
        """Materialized underlying tensor (forces lazy backends)."""
        return ops.materialize(self.data)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self):
        return len(self.data.shape)

    def detach(self) -> "Variable":
        return Variable(self.data, requires_grad=False)

    def zero_grad(self) -> None:
        self.grad = None

    # -- backward ------------------------------------------------------------
    def backward(self, grad=None, *, prune: Callable[[Node], bool] | None = None,
                 free_on_use: bool = True, accumulate: bool = True) -> None:
        """Reverse-walk the tape from this variable.

        prune: optional predicate; when it returns True for a node, gradient
            flow into that node's subtree is cut (on-the-fly graph pruning).
        free_on_use: drop VJP closures/residuals as soon as consumed
            (custom node lifetime; trims peak memory on huge tapes).
        accumulate: add into existing ``.grad`` (else overwrite).
        """
        if grad is None:
            grad = ops.ones_like(self.data)
        order = _toposort(self)
        grads: dict[int, Any] = {}
        if self.node is not None:
            grads[self.node.uid] = grad
        elif self.requires_grad:
            _assign(self, grad, accumulate)
            return

        for node in order:  # already reverse-topological
            g = grads.pop(node.uid, None)
            if g is None:
                continue
            if prune is not None and prune(node):
                continue
            parent_grads = node.vjp(g)
            for parent, pg in zip(node.parents, parent_grads):
                if pg is None:
                    continue
                if parent.node is not None:
                    u = parent.node.uid
                    grads[u] = pg if u not in grads else ops.add(grads[u], pg)
                elif parent.requires_grad:
                    _assign(parent, pg, accumulate)
            if free_on_use:
                node.vjp = _consumed
        # leaves reached through recorded nodes
        return

    # -- operator sugar (delegates to functions.py) ---------------------------
    def __add__(self, other):
        from . import functions as F
        return F.add(self, _as_variable(other))

    __radd__ = __add__

    def __sub__(self, other):
        from . import functions as F
        return F.sub(self, _as_variable(other))

    def __rsub__(self, other):
        from . import functions as F
        return F.sub(_as_variable(other), self)

    def __mul__(self, other):
        from . import functions as F
        return F.mul(self, _as_variable(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        from . import functions as F
        return F.div(self, _as_variable(other))

    def __rtruediv__(self, other):
        from . import functions as F
        return F.div(_as_variable(other), self)

    def __neg__(self):
        from . import functions as F
        return F.neg(self)

    def __matmul__(self, other):
        from . import functions as F
        return F.matmul(self, _as_variable(other))

    def __getitem__(self, idx):
        from . import functions as F
        return F.getitem(self, idx)

    def reshape(self, shape):
        from . import functions as F
        return F.reshape(self, shape)

    def astype(self, dtype):
        from . import functions as F
        return F.astype(self, dtype)

    def sum(self, axis=None, keepdims=False):
        from . import functions as F
        return F.sum(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        from . import functions as F
        return F.mean(self, axis=axis, keepdims=keepdims)

    def __repr__(self):
        return (f"Variable(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"requires_grad={self.requires_grad}, "
                f"tape={'yes' if self.node else 'leaf'})")


def _consumed(_):
    raise RuntimeError(
        "tape node already consumed (free_on_use=True); re-run forward or "
        "call backward(free_on_use=False) to retain the graph")


def _assign(var: Variable, grad, accumulate: bool) -> None:
    if accumulate and var.grad is not None:
        var.grad = ops.add(var.grad, grad)
    else:
        var.grad = grad


def _as_variable(x) -> Variable:
    if isinstance(x, Variable):
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return Variable(x)


def noGrad(tensor) -> Variable:  # noqa: N802 - paper-faithful name
    """Paper's ``noGrad``: wrap data as a constant Variable."""
    return Variable(tensor, requires_grad=False)


def _toposort(root: Variable) -> list[Node]:
    """Reverse-topological order of tape nodes reachable from root."""
    seen: set[int] = set()
    post: list[Node] = []
    if root.node is None:
        return post
    stack: list[tuple[Node, bool]] = [(root.node, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            post.append(node)
            continue
        if node.uid in seen:
            continue
        seen.add(node.uid)
        stack.append((node, True))
        for p in node.parents:
            if p.node is not None and p.node.uid not in seen:
                stack.append((p.node, False))
    post.reverse()
    return post


def tape_size(root: Variable) -> int:
    """Number of tape nodes reachable from ``root`` (benchmark metric)."""
    return len(_toposort(root))


def record(out_data, parents: Sequence[Variable], vjp: Callable,
           name: str) -> Variable:
    """Create an output Variable, recording a tape node if needed."""
    track = grad_enabled() and any(
        p.requires_grad or p.node is not None for p in parents)
    if not track:
        return Variable(out_data)
    return Variable(out_data, node=Node(parents, vjp, name))


def fused(fn: Callable, name: str = "fused") -> Callable:
    """Pre-fused gradient computation (§5.2.1).

    Wraps an arbitrary composite of tensor ops so that the *whole composite*
    is recorded as one tape node with a single VJP closure, instead of one
    node per primitive — collapsing "common sequences of gradient
    computation operations".  The VJP is ``torch.func.vjp``'s, so ``fn``
    must not reach a ctypes kernel (such an op needs an explicit VJP, as
    ``functions.matmul`` has).
    """

    def wrapped(*variables: Variable) -> Variable:
        variables = tuple(_as_variable(v) for v in variables)
        datas = tuple(v.data for v in variables)
        out, vjp_fn = torch.func.vjp(fn, *datas)
        return record(out, variables, lambda g: vjp_fn(g), name=name)

    return wrapped
