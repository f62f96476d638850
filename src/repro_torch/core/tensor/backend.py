"""TensorBackend: the primitive-op surface of the framework
(``repro.core.tensor.backend``).

Flashlight's ``TensorBackend`` interface (paper §4.1.1, Listing 2): a
deliberately *small* set of primitive tensor operations.  Every other
operator in the framework (activations, norms, losses, attention, the
core NN stack) is derived from these by composition, and swapping a
backend swaps the source of truth for these ops everywhere (paper
§5.2.4): the core stack in ``repro_torch.core.nn`` and the model zoo's
projections route through :mod:`repro_torch.core.tensor.ops`, which
dispatches to the session's backend.

The primitive list is the reference's.  Two differences follow from
PyTorch: the creation primitives take the ``device`` to create on (JAX
places arrays on its default device), and the random primitives take a
``torch.Generator`` where the reference takes a JAX key.
"""

from __future__ import annotations

import abc
import inspect
from typing import Any, Sequence

Tensor = Any  # backend-native handle: a torch.Tensor for the eager backends


class TensorBackend(abc.ABC):
    """Abstract primitive-op surface (~60 ops, mirroring the paper's Table 1).

    Implementations may store global state (streams, counters) as
    instance attributes, per Listing 2 of the paper.
    """

    name: str = "abstract"

    # -- lifecycle -------------------------------------------------------
    def materialize(self, x: Tensor) -> Tensor:
        """Force computation of ``x`` and return a concrete tensor.
        Eager backends return ``x`` unchanged."""
        return x

    # -- creation --------------------------------------------------------
    @abc.abstractmethod
    def full(self, shape: Sequence[int], fill_value, dtype, device) -> Tensor: ...

    @abc.abstractmethod
    def arange(self, start, stop, step, dtype, device) -> Tensor: ...

    @abc.abstractmethod
    def iota(self, dtype, shape, dimension: int, device) -> Tensor: ...

    @abc.abstractmethod
    def random_uniform(self, key, shape, dtype, minval, maxval, device) -> Tensor: ...

    @abc.abstractmethod
    def random_normal(self, key, shape, dtype, device) -> Tensor: ...

    # -- unary -----------------------------------------------------------
    @abc.abstractmethod
    def neg(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def exp(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def log(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def sin(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def cos(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def tanh(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def sqrt(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def rsqrt(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def abs(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def sign(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def floor(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def erf(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def logical_not(self, x: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def isnan(self, x: Tensor) -> Tensor: ...

    # -- binary ----------------------------------------------------------
    @abc.abstractmethod
    def add(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def sub(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def mul(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def div(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def pow(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def maximum(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def minimum(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def mod(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def eq(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def ne(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def lt(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def le(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def gt(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def ge(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def logical_and(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def logical_or(self, lhs: Tensor, rhs: Tensor) -> Tensor: ...

    # -- reductions ------------------------------------------------------
    @abc.abstractmethod
    def sum(self, x: Tensor, axis, keepdims: bool) -> Tensor: ...

    @abc.abstractmethod
    def max(self, x: Tensor, axis, keepdims: bool) -> Tensor: ...

    @abc.abstractmethod
    def min(self, x: Tensor, axis, keepdims: bool) -> Tensor: ...

    @abc.abstractmethod
    def prod(self, x: Tensor, axis, keepdims: bool) -> Tensor: ...

    @abc.abstractmethod
    def argmax(self, x: Tensor, axis) -> Tensor: ...

    @abc.abstractmethod
    def cumsum(self, x: Tensor, axis) -> Tensor: ...

    # -- shape / data movement --------------------------------------------
    @abc.abstractmethod
    def reshape(self, x: Tensor, shape) -> Tensor: ...

    @abc.abstractmethod
    def transpose(self, x: Tensor, axes) -> Tensor: ...

    @abc.abstractmethod
    def broadcast_to(self, x: Tensor, shape) -> Tensor: ...

    @abc.abstractmethod
    def concatenate(self, xs: Sequence[Tensor], axis: int) -> Tensor: ...

    @abc.abstractmethod
    def slice(self, x: Tensor, start: Sequence[int], limit: Sequence[int]) -> Tensor: ...

    @abc.abstractmethod
    def dynamic_slice(self, x: Tensor, start_indices, slice_sizes) -> Tensor: ...

    @abc.abstractmethod
    def dynamic_update_slice(self, x: Tensor, update: Tensor, start_indices) -> Tensor: ...

    @abc.abstractmethod
    def pad(self, x: Tensor, pad_width, value) -> Tensor: ...

    @abc.abstractmethod
    def where(self, cond: Tensor, x: Tensor, y: Tensor) -> Tensor: ...

    @abc.abstractmethod
    def take(self, x: Tensor, indices: Tensor, axis: int) -> Tensor: ...

    @abc.abstractmethod
    def take_along_axis(self, x: Tensor, indices: Tensor, axis: int) -> Tensor: ...

    @abc.abstractmethod
    def scatter_add(self, x: Tensor, indices: Tensor, updates: Tensor, axis: int) -> Tensor: ...

    @abc.abstractmethod
    def flip(self, x: Tensor, axis) -> Tensor: ...

    @abc.abstractmethod
    def sort(self, x: Tensor, axis) -> Tensor: ...

    @abc.abstractmethod
    def top_k(self, x: Tensor, k: int) -> tuple[Tensor, Tensor]: ...

    @abc.abstractmethod
    def astype(self, x: Tensor, dtype) -> Tensor: ...

    @abc.abstractmethod
    def stop_gradient(self, x: Tensor) -> Tensor: ...

    # -- linear algebra / structured compute -------------------------------
    @abc.abstractmethod
    def matmul(self, lhs: Tensor, rhs: Tensor) -> Tensor:
        """Batched matrix multiply (the arithmetic-bound primitive)."""

    @abc.abstractmethod
    def dot_general(self, lhs: Tensor, rhs: Tensor, dimension_numbers,
                    preferred_element_type) -> Tensor: ...

    @abc.abstractmethod
    def conv2d(self, x: Tensor, w: Tensor, stride, padding) -> Tensor:
        """NHWC conv with HWIO weights (Flashlight lists conv as a primitive)."""

    # -- introspection -----------------------------------------------------
    @classmethod
    def primitive_ops(cls) -> list[str]:
        """Names of the abstract primitive ops — the op *surface* of the
        framework, reported in the paper-Table-1 complexity benchmark."""
        ops = []
        for name, member in inspect.getmembers(TensorBackend):
            if getattr(member, "__isabstractmethod__", False):
                ops.append(name)
        return sorted(ops)
