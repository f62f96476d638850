"""Backend registry + dispatch (``repro.core.tensor.dispatch``): the
single source of truth for tensor ops.

Paper §5.2.4: "an implementer can simply subclass or swap out the
existing implementation of the add function ... All add operations in
Flashlight dispatch to that operator".  The *registry* (name -> backend
factory) lives here; the *active* backend is a field of the
:class:`repro_torch.runtime.Session`, and scoped swaps go through
``repro_torch.session(backend=...)``.  ``use_backend`` / ``set_backend``
remain as deprecated shims over the session stack.

Registered: ``"torch"`` (the default) and ``"hopper"``.  ``"lazy"``, the
reference's deferred/fusing backend, comes with the compiler and is
refused until then.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable

from repro_torch.runtime import stack as _rt

from .backend import TensorBackend
from .torch_backend import TorchBackend

_REGISTRY: dict[str, Callable[[], TensorBackend]] = {}
_INSTANCES: dict[str, TensorBackend] = {}


def register_backend(name: str, factory: Callable[[], TensorBackend]) -> None:
    _REGISTRY[name] = factory


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(name: str) -> TensorBackend:
    if name not in _INSTANCES:
        if name not in _REGISTRY:
            raise KeyError(
                f"unknown tensor backend {name!r}; available: {available_backends()}")
        _INSTANCES[name] = _REGISTRY[name]()
    return _INSTANCES[name]


def current_backend() -> TensorBackend:
    """The session's backend: what every ``ops.*`` primitive dispatches to."""
    return _rt.current_session().backend_instance()


def set_backend(backend: TensorBackend | str) -> None:
    """Deprecated: use ``repro_torch.session(backend=...)`` for scoped swaps."""
    warnings.warn(
        "set_backend() is deprecated; use repro_torch.session(backend=...) "
        "(or Session.replace) instead", DeprecationWarning, stacklevel=2)
    _rt.mutate_current(backend=backend)


@contextlib.contextmanager
def use_backend(backend: TensorBackend | str):
    """Deprecated shim: ``with repro_torch.session(backend=backend):``."""
    warnings.warn(
        "use_backend() is deprecated; use repro_torch.session(backend=...) "
        "instead", DeprecationWarning, stacklevel=3)
    with _rt.session(backend=backend):
        yield current_backend()


def _hopper() -> TensorBackend:
    from .hopper_backend import HopperBackend

    return HopperBackend()


def _lazy() -> TensorBackend:
    raise NotImplementedError(
        "the lazy (deferred, fusing) backend is not ported yet: it comes "
        "with the compiler, ROADMAP queue 1 item 7")


register_backend("torch", TorchBackend)
register_backend("hopper", _hopper)
register_backend("lazy", _lazy)
