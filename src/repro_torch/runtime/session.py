"""The :class:`Session` (``repro.runtime.session``): one composable
context for the port's scoped customization points.

A Session bundles the tensor backend, kernel overrides, the precision
policy and the serving policy into one value that can be entered for a
scope (``repro_torch.session(...)``), derived (``Session.replace``),
inspected (``repro_torch.current_session()``) and snapshotted
(``Session.describe()``).

The reference's other fields belong to subsystems the port does not have
yet.  They keep their names and defaults, and setting one to anything
else raises ``NotImplementedError`` naming its ROADMAP item, so no
setting is silently ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from .policies import KernelOverrides, PrecisionPolicy, ServingPolicy

# The reference's default mesh-axis candidates for the batch dimension.
DEFAULT_BATCH_AXES: tuple[str, ...] = ("pod", "data")

# field -> (its default, the ROADMAP queue 1 item that ports it)
_UNPORTED = {
    "mesh": (None, "item 10 (distributed, sharding and launch)"),
    "batch_axes": (DEFAULT_BATCH_AXES,
                   "item 10 (distributed, sharding and launch)"),
    "sharding_rules": (None, "item 10 (distributed, sharding and launch)"),
    "compiler": (None, "item 7 (compiler and lazy backend)"),
    "analysis": (None, "item 8 (analysis)"),
    "obs": (None, "item 3 (observability)"),
    "memory": (None, "item 3 (observability: memory telemetry and the "
                     "manager adapter)"),
}


@dataclass(frozen=True)
class Session:
    """Immutable bundle of every scoped customization point.

    backend:
        tensor backend: a registry name (``"torch"``, ``"hopper"``, or
        anything registered via ``register_backend``) or a
        ``TensorBackend`` instance, resolved lazily by
        :meth:`backend_instance`.
    kernels / precision / serving:
        see :class:`KernelOverrides` / :class:`PrecisionPolicy` /
        :class:`ServingPolicy`; each also accepts a dict of fields.
    tag:
        free-form label that lands in ``describe()``.
    mesh, batch_axes, sharding_rules, compiler, analysis, obs, memory:
        not ported; only their defaults are accepted (``obs=False`` reads
        as the default, off).
    """

    backend: Any = "torch"
    mesh: Any = None
    batch_axes: tuple[str, ...] = DEFAULT_BATCH_AXES
    sharding_rules: Any = None
    kernels: KernelOverrides = field(default_factory=KernelOverrides)
    precision: PrecisionPolicy = field(default_factory=PrecisionPolicy)
    serving: ServingPolicy = field(default_factory=ServingPolicy)
    compiler: Any = None
    analysis: Any = None
    obs: Any = None
    memory: Any = None
    tag: str = ""

    def __post_init__(self):
        if self.batch_axes is not None:
            object.__setattr__(self, "batch_axes", tuple(self.batch_axes))
        if self.obs is False:
            object.__setattr__(self, "obs", None)
        if self.backend == "lazy":
            raise NotImplementedError(
                "Session(backend='lazy') is not ported yet: the deferred, "
                "fusing backend comes with the compiler, ROADMAP queue 1 "
                "item 7")
        for name, (default, item) in _UNPORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"Session({name}=...) is not ported yet: ROADMAP queue 1 "
                    f"{item}")
        for name, cls in (("kernels", KernelOverrides),
                          ("precision", PrecisionPolicy),
                          ("serving", ServingPolicy)):
            val = getattr(self, name)
            if isinstance(val, dict):
                object.__setattr__(self, name, cls(**val))

    # -- derivation ---------------------------------------------------------
    def replace(self, **overrides) -> "Session":
        """A derived session; nested fields accept dicts of overrides:
        ``s.replace(kernels={"matmul": fn})`` keeps the other kernels."""
        for name in ("kernels", "precision", "serving"):
            val = overrides.get(name)
            if isinstance(val, dict):
                overrides[name] = getattr(self, name).replace(**val)
        return dataclasses.replace(self, **overrides)

    # -- resolution ---------------------------------------------------------
    def backend_instance(self):
        """The live TensorBackend (registry names resolved on demand),
        memoized per Session: every ``ops.*`` primitive asks for it."""
        inst = self.__dict__.get("_backend_inst")
        if inst is None:
            b = self.backend
            if isinstance(b, str):
                from repro_torch.core.tensor.dispatch import get_backend

                b = get_backend(b)
            inst = b
            object.__setattr__(self, "_backend_inst", inst)
        return inst

    # -- provenance ---------------------------------------------------------
    def describe(self) -> dict:
        """JSON-serializable snapshot for logs and provenance."""
        b = self.backend
        backend = b if isinstance(b, str) else getattr(
            b, "name", type(b).__name__)
        return {
            "backend": backend,
            "kernels": self.kernels.describe(),
            "precision": self.precision.describe(),
            "serving": self.serving.describe(),
            "tag": self.tag,
        }
