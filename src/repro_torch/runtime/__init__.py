"""The port's runtime: device selection and the unified Session
(``repro.runtime``): one nestable, thread-local context carrying the
tensor backend, kernel overrides, precision and serving policies.

    import repro_torch

    with repro_torch.session(backend="hopper", tag="core") as s:
        ...                       # every ops.* call dispatches through s
        print(s.describe())
"""

from .device import host_to_device, resolve_device
from .policies import (KernelOverrides, PrecisionPolicy, PrefixPolicy,
                       ServingPolicy, SpeculativePolicy, resolve_dtype)
from .session import Session
from .stack import (current_session, default_session, mutate_current,
                    pop_session, push_session, session)

__all__ = [
    "host_to_device", "resolve_device",
    "Session", "KernelOverrides", "PrecisionPolicy", "ServingPolicy",
    "PrefixPolicy", "SpeculativePolicy", "resolve_dtype",
    "session", "current_session", "default_session",
    "push_session", "pop_session", "mutate_current",
]
