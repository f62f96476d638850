from .device import host_to_device, resolve_device
from .policies import PrefixPolicy, ServingPolicy, SpeculativePolicy

__all__ = ["host_to_device", "resolve_device", "ServingPolicy", "PrefixPolicy",
           "SpeculativePolicy"]
