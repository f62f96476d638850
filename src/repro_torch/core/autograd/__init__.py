from .variable import (Variable, Node, no_grad, noGrad, record, fused,
                       tape_size, grad_enabled)
from . import functions
from .functional import value_and_grad, grad

__all__ = ["Variable", "Node", "no_grad", "noGrad", "record", "fused",
           "tape_size", "grad_enabled", "functions", "value_and_grad", "grad"]
