"""MODULE abstraction (``repro.core.nn.module``; paper §4.2, A.4.2).

Modules recursively store parameters (Variables) and child modules,
"communicate by exchanging Tensor data, and are composed functionally or
imperatively".  Serialization follows the paper's FL_SAVE_LOAD flavor via
``state_dict``/``load_state_dict`` (npz on disk).  Parameter names are the
reference's (``m0.weight``, ``attn.wq.bias``, ...), so weights map across
the two packages name for name (``repro_torch.convert.module_params``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..autograd import Variable


class Module:
    def __init__(self):
        object.__setattr__(self, "_params", {})
        object.__setattr__(self, "_children", {})
        object.__setattr__(self, "_train", True)

    # -- registration -------------------------------------------------------
    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Variable):
            self._params[name] = value
        elif isinstance(value, Module):
            self._children[name] = value
        object.__setattr__(self, name, value)

    def register_param(self, name: str, value: Variable) -> Variable:
        setattr(self, name, value)
        return value

    # -- traversal ------------------------------------------------------------
    def params(self) -> list[Variable]:
        """All parameters, depth-first (paper: ``model.params()``)."""
        out = list(self._params.values())
        for child in self._children.values():
            out.extend(child.params())
        return out

    def named_params(self, prefix: str = "") -> Iterator[tuple[str, Variable]]:
        for name, p in self._params.items():
            yield (f"{prefix}{name}", p)
        for cname, child in self._children.items():
            yield from child.named_params(prefix=f"{prefix}{cname}.")

    def modules(self) -> Iterator["Module"]:
        yield self
        for child in self._children.values():
            yield from child.modules()

    # -- train/eval mode --------------------------------------------------------
    def train(self, mode: bool = True) -> "Module":
        for m in self.modules():
            object.__setattr__(m, "_train", mode)
        return self

    def eval(self) -> "Module":
        return self.train(False)

    @property
    def training(self) -> bool:
        return self._train

    # -- forward ----------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    # -- grads --------------------------------------------------------------------
    def zero_grad(self) -> None:
        for p in self.params():
            p.zero_grad()

    # -- serialization (FL_SAVE_LOAD analog) -----------------------------------------
    def state_dict(self) -> dict[str, Any]:
        return {name: p.tensor().detach().cpu().numpy()
                for name, p in self.named_params()}

    def load_state_dict(self, state: dict[str, Any], strict: bool = True) -> None:
        own = dict(self.named_params())
        missing = set(own) - set(state)
        unexpected = set(state) - set(own)
        if strict and (missing or unexpected):
            raise KeyError(f"state mismatch: missing={sorted(missing)} "
                           f"unexpected={sorted(unexpected)}")
        for name, value in state.items():
            if name in own:
                old = own[name].data
                own[name].data = torch.as_tensor(value, dtype=old.dtype,
                                                 device=old.device)

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    def load(self, path: str) -> None:
        with np.load(path) as data:
            self.load_state_dict({k: data[k] for k in data.files})

    # -- functional bridge -------------------------------------------------------------
    def param_pytree(self) -> dict[str, Any]:
        return {name: p.data for name, p in self.named_params()}

    def set_param_pytree(self, tree: dict[str, Any]) -> None:
        own = dict(self.named_params())
        for name, value in tree.items():
            own[name].data = value


class Container(Module):
    """Wraps an arbitrary collection of modules (paper A.4.2)."""

    def __init__(self, *modules: Module):
        super().__init__()
        for i, m in enumerate(modules):
            setattr(self, f"m{i}", m)
        object.__setattr__(self, "_order", [f"m{i}" for i in range(len(modules))])

    def __iter__(self):
        return (self._children[n] for n in self._order)

    def __len__(self):
        return len(self._order)

    def __getitem__(self, i):
        return self._children[self._order[i]]


class Sequential(Container):
    """Forwards data through modules in order (paper A.4.2, Listing 8)."""

    def __init__(self, *modules: Module):
        super().__init__(*modules)

    def add(self, module: Module) -> "Sequential":
        name = f"m{len(self._order)}"
        setattr(self, name, module)
        self._order.append(name)
        return self

    def forward(self, x):
        for m in self:
            x = m(x)
        return x


class Lambda(Module):
    """Wraps a pure function of Variables as a Module."""

    def __init__(self, fn: Callable, name: str = "lambda"):
        super().__init__()
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_name", name)

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)
