"""Move trees between the reference and the port.

Weights, optimizer states and caches cross between the packages as
numpy: the caller maps ``np.asarray`` over a JAX tree and hands the
result here.  The layouts match leaf for leaf; a stage whose layers were
not scan-stacked (``{"r0": ..., "r1": ...}``) is stacked on a leading
layer axis, the port's only layout.  ``to_numpy`` goes the other way,
with bfloat16 leaves as their raw bits in ``uint16`` (the port does not
depend on ml_dtypes; ``.view(ml_dtypes.bfloat16)`` recovers them).
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device


def to_tensor(leaf, device: torch.device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: no numpy buffer type
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree(tree: Any, device, dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device, dtype) for v in tree]
    return to_tensor(tree, device, dtype)


def _stack_repeats(stage: dict) -> dict:
    """``{"r0": layer, "r1": layer, ...}`` -> one layer-stacked tree."""
    keys = sorted(stage, key=lambda k: int(k[1:]))
    layers = [stage[k] for k in keys]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return np.stack([np.asarray(l) for l in leaves])

    return stack(*layers)


def _stages(stages: list) -> list:
    return [_stack_repeats(s) if s and all(re.fullmatch(r"r\d+", k)
                                           for k in s) else s
            for s in stages]


def params_from_jax(tree: dict, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """Reference ``LM.init`` tree -> the port's parameters on ``device``
    (``dtype`` casts every leaf; None keeps the reference's)."""
    dev = resolve_device(device)
    out = {k: v for k, v in tree.items() if k != "stages"}
    out["stages"] = _stages(tree["stages"])
    return _tree(out, dev, dtype)


def opt_state_from_jax(tree: dict, device: str | torch.device = "cuda",
                       dtype: torch.dtype | None = None) -> dict:
    """Reference optimizer state (``Adam.init`` / ``apply`` over the
    params tree: ``{"m", "v"}`` at every parameter's place) -> the port's,
    on ``device``; stages are stacked as in ``params_from_jax``."""
    return params_from_jax(tree, device, dtype)


def to_numpy(tree: Any) -> Any:
    """Any port tree (dicts, lists, tuples of tensors) as numpy, on the
    host; bfloat16 leaves become ``uint16`` arrays of their bits."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def module_params(module, tree: dict) -> None:
    """Load a core-stack module's weights from the reference's: ``tree``
    maps each parameter name of the reference module's ``param_pytree()``
    (``m0.weight``, ``attn.wq.bias``, ...) to a numpy array; each becomes
    the data of the port module's ``Variable`` of that name, in that
    Variable's dtype and on its device.  The names must match exactly."""
    own = dict(module.named_params())
    if set(own) != set(tree):
        raise KeyError(f"parameter names differ: only in the port "
                       f"{sorted(set(own) - set(tree))}, only in the tree "
                       f"{sorted(set(tree) - set(own))}")
    for name, var in own.items():
        var.data = to_tensor(tree[name], var.data.device, var.data.dtype)


def cache_from_jax(pools: list, device: str | torch.device = "cuda",
                   dtype: torch.dtype | None = None) -> list:
    """Reference paged cache (``LM.init_paged_cache``) -> the port's
    pools: per stage ``{"k", "v"}`` of ``[layers, P, Kv, D]``."""
    return _tree(_stages(pools), resolve_device(device), dtype)
