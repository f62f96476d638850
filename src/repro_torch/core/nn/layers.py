"""Neural building blocks (``repro.core.nn.layers``; paper §4.2:
activations, norms, regularizers, losses, …) — compact reference
implementations over the tensor dispatch + tape autograd, so they inherit
backend swaps and autograd customization.

Parameters are fp32, created on ``device`` (the card unless the caller
asks for the CPU).  Initialisation draws from an explicit
``torch.Generator`` (``key``; an int seeds one, None takes the next of a
process-wide counter, as the reference takes ``PRNGKey(counter)``) on the
host, so a seed gives the same weights on either device.  The draws
differ from ``jax.random``'s; parity tests carry the reference's weights
across with ``repro_torch.convert.module_params``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..autograd import Variable
from ..autograd import functions as F
from ..tensor import ops
from .module import Module


class _RngMixin:
    """Deterministic per-module RNG stream for dropout etc."""

    _rng_counter = 0

    @classmethod
    def _next_key(cls) -> torch.Generator:
        cls._rng_counter += 1
        return torch.Generator().manual_seed(cls._rng_counter)


def _generator(key) -> torch.Generator:
    if key is None:
        return _RngMixin._next_key()
    if isinstance(key, int):
        return torch.Generator().manual_seed(key)
    return key


def _uniform_init(key, shape, fan_in, device):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 1.0
    return ops.random_uniform(key, shape, torch.float32, -bound, bound,
                              device)


def _param(data) -> Variable:
    return Variable(data, requires_grad=True)


class Linear(Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 key=None, device="cuda"):
        super().__init__()
        key = _generator(key)
        self.weight = _param(_uniform_init(key, (in_features, out_features),
                                           in_features, device))
        if bias:
            self.bias = _param(ops.zeros((out_features,), device=device))
        else:
            object.__setattr__(self, "bias", None)

    def forward(self, x: Variable) -> Variable:
        out = F.matmul(x, self.weight)
        if self.bias is not None:
            out = F.add(out, self.bias)
        return out


class Embedding(Module):
    def __init__(self, num_embeddings: int, dim: int, key=None,
                 device="cuda"):
        super().__init__()
        normal = ops.random_normal(_generator(key), (num_embeddings, dim),
                                   device=device)
        self.weight = _param(ops.mul(normal, ops.full_like(normal, 0.02)))

    def forward(self, ids) -> Variable:
        return F.embedding(self.weight, ids)


class LayerNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-5, device="cuda"):
        super().__init__()
        self.weight = _param(ops.ones((dim,), device=device))
        self.bias = _param(ops.zeros((dim,), device=device))
        object.__setattr__(self, "eps", eps)

    def forward(self, x: Variable) -> Variable:
        return F.layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        self.weight = _param(ops.ones((dim,), device=device))
        object.__setattr__(self, "eps", eps)

    def forward(self, x: Variable) -> Variable:
        return F.rms_norm(x, self.weight, self.eps)


class Dropout(Module):
    """Paper Listing 6, ported verbatim in behavior."""

    def __init__(self, drop_ratio: float = 0.5):
        super().__init__()
        object.__setattr__(self, "ratio", drop_ratio)

    def forward(self, x: Variable) -> Variable:
        if self.training and self.ratio > 0.0:
            return F.dropout(x, self.ratio, _RngMixin._next_key())
        return x


class ReLU(Module):
    def forward(self, x):
        return F.relu(x)


class GELU(Module):
    def forward(self, x):
        return F.gelu(x)


class SiLU(Module):
    def forward(self, x):
        return F.silu(x)


class Tanh(Module):
    def forward(self, x):
        return F.tanh(x)


class LogSoftmax(Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        object.__setattr__(self, "axis", axis)

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class Conv2D(Module):
    """NHWC conv (paper Listing 8 signature flavor)."""

    def __init__(self, in_channels: int, out_channels: int, kw: int, kh: int,
                 sx: int = 1, sy: int = 1, padding: str = "SAME", key=None,
                 device="cuda"):
        super().__init__()
        fan_in = in_channels * kw * kh
        self.weight = _param(_uniform_init(
            _generator(key), (kh, kw, in_channels, out_channels), fan_in,
            device))
        self.bias = _param(ops.zeros((out_channels,), device=device))
        object.__setattr__(self, "stride", (sy, sx))
        object.__setattr__(self, "padding", padding)

    def forward(self, x: Variable) -> Variable:
        out = F.conv2d(x, self.weight, stride=self.stride,
                       padding=self.padding)
        return F.add(out, self.bias)


class Pool2D(Module):
    """Max pool over NHWC ("VALID" windows), lifted: the reference lifts
    ``lax.reduce_window``, the port ``max_pool2d``."""

    def __init__(self, kw: int, kh: int, sx: int, sy: int):
        super().__init__()
        object.__setattr__(self, "window", (kh, kw))
        object.__setattr__(self, "stride", (sy, sx))

    def forward(self, x: Variable) -> Variable:
        window, stride = self.window, self.stride

        def pool(v):
            return TF.max_pool2d(v.permute(0, 3, 1, 2), window,
                                 stride).permute(0, 2, 3, 1)

        return F.lift(pool, name="pool2d")(x)


class View(Module):
    def __init__(self, shape):
        super().__init__()
        object.__setattr__(self, "shape", tuple(shape))

    def forward(self, x: Variable) -> Variable:
        return F.reshape(x, self.shape)


class MultiHeadAttention(Module):
    """Reference MHA for the core stack (BERT-like/ViT-like benchmarks)."""

    def __init__(self, dim: int, num_heads: int, key=None, device="cuda"):
        super().__init__()
        key = _generator(key)
        self.wq = Linear(dim, dim, key=key, device=device)
        self.wk = Linear(dim, dim, key=key, device=device)
        self.wv = Linear(dim, dim, key=key, device=device)
        self.wo = Linear(dim, dim, key=key, device=device)
        object.__setattr__(self, "num_heads", num_heads)
        object.__setattr__(self, "head_dim", dim // num_heads)

    def forward(self, x: Variable, mask=None) -> Variable:
        b, s, d = x.shape
        h, hd = self.num_heads, self.head_dim

        def split(v):
            return F.transpose(F.reshape(v, (b, s, h, hd)), (0, 2, 1, 3))

        q, k, v = split(self.wq(x)), split(self.wk(x)), split(self.wv(x))
        kt = F.transpose(k, (0, 1, 3, 2))
        scores = F.mul(F.matmul(q, kt),
                       Variable(ops.full((), 1.0 / math.sqrt(hd),
                                         device=x.data.device)))
        if mask is not None:
            scores = F.add(scores, Variable(mask))
        attn = F.softmax(scores, axis=-1)
        out = F.matmul(attn, v)
        out = F.reshape(F.transpose(out, (0, 2, 1, 3)), (b, s, d))
        return self.wo(out)


class TransformerBlock(Module):
    def __init__(self, dim: int, num_heads: int, ff_mult: int = 4, key=None,
                 device="cuda"):
        super().__init__()
        key = _generator(key)
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, key=key, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.ff1 = Linear(dim, dim * ff_mult, key=key, device=device)
        self.ff2 = Linear(dim * ff_mult, dim, key=key, device=device)

    def forward(self, x: Variable, mask=None) -> Variable:
        x = F.add(x, self.attn(self.ln1(x), mask=mask))
        return F.add(x, self.ff2(F.gelu(self.ff1(self.ln2(x)))))


# -- losses -------------------------------------------------------------------

def categoricalCrossEntropy(logits: Variable, target) -> Variable:  # noqa: N802
    """Paper-faithful name (Listing 9)."""
    return F.cross_entropy(logits, target)


def mse_loss(pred: Variable, target) -> Variable:
    t = target if isinstance(target, Variable) else Variable(target)
    d = F.sub(pred, t)
    return F.mean(F.mul(d, d))
