"""Functional model layers (``repro.models.layers``) on torch tensors.

Projections route through the tensor dispatch (``ops.dot_general``), as
the reference's do, so a backend swap (``session(backend=...)``) reaches
the whole model zoo.  The default backend and ``HopperBackend`` run them
with ``torch.tensordot`` (cuBLAS on the card; the Hopper backend, like
the reference's Pallas backend, does not override ``dot_general``), and
the model's training differentiates them with torch's autograd.

``apply_norm`` runs the RMSNorm kernels through their autograd Function
(the plain versions on the CPU) whatever the backend.  That is the port's
rule, stricter than the reference's, whose ``apply_norm`` reaches its
kernel only under a backend that offers ``rms_norm_fused``: on the card
every path the port ships runs its kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tensor import ops as T
from repro_torch.kernels import ops as kops

from .meta import ParamMeta


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., D] @ [D, F] -> [..., F] through the dispatch layer."""
    nd = x.ndim
    dn = (((nd - 1,), (0,)), ((), ()))
    return T.dot_general(x, w, dn, preferred_element_type=None)


# -- norms ------------------------------------------------------------------

def norm_meta(cfg) -> dict[str, ParamMeta]:
    return {"scale": ParamMeta((cfg.d_model,), cfg.param_dtype, "ones")}


def apply_norm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm, eps 1e-6, fp32 inside, output in x's dtype;
    differentiable, its backward the RMSNorm backward kernel."""
    return kops.rms_norm_fn(x, p["scale"], 1e-6)


# -- embeddings ---------------------------------------------------------------

def embed_meta(cfg) -> ParamMeta:
    return ParamMeta((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                     "normal", 0.02)


def embed(table: torch.Tensor, ids: torch.Tensor, cfg) -> torch.Tensor:
    return table[ids].to(cfg.compute_dtype)


class _UnembedF32(torch.autograd.Function):
    """``x2 @ table^T`` of low-precision inputs returned in fp32 (cuBLAS
    accumulates in fp32 and skips the rounding to the inputs' dtype).
    ``torch.mm(..., out_dtype=)`` has no derivative, so the backward is
    two plain products: the fp32 gradient rounded to the inputs' dtype
    against the table and against x2.  That rounding of the logits'
    gradient is one step the reference's transpose (fp32 cotangent times
    the bf16 operand) does not take; it keeps both products on the bf16
    tensor cores, where fp32 products of [B*S, V] x [V, D] would cost
    ~12 TFLOP a step at the CUDA cores' fp32 rate.  The parity check of
    chip_smoke.py holds the resulting gradients against fp32 ones."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        g = g.to(x2.dtype)
        return torch.mm(g, table), torch.mm(g.t(), x2)


def unembed(x: torch.Tensor, table: torch.Tensor, cfg) -> torch.Tensor:
    """Logits ``[..., D] @ [V, D]^T`` in fp32: products of the inputs
    accumulated and returned in fp32, as the reference's
    ``preferred_element_type=float32``."""
    if x.is_cuda and x.dtype != torch.float32:
        logits = _UnembedF32.apply(x.reshape(-1, x.shape[-1]), table)
        logits = logits.reshape(*x.shape[:-1], table.shape[0])
    else:
        logits = torch.matmul(x.float(), table.float().t())
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# -- gated MLP ----------------------------------------------------------------

def mlp_meta(cfg) -> dict[str, ParamMeta]:
    dt = cfg.param_dtype
    m = {"w_up": ParamMeta((cfg.d_model, cfg.d_ff), dt, "fan_in"),
         "w_down": ParamMeta((cfg.d_ff, cfg.d_model), dt, "fan_in")}
    if cfg.act in ("silu", "geglu"):   # gated variants
        m["w_gate"] = ParamMeta((cfg.d_model, cfg.d_ff), dt, "fan_in")
    return m


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    up = linear(x, p["w_up"])
    if "w_gate" in p:
        act = _gelu if cfg.act == "geglu" else F.silu
        h = act(linear(x, p["w_gate"]).float()).to(x.dtype) * up
    else:
        h = _gelu(up.float()).to(x.dtype)
    return linear(h, p["w_down"])


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x ``[..., S, H, D]``, positions ``[..., S]``: rotate the two halves
    of the head dim (half-split, not interleaved)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [d/2]
    angles = positions[..., None].float() * freqs          # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x
