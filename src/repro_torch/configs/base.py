"""Model configuration for the port: the dense-GQA fields of
``repro.configs.base.ModelConfig``.

Precision is part of the config (``param_dtype`` / ``compute_dtype`` are
torch dtypes).  ``get_config`` applies the session's precision policy
over the architecture's defaults, as the reference does; explicit
overrides beat both.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None      # default d_model // n_heads
    attention: str = "gqa"           # gqa (mla is not ported)
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    act: str = "silu"                # silu | geglu (gated) | gelu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # multi-token prediction depth (deepseek-v3 MTP); only 0 is ported
    mtp_depth: int = 0
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    # training knobs, the reference's defaults
    remat: str = "full"              # none | full (dots is not ported)
    scan_layers: bool = True         # remat applies to scanned stages
    attention_impl: str = "ref"      # ref | blockwise | pallas (the card
                                     # runs the flash kernel for all three)
    ce_impl: str = "dense"           # dense | chunked  (chunked = low-mem CE)
    source: str = ""                 # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def resolved_cache_dtype(self) -> torch.dtype:
        """KV caches hold the compute dtype (fp8 storage is not ported)."""
        return self.compute_dtype

    def layer_kind(self, i: int) -> str:
        """'A' attention(+mlp) for every layer of a dense config."""
        return "M" if self.family == "ssm" else "A"

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


ARCHS: tuple[str, ...] = ("codeqwen15_7b",)

_ALIAS = {"codeqwen1.5-7b": "codeqwen15_7b", "codeqwen15-7b": "codeqwen15_7b"}


def get_config(arch: str, reduced: bool = False, **overrides) -> ModelConfig:
    mod_name = _ALIAS.get(arch, arch)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown or unported arch {arch!r}; "
                         f"ported: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.reduced_config() if reduced else mod.config()
    cfg = _apply_session_precision(cfg)
    return cfg.with_(**overrides) if overrides else cfg


def _apply_session_precision(cfg: ModelConfig) -> ModelConfig:
    """The session's precision policy beats the arch default.  The port's
    caches hold the compute dtype, so ``cache_dtype="fp8"`` is refused."""
    from repro_torch.runtime import current_session, resolve_dtype

    pol = current_session().precision
    if pol.cache_dtype not in (None, "compute"):
        raise NotImplementedError(
            f"cache_dtype {pol.cache_dtype!r}: fp8 KV storage is not ported "
            "yet (ROADMAP queue 1 item 2)")
    changes: dict = {}
    if pol.param_dtype is not None:
        changes["param_dtype"] = resolve_dtype(pol.param_dtype)
    if pol.compute_dtype is not None:
        changes["compute_dtype"] = resolve_dtype(pol.compute_dtype)
    return cfg.with_(**changes) if changes else cfg


def list_archs() -> list[str]:
    return [a.replace("_", "-") for a in ARCHS]
