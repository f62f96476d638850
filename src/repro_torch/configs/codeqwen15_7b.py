"""CodeQwen1.5 7B [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (kv=32, full MHA) d_ff=13440 vocab=92416,
qwen1.5-arch: RMSNorm + gated SiLU; rope_theta=1e6 for the 64k context.
"""

import torch

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416,
        rope_theta=1000000.0, norm="rmsnorm", act="silu",
        source="hf:Qwen/CodeQwen1.5-7B",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512,
        rope_theta=1000000.0, norm="rmsnorm", act="silu",
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
