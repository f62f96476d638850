from .transformer import LM


def build_model(cfg, device="cuda"):
    """Factory: ModelConfig -> model facade (dense decoder LMs only)."""
    return LM(cfg, device=device)


__all__ = ["LM", "build_model"]
