from .optimizer import (Adam, AdamW, Optimizer, clip_by_global_norm,
                        cosine_schedule, linear_schedule)

__all__ = ["Adam", "AdamW", "Optimizer", "clip_by_global_norm",
           "cosine_schedule", "linear_schedule"]
