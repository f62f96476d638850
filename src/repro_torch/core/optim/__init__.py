from .optimizer import (SGD, Adam, AdamW, Optimizer, SGDOptimizer,
                        clip_by_global_norm, cosine_schedule,
                        linear_schedule)

__all__ = ["SGD", "SGDOptimizer", "Adam", "AdamW", "Optimizer",
           "clip_by_global_norm", "cosine_schedule", "linear_schedule"]
