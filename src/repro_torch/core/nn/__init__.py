from .module import Module, Container, Sequential, Lambda
from .layers import (Linear, Embedding, LayerNorm, RMSNorm, Dropout, ReLU,
                     GELU, SiLU, Tanh, LogSoftmax, Conv2D, Pool2D, View,
                     MultiHeadAttention, TransformerBlock,
                     categoricalCrossEntropy, mse_loss)

__all__ = ["Module", "Container", "Sequential", "Lambda", "Linear",
           "Embedding", "LayerNorm", "RMSNorm", "Dropout", "ReLU", "GELU",
           "SiLU", "Tanh", "LogSoftmax", "Conv2D", "Pool2D", "View",
           "MultiHeadAttention", "TransformerBlock",
           "categoricalCrossEntropy", "mse_loss"]
