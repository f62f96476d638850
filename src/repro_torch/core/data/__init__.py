from .dataset import (BatchDataset, Dataset, PrefetchDataset, ShuffleDataset,
                      TensorDataset)
from .lm import ByteTokenizer, PackedLMDataset, synthetic_corpus

__all__ = ["BatchDataset", "Dataset", "PrefetchDataset", "ShuffleDataset",
           "TensorDataset",
           "ByteTokenizer", "PackedLMDataset", "synthetic_corpus"]
