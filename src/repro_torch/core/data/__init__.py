from .dataset import BatchDataset, Dataset, PrefetchDataset, ShuffleDataset
from .lm import ByteTokenizer, PackedLMDataset, synthetic_corpus

__all__ = ["BatchDataset", "Dataset", "PrefetchDataset", "ShuffleDataset",
           "ByteTokenizer", "PackedLMDataset", "synthetic_corpus"]
