"""paddle_tpu_torch.io — twin of ``paddle_tpu/io``: datasets, samplers,
the ``DataLoader`` with ``prefetch_to_device``, and the crash-consistent
``CheckpointStore``."""
from .checkpoint import SCHEMA_VERSION, CheckpointStore, leaf_checksums
from .dataloader import DataLoader, default_collate_fn, prefetch_to_device
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["CheckpointStore", "SCHEMA_VERSION", "leaf_checksums",
           "DataLoader", "default_collate_fn", "prefetch_to_device",
           "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]
