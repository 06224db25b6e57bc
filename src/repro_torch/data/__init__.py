"""Data pipelines: synthetic LM streams, memmap corpus, prefetch."""

from repro_torch.data.pipeline import MemmapCorpus, Prefetcher, SyntheticLM

__all__ = ["MemmapCorpus", "Prefetcher", "SyntheticLM"]
