from .pipeline import MemmapCorpus, Prefetcher, SyntheticLM

__all__ = ["MemmapCorpus", "Prefetcher", "SyntheticLM"]
