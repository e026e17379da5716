"""The data pipeline (the port of ``repro.data``)."""
from .pipeline import DataConfig, MemmapCorpus, SyntheticLM, write_corpus

__all__ = ["DataConfig", "MemmapCorpus", "SyntheticLM", "write_corpus"]
