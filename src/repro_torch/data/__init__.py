"""Data pipeline: deterministic, resumable token streams."""
from .pipeline import DataConfig, TokenStream, synthetic_corpus

__all__ = ["DataConfig", "TokenStream", "synthetic_corpus"]
