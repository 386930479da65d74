"""Deterministic synthetic datasets (numpy), as in ``repro.data``."""
from .synthetic import SyntheticImages, SyntheticLM  # noqa: F401
