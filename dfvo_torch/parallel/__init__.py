"""Several sequences at once on one GPU (the JAX package's mesh form does
not apply)."""

from .multiseq import MultiSeqRunner

__all__ = ["MultiSeqRunner"]
