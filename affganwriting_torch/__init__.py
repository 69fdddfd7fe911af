"""PyTorch/CUDA port of the word-level AFFGAN generate-and-recognize path.

Mirrors the module layout of ``affganwriting_tpu`` so each part can be found
beside its JAX counterpart.  Imports torch, numpy and the standard library
only; the JAX package is the reference it is tested against.
"""
