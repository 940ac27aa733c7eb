"""PyTorch / CUDA port of the LAS ASR framework, for one NVIDIA H100.

It mirrors the layout of `automatic_speech_recognition_tpu`, the JAX
package it is held against, and imports that package's framework-free
modules (config, tokenizer, text utilities, the NumPy frontend golden)
instead of copying them.  It never imports JAX.  Hand-written CUDA
kernels live in `csrc/` and are built by nvcc at first use
(`ops/_kernels.py`).
"""

__version__ = "0.1.0"
