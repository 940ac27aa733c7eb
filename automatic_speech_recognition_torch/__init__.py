"""PyTorch / CUDA port of the LAS ASR framework, for one NVIDIA H100.

It mirrors the layout of `automatic_speech_recognition_tpu`, the JAX
package it is held against, and imports nothing of that package and
nothing of JAX.  The framework-free modules it needs (config, tokenizer,
text utilities, shards and the bucketed loader, the NumPy frontend
golden, the formant synthesizer) are its own copies at the same relative
paths, held to the originals by tests/test_torch_shared_copies.py.
Hand-written CUDA kernels live in `csrc/` and are built by nvcc at first
use (`ops/_kernels.py`); the shard and FLAC host libraries in `csrc/` are
built by the host C++ compiler (`data/_native.py`).
"""

__version__ = "0.1.0"
