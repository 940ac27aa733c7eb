"""The port's own copy of automatic_speech_recognition_tpu/utils/numerics.py
(tests/test_torch_shared_copies.py holds it to the original).

Tiny shared numeric helpers."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceil division for non-negative integers."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round a up to the next multiple of b."""
    return cdiv(a, b) * b
