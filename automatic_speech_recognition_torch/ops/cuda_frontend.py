"""Wrapper of the fused frontend CUDA kernel (csrc/fused_frontend.cu).

The kernel replaces the TPU kernel
automatic_speech_recognition_tpu/ops/pallas_frontend.py:_fused_kernel and,
being frame-tiled, also its long-utterance route fused_frontend_chunked.
`fused_frontend` launches it for a CUDA tensor, or raises; a CPU tensor
goes to the plain version, ops/frontend.reference_features.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from automatic_speech_recognition_tpu.ops import frontend_host as host

from . import _kernels
from . import frontend

_P = ctypes.c_void_p
_I = ctypes.c_int
# feat_dim limit of the kernel's CMVN pass (one block of 256 threads)
MAX_FEAT_DIM = 256


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("fused_frontend")
    fn = lib.asr_fused_frontend
    fn.argtypes = [_P] * 8 + [_I] * 12 + [_P]
    fn.restype = ctypes.c_int
    return lib


def plan(fft_length: int, feat_dim: int, feat_type: str,
         num_mel_filters: int, sample_rate: int):
    """The kernel's constants (NumPy).  bins: the mel-support bins lo..hi,
    then 0 and N/2 for the Parseval frame energy; twiddle: (N, 2) cos/sin
    of 2 pi m / N; mel: (ksup, F) filterbank rows lo..hi; dct: (F, D)
    (mfcc) or a placeholder (fbank)."""
    n_filters = num_mel_filters if feat_type == "mfcc" else feat_dim
    fb = host.mel_filterbank(n_filters, fft_length // 2 + 1, sample_rate,
                             0, sample_rate / 2)                  # (F, K)
    support = np.nonzero(fb.sum(axis=0))[0]
    lo, hi = int(support.min()), int(support.max())
    bins = np.concatenate([np.arange(lo, hi + 1), [0, fft_length // 2]])
    ang = 2.0 * np.pi * np.arange(fft_length) / fft_length
    dct = (host.dct_matrix(n_filters, feat_dim) if feat_type == "mfcc"
           else np.zeros((1,)))
    arrays = dict(bins=(bins, np.int32),
                  twiddle=(np.stack([np.cos(ang), np.sin(ang)], 1),
                           np.float32),
                  mel=(fb.T[lo:hi + 1], np.float32), dct=(dct, np.float32))
    # C order: the kernel indexes each array row-major
    return dict({k: np.ascontiguousarray(a, dtype=t)
                 for k, (a, t) in arrays.items()},
                ksup=hi - lo + 1, F=n_filters)


@functools.lru_cache(maxsize=16)
def _device_plan(fft_length: int, feat_dim: int, feat_type: str,
                 num_mel_filters: int, sample_rate: int,
                 device: torch.device):
    p = plan(fft_length, feat_dim, feat_type, num_mel_filters, sample_rate)
    return {k: (torch.from_numpy(v).to(device)
                if isinstance(v, np.ndarray) else v) for k, v in p.items()}


def fused_frontend(audio: torch.Tensor, featlen: torch.Tensor, *, flen: int,
                   fstride: int, fft_length: int, feat_dim: int,
                   feat_type: str, num_mel_filters: int, sample_rate: int,
                   frames_max: int, apply_cmvn: bool) -> torch.Tensor:
    """(B, S) padded audio + (B,) int32 frame counts -> (B, frames_max, D, 3)
    CMVN'd delta-stacked features, or (B, frames_max, D) raw features with
    cmvn off."""
    kw = dict(flen=flen, fstride=fstride, fft_length=fft_length,
              feat_dim=feat_dim, feat_type=feat_type,
              num_mel_filters=num_mel_filters, sample_rate=sample_rate,
              frames_max=frames_max, apply_cmvn=apply_cmvn)
    if audio.device.type == "cpu":
        return frontend.reference_features(audio, featlen, **kw)
    if audio.device.type != "cuda":
        raise ValueError(f"fused_frontend: unsupported device {audio.device}")
    if audio.dtype != torch.float32 or audio.dim() != 2 \
            or not audio.is_contiguous():
        raise ValueError("fused_frontend: audio must be a contiguous (B, S) "
                         f"float32 tensor, got {tuple(audio.shape)} "
                         f"{audio.dtype}")
    B, S = audio.shape
    if featlen.device != audio.device or featlen.dtype != torch.int32 \
            or tuple(featlen.shape) != (B,) or not featlen.is_contiguous():
        raise ValueError("fused_frontend: featlen must be a contiguous (B,) "
                         "int32 tensor on the audio's device")
    if feat_type not in ("mfcc", "fbank"):
        raise ValueError(f"unknown feat_type: {feat_type}")
    if fft_length & (fft_length - 1) or not 0 < flen <= fft_length \
            or fstride <= 0 or S <= 0 or B <= 0 or frames_max <= 0:
        raise ValueError("fused_frontend: needs a power-of-two fft_length "
                         ">= flen > 0, fstride > 0 and non-empty shapes")
    if not 0 < feat_dim <= MAX_FEAT_DIM:
        raise ValueError(f"fused_frontend: feat_dim must be in "
                         f"[1, {MAX_FEAT_DIM}], got {feat_dim}")
    p = _device_plan(fft_length, feat_dim, feat_type, num_mel_filters,
                     sample_rate, audio.device)
    lib = _lib()
    T, D = frames_max, feat_dim
    raw = torch.empty((B, T, D), dtype=torch.float32, device=audio.device)
    out = (torch.empty((B, T, D, 3), dtype=torch.float32, device=audio.device)
           if apply_cmvn else raw)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        rc = lib.asr_fused_frontend(
            audio.data_ptr(), featlen.data_ptr(), p["bins"].data_ptr(),
            p["twiddle"].data_ptr(), p["mel"].data_ptr(),
            p["dct"].data_ptr(), raw.data_ptr(), out.data_ptr(), B, S, T,
            flen, fstride, fft_length, len(p["bins"]), p["ksup"], p["F"], D,
            int(feat_type == "mfcc"), int(apply_cmvn), stream)
    if rc != 0:
        raise RuntimeError(f"fused_frontend kernel launch failed: CUDA "
                           f"error {rc}")
    fused_frontend.launches += 1
    return out


fused_frontend.launches = 0
