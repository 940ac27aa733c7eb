"""Wrapper of the fused frontend CUDA kernel (csrc/fused_frontend.cu).

The kernel replaces the TPU kernel
automatic_speech_recognition_tpu/ops/pallas_frontend.py:_fused_kernel and,
being frame-tiled, also its long-utterance route fused_frontend_chunked.
`fused_frontend` launches it for a CUDA tensor, or raises; a CPU tensor
goes to the plain version, ops/frontend.reference_features.

`plan` builds the kernel's constants and `tiling` pass 1's work split,
`stats_groups` the statistics kernel's frame grid, all in NumPy/Python, so
that the CPU tests rehearse the kernel's arithmetic from the very same
numbers (tests/test_torch_frontend.py).  The work split follows the batch
(B x frames) so that small batches fill the card; the statistics do not:
one block per utterance sums its frames over a grid that depends on
feat_dim alone, so a row's features are bit-for-bit the same whatever
batch it shares.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _kernels
from . import frontend
from . import frontend_host as host

_P = ctypes.c_void_p
_I = ctypes.c_int
# feat_dim limit of the kernel's CMVN pass (one block of 256 threads)
MAX_FEAT_DIM = 256
# threads of the statistics kernel's block (one utterance)
STATS_THREADS = 1024
# subsegments a frame may span before the kernel takes whole frames
MAX_SUBSEGMENTS = 16
# shared memory one block of pass 1 may use (one 512-thread block per SM)
SMEM_LIMIT = 232448
MAX_ROW_TILES = 2                     # 16-row MMA tiles in one work item
TEAMS = 2                             # 256-thread teams of a pass-1 block


def plan(flen: int, fstride: int, fft_length: int, feat_dim: int,
         feat_type: str, num_mel_filters: int, sample_rate: int):
    """The kernel's constants (NumPy, every array C-contiguous).

    The signal is cut into subsegments of g = gcd(flen, fstride) samples:
    frame t is subsegments step*t .. step*t + J - 1 (J = flen / g,
    step = fstride / g), so its DFT is
        X_t[k] = sum_j w^(g j k) A_(step t + j)[k],   w = e^(2 pi i k / N),
    where A_h is the g-point partial DFT of subsegment h.  When a frame
    would span more than MAX_SUBSEGMENTS subsegments the kernel takes
    whole frames instead ("framed": segments of flen samples every
    fstride, J = 1).

    bins: the mel-support bins lo..hi, then 0 and N/2 (the Parseval frame
    energy); nb: their count rounded up to 8; basis: (slen_pad, 2 nb), cos
    then sin of 2 pi n k / N, zero past slen and past the bins; twiddle:
    (J, nb, 2) cos/sin of 2 pi slen j k / N for every bin, the energy
    columns included; mel: the (ksup, F) filterbank rows lo..hi, and the
    same by filter in CSR (melptr, melbin, melw); dct: the (F, D) matrix
    flattened row-major (mfcc) or a placeholder (fbank)."""
    n_filters = num_mel_filters if feat_type == "mfcc" else feat_dim
    fb = host.mel_filterbank(n_filters, fft_length // 2 + 1, sample_rate,
                             0, sample_rate / 2)                  # (F, K)
    support = np.nonzero(fb.sum(axis=0))[0]
    lo, hi = int(support.min()), int(support.max())
    bins = np.concatenate([np.arange(lo, hi + 1), [0, fft_length // 2]])
    nbins = len(bins)
    nb = -(-nbins // 8) * 8
    g = math.gcd(flen, fstride)
    if flen // g <= MAX_SUBSEGMENTS:
        mode, slen, sstride, J, step = ("subsegment", g, g, flen // g,
                                        fstride // g)
    else:
        mode, slen, sstride, J, step = "framed", flen, fstride, 1, 1
    slen_pad = -(-slen // 8) * 8
    ang = 2.0 * np.pi * np.outer(np.arange(slen), bins) / fft_length
    basis = np.zeros((slen_pad, 2 * nb))
    basis[:slen, :nbins] = np.cos(ang)
    basis[:slen, nb:nb + nbins] = np.sin(ang)
    phi = 2.0 * np.pi * slen * np.outer(np.arange(J), bins) / fft_length
    twiddle = np.zeros((J, nb, 2))
    twiddle[:, :nbins, 0] = np.cos(phi)
    twiddle[:, :nbins, 1] = np.sin(phi)
    mel = fb.T[lo:hi + 1]                                         # (ksup, F)
    melbin = [np.nonzero(mel[:, f])[0] for f in range(n_filters)]
    melptr = np.concatenate([[0], np.cumsum([len(z) for z in melbin])])
    melw = np.concatenate([mel[z, f] for f, z in enumerate(melbin)])
    dct = (host.dct_matrix(n_filters, feat_dim).reshape(-1)
           if feat_type == "mfcc" else np.zeros((1,)))
    arrays = dict(bins=(bins, np.int32), basis=(basis, np.float32),
                  twiddle=(twiddle, np.float32), mel=(mel, np.float32),
                  melptr=(melptr, np.int32),
                  melbin=(np.concatenate(melbin), np.int32),
                  melw=(melw, np.float32), dct=(dct, np.float32))
    # C order: the kernel indexes each array row-major
    return dict({k: np.ascontiguousarray(a, dtype=t)
                 for k, (a, t) in arrays.items()},
                mode=mode, slen=slen, slen_pad=slen_pad, sstride=sstride,
                J=J, step=step, nbins=nbins, nb=nb, ksup=hi - lo + 1,
                F=n_filters)


def pass2_frames(feat_dim: int) -> int:
    """Frames of one pass-2 block (its 256 threads, one value each)."""
    return 256 // feat_dim if feat_dim < 256 else 1


def stats_groups(feat_dim: int) -> int:
    """Frame groups of the statistics kernel: thread (g, d) of an
    utterance's block sums frames g, g + G, ... of feature d, and thread d
    adds the G sums in order.  G depends on feat_dim alone."""
    return STATS_THREADS // feat_dim


def buffers(B: int, T: int, feat_dim: int, apply_cmvn: bool,
            device: torch.device):
    """The kernel's raw features (B, T, D), statistics scratch and output
    (B, T, D, 3) (the raw features themselves with cmvn off).  The
    scratch holds each utterance's mean and deviation (std + 2^-30),
    (B, 2, D): nothing in it depends on the tiling or frames_max."""
    empty = functools.partial(torch.empty, dtype=torch.float32, device=device)
    raw = empty((B, T, feat_dim))
    if not apply_cmvn:
        return raw, empty((1,)), raw
    return raw, empty((B, 2, feat_dim)), empty((B, T, feat_dim, 3))


class Tiling(NamedTuple):
    mt: int            # 16-row MMA tiles of segments in one work item
    tt: int            # frames of one work item
    n_tiles: int       # work items of one utterance
    basis_in_smem: bool
    smem: int          # bytes of dynamic shared memory of pass 1


def smem_bytes(p, mt: int, tt: int, feat_dim: int,
               basis_in_smem: bool) -> int:
    """Pass 1's shared memory, carved in this order by the kernel: basis
    (pitch 2 nb + 8), twiddles, the mel CSR and the DCT; then for each of
    the block's TEAMS: two segment buffers and the segments' TF32 lo parts
    (pitch slen_pad + 4; the power spectra reuse the lo parts), the
    partial DFTs (pitch 2 nb + 8; log-mel, features and log energies reuse
    them), segment energies.  The constants and each team's buffers start
    on 16 bytes."""
    rows, nb, F = 16 * mt, p["nb"], p["F"]
    lda, ldr = p["slen_pad"] + 4, 2 * nb + 8
    round4 = lambda n: -(-n // 4) * 4       # 16-byte starts
    team = round4(2 * rows * lda + max(rows * lda, tt * nb)
                  + max(rows * ldr, tt * (F + feat_dim + 1)) + rows)
    consts = round4((p["slen_pad"] * ldr if basis_in_smem else 0)
                    + 2 * p["J"] * nb + F + 1 + 2 * len(p["melw"])
                    + len(p["dct"]))
    return 4 * (consts + TEAMS * team)


def tiling_options(p, T: int, feat_dim: int) -> list:
    """Every work item pass 1 can take (mt 16-row tiles of segments, tt
    frames): those with the basis in shared memory first, each group
    largest first."""
    options = []
    for in_smem in (True, False):
        for mt in range(MAX_ROW_TILES, 0, -1):
            tt = (16 * mt - p["J"]) // p["step"] + 1
            smem = smem_bytes(p, mt, tt, feat_dim, in_smem)
            if tt >= 1 and smem <= SMEM_LIMIT:
                options.append(Tiling(mt, tt, -(-T // tt), in_smem, smem))
    if not options:
        raise ValueError("fused_frontend: this flen / fstride / fft_length "
                         "needs more shared memory than an SM has")
    return options


def tiling(p, B: int, T: int, num_sms: int, feat_dim: int) -> Tiling:
    """The largest work item, with the basis in shared memory if any size
    allows it, that still gives each of the TEAMS of every SM one; the
    smallest one when none does."""
    options = tiling_options(p, T, feat_dim)
    options = [t for t in options
               if t.basis_in_smem == options[0].basis_in_smem]
    for t in options:
        if B * t.n_tiles >= num_sms * TEAMS:
            return t
    return options[-1]


# the C entry point's argument types (pointers and the stream as void *)
ARGTYPES = {"asr_fused_frontend": [_P] * 11 + [_I] * 25 + [_P]}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _kernels.load("fused_frontend")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _device_plan(flen: int, fstride: int, fft_length: int, feat_dim: int,
                 feat_type: str, num_mel_filters: int, sample_rate: int,
                 device: torch.device):
    p = plan(flen, fstride, fft_length, feat_dim, feat_type,
             num_mel_filters, sample_rate)
    return {k: (torch.from_numpy(v).to(device)
                if isinstance(v, np.ndarray) else v) for k, v in p.items()}


@functools.lru_cache(maxsize=16)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _device_tiling(key: tuple, B: int, T: int,
                   device: torch.device) -> Tiling:
    """The tiling of a call's shape, from the cached device plan of `key`
    (the plan's arguments); cached, since a call's host time counts at
    serving's small shapes."""
    return tiling(_device_plan(*key, device), B, T, _num_sms(device), key[3])


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_frontend(audio: torch.Tensor, featlen: torch.Tensor, *, flen: int,
                   fstride: int, fft_length: int, feat_dim: int,
                   feat_type: str, num_mel_filters: int, sample_rate: int,
                   frames_max: int, apply_cmvn: bool,
                   work_split: Optional[Tiling] = None) -> torch.Tensor:
    """(B, S) padded audio + (B,) int32 frame counts -> (B, frames_max, D, 3)
    CMVN'd delta-stacked features, or (B, frames_max, D) raw features with
    cmvn off.  `work_split` forces pass 1's tiling (one of
    `tiling_options`; None: `tiling`'s pick for this shape); the result
    does not depend on it, which chip_smoke.py checks on the card."""
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
    key = (flen, fstride, fft_length, feat_dim, feat_type, num_mel_filters,
           sample_rate)
    p = _device_plan(*key, audio.device)
    T, D = frames_max, feat_dim
    if work_split is not None and work_split not in tiling_options(p, T, D):
        raise ValueError(f"fused_frontend: {work_split} is not a work split "
                         f"of this plan at frames_max {T}")
    tl = work_split or _device_tiling(key, B, T, audio.device)
    lib = _lib()
    raw, stats, out = buffers(B, T, D, apply_cmvn, audio.device)
    with torch.cuda.device(audio.device):
        rc = lib.asr_fused_frontend(
            audio.data_ptr(), featlen.data_ptr(), p["basis"].data_ptr(),
            p["twiddle"].data_ptr(), p["melptr"].data_ptr(),
            p["melbin"].data_ptr(), p["melw"].data_ptr(),
            p["dct"].data_ptr(), raw.data_ptr(), stats.data_ptr(),
            out.data_ptr(), B, S, T, fstride, fft_length, p["slen"],
            p["slen_pad"], p["sstride"], p["J"], p["step"], p["nbins"],
            p["nb"], p["ksup"], p["F"], D, len(p["melw"]), len(p["dct"]),
            int(feat_type == "mfcc"),
            int(apply_cmvn), tl.mt, tl.tt, tl.n_tiles, int(tl.basis_in_smem),
            tl.smem, min(-(-B * tl.n_tiles // TEAMS), _num_sms(audio.device)),
            _stream(audio.device))
    if rc != 0:
        raise RuntimeError(f"fused_frontend kernel launch failed: CUDA "
                           f"error {rc}")
    fused_frontend.launches += 1
    return out


fused_frontend.launches = 0

