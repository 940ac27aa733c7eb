"""Port frontend (automatic_speech_recognition_torch/ops/frontend.py and the
fused CUDA kernel's wrapper) against the JAX package's frontend.

The same NumPy inputs go through the JAX function (XLA path, and the Pallas
kernel in interpret mode as tests/test_pallas_frontend.py runs it) and the
port.  Tolerance rtol 1e-4 / atol 2e-4: the one the TPU kernel is held to
(tests/test_pallas_frontend.py) — float32 sums in another order.  The
kernel itself is checked on the card by tests/test_torch_cuda.py.
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.data.audio_io import read_audio
from automatic_speech_recognition_tpu.ops import frontend as jfe
from automatic_speech_recognition_tpu.ops import frontend_host as host
from automatic_speech_recognition_torch.ops import cuda_frontend
from automatic_speech_recognition_torch.ops import frontend as tfe

RTOL, ATOL = 1e-4, 2e-4
SR = 16000
FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _batch(rng, S=SR * 2 + 1234):
    audio = (rng.standard_normal((3, S)) * 0.1).astype(np.float32)
    # full, ragged, and sub-frame (featlen 0) rows
    return audio, np.array([S, S - 9000, 300], np.int32)


def _port(audio, audiolen, **kw):
    f, l = tfe.extract_features(torch.from_numpy(audio),
                                torch.from_numpy(audiolen), **kw)
    return f.numpy(), l.numpy()


@pytest.mark.parametrize("frames_max", [0, 150])
@pytest.mark.parametrize("apply_cmvn", [True, False])
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_plain_matches_jax_xla(rng, feat_type, apply_cmvn, frames_max):
    audio, audiolen = _batch(rng)
    kw = dict(feat_dim=13, feat_type=feat_type, apply_cmvn=apply_cmvn,
              frames_max=frames_max)
    fj, lj = jfe.extract_features(audio, audiolen, **kw)
    ft, lt = _port(audio, audiolen, **kw)
    np.testing.assert_array_equal(np.asarray(lj), lt)
    assert ft.shape == np.asarray(fj).shape
    np.testing.assert_allclose(ft, np.asarray(fj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("apply_cmvn", [True, False])
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_kernel_route_matches_jax_pallas(rng, feat_type, apply_cmvn):
    """The kernel route (plain path for a CPU tensor) vs the Pallas kernel
    in interpret mode, ragged lengths included."""
    audio, audiolen = _batch(rng)
    kw = dict(feat_dim=13, feat_type=feat_type, apply_cmvn=apply_cmvn)
    fj, lj = jfe.extract_features(audio, audiolen, use_pallas=True, **kw)
    ft, lt = _port(audio, audiolen, use_kernel=True, **kw)
    np.testing.assert_array_equal(np.asarray(lj), lt)
    np.testing.assert_allclose(ft, np.asarray(fj), rtol=RTOL, atol=ATOL)


def test_frames_max_truncation_zeroes_the_tail(rng):
    audio = (rng.standard_normal((2, SR)) * 0.1).astype(np.float32)
    audiolen = np.full((2,), SR, np.int32)
    fj, lj = jfe.extract_features(audio, audiolen, feat_dim=13,
                                  frames_max=500, use_pallas=True)
    ft, lt = _port(audio, audiolen, feat_dim=13, frames_max=500,
                   use_kernel=True)
    assert ft.shape[1] == 500
    np.testing.assert_array_equal(np.asarray(lj), lt)
    assert np.all(ft[0, int(lt[0]):] == 0.0)
    np.testing.assert_allclose(ft, np.asarray(fj), rtol=RTOL, atol=ATOL)


def test_long_utterance_beyond_the_old_vmem_limit(rng):
    """frames_max = 1710 + 500: the JAX kernel chunks here, the port's
    frame-tiled kernel needs no chunking (same plain reference)."""
    flen, fstride, frames_max = 400, 160, 1710 + 500
    S = frames_max * fstride + flen
    audio = (rng.standard_normal((2, S)) * 0.1).astype(np.float32)
    audiolen = np.array([S, S // 2], np.int32)
    kw = dict(feat_dim=13, frames_max=frames_max)
    fj, lj = jfe.extract_features(audio, audiolen, **kw)
    ft, lt = _port(audio, audiolen, use_kernel=True, **kw)
    np.testing.assert_array_equal(np.asarray(lj), lt)
    np.testing.assert_allclose(ft, np.asarray(fj), rtol=RTOL, atol=ATOL)


def test_plain_matches_host_golden_on_real_audio():
    sig, sr = read_audio(str(FIXTURES / "pluck-pcm16.wav"))
    sig = np.asarray(sig, np.float32)
    want = host.process_audio(sig.astype(np.float64), sr, 25, 10, 13,
                              "mfcc", True)
    ft, lt = _port(sig[None, :], np.array([len(sig)], np.int32),
                   feat_dim=13, sample_rate=sr)
    T = want.shape[0]
    assert int(lt[0]) == T
    np.testing.assert_allclose(ft[0, :T], want, rtol=5e-3, atol=5e-3)


def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest (ties away from zero) on the low
    13 mantissa bits."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_tf32(a, b, passes=3):
    """The kernel's tensor-core product: 3xTF32 (lo*hi + hi*lo + hi*hi,
    float32 sums), or one TF32 pass."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _chan(acc, part):
    """Chan et al.'s merge of (count, mean, M2) partials, as the kernel."""
    (n, m, m2), (nb, mb, m2b) = acc, part
    nn = n + nb
    safe = np.where(nn > 0, nn, 1).astype(np.float32)
    delta = mb - m
    m_new = np.where(n == 0, mb, m + delta * (nb / safe))
    m2_new = np.where(n == 0, m2b, m2 + m2b + delta * delta * (n * nb / safe))
    keep = nb == 0
    return (np.where(keep, n, nn).astype(np.float32),
            np.where(keep, m, m_new).astype(np.float32),
            np.where(keep, m2, m2_new).astype(np.float32))


def _emulate_kernel(audio, featlen, T, feat_type, apply_cmvn, sr=SR,
                    num_sms=132, passes=3):
    """NumPy float32 model of csrc/fused_frontend.cu's arithmetic, from
    cuda_frontend.plan's constants and cuda_frontend.tiling's work split:
    per work item, the segment rows' partial DFTs by 3xTF32, the twiddle
    combine, Parseval energy, sparse mel, DCT with c0 = log energy, and
    the per-tile (count, mean, M2); then pass 2's fixed-order Chan merge,
    normalization and deltas."""
    flen, fstride = host.frame_params(sr, 25, 10)
    p = cuda_frontend.plan(flen, fstride, 512, 13, feat_type, 40, sr)
    B, S = audio.shape
    D = 13
    tl = cuda_frontend.tiling(p, B, T, num_sms, D)
    rows, tt, nt = 16 * tl.mt, tl.tt, tl.n_tiles
    nb, J, step = p["nb"], p["J"], p["step"]
    # (n_tiles, rows, slen_pad) sample indices, clamped at S - 1
    s = (np.arange(nt)[:, None, None] * tt * fstride
         + np.arange(rows)[None, :, None] * p["sstride"]
         + np.arange(p["slen_pad"])[None, None, :])
    seg = audio[:, np.minimum(s, S - 1)]
    seg[..., p["slen"]:] = 0.0
    A = _matmul_tf32(seg, p["basis"], passes)        # (B, nt, rows, 2 nb)
    q = (seg * seg).sum(-1)                          # (B, nt, rows)
    h = np.arange(tt)[:, None] * step + np.arange(J)[None, :]   # (tt, J)
    ac, as_ = A[..., h, :nb], A[..., h, nb:]         # (B, nt, tt, J, nb)
    pc, ps_ = p["twiddle"][..., 0], p["twiddle"][..., 1]        # (J, nb)
    re = (ac * pc - as_ * ps_).sum(-2)
    im = (ac * ps_ + as_ * pc).sum(-2)
    ps = ((re * re + im * im) / np.float32(512))[..., :p["nbins"]]
    mel = np.stack([(ps[..., p["melbin"][a:b]] * p["melw"][a:b]).sum(-1)
                    for a, b in zip(p["melptr"][:-1], p["melptr"][1:])], -1)
    mel = np.where(mel < tfe.FLT_MIN, np.float32(tfe.EPS_ZERO), mel)
    ks = p["ksup"]
    if feat_type == "mfcc":
        feat = np.log(mel) @ p["dct"].reshape(p["F"], D)
        e = 0.5 * q[..., h].sum(-1) + 0.5 * (ps[..., ks] + ps[..., ks + 1])
        feat[..., 0] = np.log(np.where(e < tfe.FLT_MIN,
                                       np.float32(tfe.EPS_ZERO), e))
    else:
        feat = mel
    feat = feat.astype(np.float32)                   # (B, nt, tt, D)
    if not apply_cmvn:
        return feat.reshape(B, nt * tt, D)[:, :T]
    fl = np.clip(featlen, 0, T)
    # pass 1's partials: count, mean, M2 of the frames < featlen
    n = np.clip(fl[:, None] - np.arange(nt)[None, :] * tt, 0, tt)
    m = (np.arange(tt)[None, None, :] < n[..., None]).astype(np.float32)
    cnt = n.astype(np.float32)[..., None]
    mean = (feat * m[..., None]).sum(2) / np.maximum(cnt, 1)
    c = (feat - mean[:, :, None]) * m[..., None]
    m2 = (c * c).sum(2)
    out = np.zeros((B, nt * tt, D, 3), np.float32)
    groups = 256 // D
    for b in range(B):
        n_valid = -(-int(fl[b]) // tt)
        parts = []
        for g in range(groups):
            acc = (np.zeros(D, np.float32),) * 3
            for i in range(g, n_valid, groups):
                acc = _chan(acc, (np.full(D, cnt[b, i, 0]), mean[b, i],
                                  m2[b, i]))
            parts.append(acc)
        acc = (np.zeros(D, np.float32),) * 3
        for part in parts:
            acc = _chan(acc, part)
        den = np.sqrt(acc[2] / max(acc[0][0], 1)) + np.float32(tfe.EPS_CMVN)
        x = (feat[b].reshape(-1, D) - acc[1]) / den
        out[b] = tfe.stack_derivatives(torch.from_numpy(
            x.astype(np.float32))[None])[0].numpy()
        out[b, fl[b]:] = 0.0
    return out[:, :T]


# sample rate -> (frame parameters, kernel mode): 16 kHz has g = 80;
# 15 kHz an odd g = 75; at 11025 Hz g = 2, so the plan takes whole frames
RATES = {16000: "subsegment", 15000: "subsegment", 11025: "framed"}


def _rehearsal_batch(rng, sr, num_sms, S):
    """Rows that end on a tile edge, mid-tile, below one frame, and full."""
    flen, fstride = host.frame_params(sr, 25, 10)
    p = cuda_frontend.plan(flen, fstride, 512, 13, "mfcc", 40, sr)
    T = host.num_frames(S, flen, fstride)
    tt = cuda_frontend.tiling(p, 4, T, num_sms, 13).tt
    frames = [2 * tt, 2 * tt + tt // 2 + 1]
    lens = [f * fstride + flen for f in frames] + [flen - 1, S]
    audio = (rng.standard_normal((4, S)) * 0.1).astype(np.float32)
    return audio, np.array(lens, np.int32), frames


@pytest.mark.parametrize("num_sms", [132, 8])
@pytest.mark.parametrize("sr", sorted(RATES))
@pytest.mark.parametrize("apply_cmvn", [True, False])
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_kernel_plan_reproduces_the_plain_path(rng, feat_type, apply_cmvn,
                                               sr, num_sms):
    """The CPU rehearsal of the kernel's arithmetic against the plain
    version (rtol 1e-4 / atol 2e-4), at small and large work items."""
    audio, audiolen, frames = _rehearsal_batch(rng, sr, num_sms, 2 * sr + 77)
    ft, lt = _port(audio, audiolen, feat_dim=13, feat_type=feat_type,
                   apply_cmvn=apply_cmvn, sample_rate=sr)
    assert lt.tolist()[:3] == frames + [0]
    got = _emulate_kernel(audio, lt, ft.shape[1], feat_type, apply_cmvn, sr,
                          num_sms)
    assert got.shape == ft.shape
    np.testing.assert_allclose(got, ft, rtol=RTOL, atol=ATOL)


def _ringing_batch(rng, S=2 * SR):
    """Noise rows, two with a stretch of frames holding only a few samples
    of about 1e-22 (a resampler's ringing over digital silence): their
    power and energy are subnormal in float32."""
    audio = (rng.standard_normal((4, S)) * 0.1).astype(np.float32)
    for r in (0, 2):
        audio[r, 1600:6400] = 0.0
        audio[r, 1600:6400:700] = 4.4e-22
    return audio, np.array([S, S, S - 999, S // 2], np.int32)


@pytest.mark.parametrize("apply_cmvn", [True, False])
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_subnormal_power_counts_as_zero(rng, feat_type, apply_cmvn):
    """A frame of ringing-level samples: its subnormal mel sums and energy
    take speechpy's eps in the plain version, and the kernel's arithmetic
    (Parseval energy from the time domain, which keeps the subnormal the
    plain per-bin power underflows) agrees with it."""
    audio, audiolen = _ringing_batch(rng)
    ft, lt = _port(audio, audiolen, feat_dim=13, feat_type=feat_type,
                   apply_cmvn=False)
    quiet = ft[0, 12:28]
    if feat_type == "mfcc":
        np.testing.assert_allclose(quiet[:, 0], np.log(tfe.EPS_ZERO),
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(quiet, np.float32(tfe.EPS_ZERO))
    ft, lt = _port(audio, audiolen, feat_dim=13, feat_type=feat_type,
                   apply_cmvn=apply_cmvn)
    got = _emulate_kernel(audio, lt, ft.shape[1], feat_type, apply_cmvn)
    np.testing.assert_allclose(got, ft, rtol=RTOL, atol=ATOL)


def test_one_tf32_pass_is_not_enough(rng):
    """Why 3xTF32: one TF32 pass misses rtol 1e-4 / atol 2e-4 on the same
    rehearsal, three pass it."""
    audio, audiolen, _ = _rehearsal_batch(rng, SR, 8, 2 * SR)
    ft, lt = _port(audio, audiolen, feat_dim=13)
    errs = {}
    for passes in (1, 3):
        got = _emulate_kernel(audio, lt, ft.shape[1], "mfcc", True,
                              passes=passes)
        errs[passes] = np.abs(got - ft) - RTOL * np.abs(ft)
    assert errs[3].max() <= ATOL < errs[1].max()


def test_plan_covers_the_mel_support():
    p = cuda_frontend.plan(400, 160, 512, 13, "mfcc", 40, SR)
    fb = host.mel_filterbank(40, 257, SR, 0, SR / 2)
    support = np.nonzero(fb.sum(0))[0]
    assert list(p["bins"][:p["ksup"]]) == list(range(support.min(),
                                                     support.max() + 1))
    assert list(p["bins"][p["ksup"]:]) == [0, 256]
    assert all(v.flags.c_contiguous for v in p.values()
               if isinstance(v, np.ndarray))
    np.testing.assert_array_equal(p["mel"], fb.T[support.min():
                                                 support.max() + 1]
                                  .astype(np.float32))
    # the CSR by filter holds exactly the dense rows' nonzeros
    dense = np.zeros_like(p["mel"])
    for f in range(40):
        z = slice(p["melptr"][f], p["melptr"][f + 1])
        dense[p["melbin"][z], f] = p["melw"][z]
    np.testing.assert_array_equal(dense, p["mel"])


@pytest.mark.parametrize("sr", sorted(RATES))
def test_plan_shapes_and_energy_columns(sr):
    flen, fstride = host.frame_params(sr, 25, 10)
    p = cuda_frontend.plan(flen, fstride, 512, 13, "fbank", 40, sr)
    g = math.gcd(flen, fstride)
    assert p["mode"] == RATES[sr]
    if p["mode"] == "subsegment":
        assert (p["slen"], p["J"], p["step"]) == (g, flen // g, fstride // g)
    else:
        assert (p["slen"], p["sstride"], p["J"]) == (flen, fstride, 1)
    nb, nbins, ks = p["nb"], p["nbins"], p["ksup"]
    assert nb % 8 == 0 and nbins == ks + 2 <= nb
    assert p["basis"].shape == (p["slen_pad"], 2 * nb)
    assert p["twiddle"].shape == (p["J"], nb, 2)
    assert p["slen_pad"] % 8 == 0 and not p["basis"][p["slen"]:].any()
    assert not p["basis"][:, nbins:nb].any()
    assert not p["basis"][:, nb + nbins:].any()
    n = np.arange(p["slen"])
    np.testing.assert_array_equal(p["basis"][:p["slen"], ks], 1.0)  # X_0
    np.testing.assert_allclose(p["basis"][:p["slen"], ks + 1],
                               np.where(n % 2, -1.0, 1.0), atol=1e-6)
    np.testing.assert_allclose(p["basis"][:, nb + ks:nb + ks + 2], 0.0,
                               atol=1e-6)
    # energy columns' twiddles like any bin's: 1 at bin 0, (-1)^(g j) at N/2
    j = np.arange(p["J"])
    np.testing.assert_array_equal(p["twiddle"][:, ks], [[1.0, 0.0]] * p["J"])
    np.testing.assert_allclose(p["twiddle"][:, ks + 1, 0],
                               np.where(p["slen"] * j % 2, -1.0, 1.0),
                               atol=1e-6)
    np.testing.assert_allclose(p["twiddle"][:, ks + 1, 1], 0.0, atol=1e-6)


@pytest.mark.parametrize("B,seconds", [(8, 2), (8, 32), (128, 10), (1, 60)])
def test_tiling_fills_the_card(B, seconds):
    """Every team of every SM gets a work item, even at serving's smallest
    shape; the basis stays in shared memory; the largest item that fits
    is taken where the batch allows."""
    p = cuda_frontend.plan(400, 160, 512, 13, "mfcc", 40, SR)
    T = host.num_frames(seconds * SR, 400, 160)
    tl = cuda_frontend.tiling(p, B, T, 132, 13)
    teams = 132 * cuda_frontend.TEAMS
    assert B * tl.n_tiles >= teams
    assert tl.smem <= cuda_frontend.SMEM_LIMIT and tl.basis_in_smem
    assert tl.tt == (16 * tl.mt - 5) // 2 + 1
    fits = [mt for mt in range(1, 5) if cuda_frontend.smem_bytes(
        p, mt, (16 * mt - 5) // 2 + 1, 13, True) <= cuda_frontend.SMEM_LIMIT]
    if (B, seconds) == (8, 2):
        assert tl.mt == 1
    else:
        assert tl.mt == max(fits)


def test_tiling_takes_the_device_plan():
    """The wrapper sizes shared memory from the plan's tensors as the CPU
    tests do from its arrays."""
    kw = (400, 160, 512, 13, "mfcc", 40, SR)
    p = cuda_frontend.plan(*kw)
    dp = cuda_frontend._device_plan(*kw, torch.device("cpu"))
    assert cuda_frontend.tiling(dp, 128, 997, 132, 13) == \
        cuda_frontend.tiling(p, 128, 997, 132, 13)
    assert len(dp["dct"]) == p["dct"].size == 40 * 13


def test_wrapper_tiling_reuses_the_device_plan(monkeypatch):
    """A call of a new shape builds its tiling from the cached device plan:
    the NumPy plan is built once per configuration, not once per shape."""
    kw = (400, 160, 512, 13, "mfcc", 40, 22050)
    calls = []
    plan = cuda_frontend.plan
    monkeypatch.setattr(cuda_frontend, "plan",
                        lambda *a: calls.append(a) or plan(*a))
    monkeypatch.setattr(cuda_frontend, "_num_sms", lambda device: 132)
    for T in (197, 797, 801, 997, 3197):
        tl = cuda_frontend._device_tiling(kw, 8, T, torch.device("cpu"))
        assert tl == cuda_frontend.tiling(plan(*kw), 8, T, 132, 13)
    assert len(calls) <= 1


def test_argtypes_match_the_c_entry_points():
    """ctypes passes what each extern "C" function declares: a pointer
    (or the stream) as void *, an int as int."""
    src = (Path(cuda_frontend.__file__).resolve().parent.parent / "csrc"
           / "fused_frontend.cu").read_text()
    for name, argtypes in cuda_frontend.ARGTYPES.items():
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
        params = [a.strip() for a in sig.split(",")]
        want = [ctypes.c_void_p if "*" in a else ctypes.c_int
                for a in params]
        assert argtypes == want, name


def test_wrapper_sends_a_cpu_tensor_to_the_plain_path(rng):
    audio, audiolen = _batch(rng, S=SR)
    kw = dict(flen=400, fstride=160, fft_length=512, feat_dim=13,
              feat_type="mfcc", num_mel_filters=40, sample_rate=SR,
              frames_max=97, apply_cmvn=True)
    a, fl = torch.from_numpy(audio), torch.tensor([97, 40, 0],
                                               dtype=torch.int32)
    before = cuda_frontend.fused_frontend.launches
    got = cuda_frontend.fused_frontend(a, fl, **kw)
    assert cuda_frontend.fused_frontend.launches == before
    torch.testing.assert_close(got, tfe.reference_features(a, fl, **kw),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_frontend.fused_frontend(a.to("meta"), fl.to("meta"), **kw)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("cmvn", [True, False])
def test_featurize_batch_matches_jax(rng, cmvn, use_pallas):
    """The train step's featurization of a raw-audio loader batch,
    (B, S, 1, 1), with a sub-frame row whose frame count floors at 1."""
    from automatic_speech_recognition_torch.config import Config
    from test_torch_las import jax_cfg
    cfg = Config(feat_dim=13, cmvn=cmvn, use_pallas=use_pallas)
    audio, audiolen = _batch(rng)
    sig = audio[:, :, None, None]
    fj, lj = jfe.featurize_batch(sig, audiolen, jax_cfg(cfg))
    ft, lt = tfe.featurize_batch(torch.from_numpy(sig),
                                 torch.from_numpy(audiolen), cfg)
    assert ft.shape == np.asarray(fj).shape == (3, 205, 13, 3 if cmvn else 1)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert lt.tolist()[2] == 1
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=RTOL,
                               atol=ATOL)

