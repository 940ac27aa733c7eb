"""Port frontend (automatic_speech_recognition_torch/ops/frontend.py and the
fused CUDA kernel's wrapper) against the JAX package's frontend.

The same NumPy inputs go through the JAX function (XLA path, and the Pallas
kernel in interpret mode as tests/test_pallas_frontend.py runs it) and the
port.  Tolerance rtol 1e-4 / atol 2e-4: the one the TPU kernel is held to
(tests/test_pallas_frontend.py) — float32 sums in another order.  The
kernel itself is checked on the card by tests/test_torch_cuda.py.
"""

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


def _emulate_kernel(audio, featlen, T, feat_type, apply_cmvn):
    """NumPy float32 model of csrc/fused_frontend.cu's arithmetic: DFT at
    the plan's bins with (n k) mod N twiddles, Parseval energy, mel over
    the support rows, DCT with c0 = log energy."""
    p = cuda_frontend.plan(512, 13, feat_type, 40, SR)
    k, ks = p["bins"], p["ksup"]
    idx = np.minimum(np.arange(T)[:, None] * 160 + np.arange(400),
                     audio.shape[1] - 1)
    x = audio[:, idx]                                     # (B, T, 400)
    m = (np.arange(400)[:, None] * k[None, :]) % 512
    re = x @ p["twiddle"][m, 0]
    im = x @ p["twiddle"][m, 1]
    ps = (re * re + im * im) / np.float32(512)
    mel = ps[..., :ks] @ p["mel"]
    mel = np.where(mel == 0, np.float32(tfe.EPS_ZERO), mel)
    if feat_type == "mfcc":
        feat = np.log(mel) @ p["dct"]
        e = 0.5 * (x * x).sum(-1) + 0.5 * (ps[..., ks] + ps[..., ks + 1])
        feat[..., 0] = np.log(np.where(e == 0, np.float32(tfe.EPS_ZERO), e))
    else:
        feat = mel
    return tfe._cmvn_tail(torch.from_numpy(feat.astype(np.float32)),
                          torch.from_numpy(featlen), apply_cmvn).numpy()


@pytest.mark.parametrize("apply_cmvn", [True, False])
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_kernel_plan_reproduces_the_plain_path(rng, feat_type, apply_cmvn):
    audio, audiolen = _batch(rng, S=SR + 777)
    ft, lt = _port(audio, audiolen, feat_dim=13, feat_type=feat_type,
                   apply_cmvn=apply_cmvn)
    got = _emulate_kernel(audio, lt, ft.shape[1], feat_type, apply_cmvn)
    np.testing.assert_allclose(got, ft, rtol=RTOL, atol=ATOL)


def test_plan_covers_the_mel_support():
    p = cuda_frontend.plan(512, 13, "mfcc", 40, SR)
    fb = host.mel_filterbank(40, 257, SR, 0, SR / 2)
    support = np.nonzero(fb.sum(0))[0]
    assert list(p["bins"][:p["ksup"]]) == list(range(support.min(),
                                                     support.max() + 1))
    assert list(p["bins"][p["ksup"]:]) == [0, 256]
    assert all(p[k].flags.c_contiguous for k in ("bins", "twiddle", "mel",
                                                 "dct"))
    np.testing.assert_array_equal(p["mel"], fb.T[support.min():
                                                 support.max() + 1]
                                  .astype(np.float32))


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
    from automatic_speech_recognition_tpu.config import Config
    cfg = Config(feat_dim=13, cmvn=cmvn, use_pallas=use_pallas)
    audio, audiolen = _batch(rng)
    sig = audio[:, :, None, None]
    fj, lj = jfe.featurize_batch(sig, audiolen, cfg)
    ft, lt = tfe.featurize_batch(torch.from_numpy(sig),
                                 torch.from_numpy(audiolen), cfg)
    assert ft.shape == np.asarray(fj).shape == (3, 205, 13, 3 if cmvn else 1)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert lt.tolist()[2] == 1
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=RTOL,
                               atol=ATOL)
