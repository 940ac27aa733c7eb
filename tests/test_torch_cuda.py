"""The port's CUDA paths on an NVIDIA GPU; every test here skips without
one.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports JAX to pin it to the CPU.)
The fused frontend kernel is held to its plain PyTorch version at
rtol 1e-4 / atol 2e-4, the tolerance tests/test_pallas_frontend.py holds
the TPU kernel to (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.ops import cuda_frontend
from automatic_speech_recognition_torch.ops import frontend
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

RTOL, ATOL = 1e-4, 2e-4
SR = 16000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32 = cudnn.allow_tf32 = False   # full float32 reference
    yield torch.device("cuda")
    mm.allow_tf32, cudnn.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", [1, 10, 32])
@pytest.mark.parametrize("apply_cmvn", [True, False])
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_kernel_matches_plain(cuda, feat_type, apply_cmvn, seconds):
    rng = np.random.default_rng(seconds)
    S = SR * seconds
    audio = torch.from_numpy(
        (rng.standard_normal((8, S)) * 0.1).astype(np.float32)).to(cuda)
    # full rows, one at half length, one sub-frame row (featlen 0)
    audiolen = torch.tensor([S] * 6 + [S // 2, 300], device=cuda)
    kw = dict(feat_dim=13, feat_type=feat_type, apply_cmvn=apply_cmvn)
    before = cuda_frontend.fused_frontend.launches
    fk, lk = frontend.extract_features(audio, audiolen, use_kernel=True,
                                       **kw)
    assert cuda_frontend.fused_frontend.launches == before + 1
    fp, lp = frontend.extract_features(audio, audiolen, **kw)
    torch.testing.assert_close(lk, lp, rtol=0, atol=0)
    torch.testing.assert_close(fk, fp, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((2, SR), device=cuda)
    fl = torch.zeros((2,), dtype=torch.int32, device=cuda)
    kw = dict(flen=400, fstride=160, fft_length=512, feat_dim=13,
              feat_type="mfcc", num_mel_filters=40, sample_rate=SR,
              frames_max=97, apply_cmvn=True)
    for bad_a, bad_fl in ((a.double(), fl), (a[:, ::2], fl),
                          (a, fl.long()), (a, fl.cpu()), (a, fl[:1])):
        with pytest.raises(ValueError):
            cuda_frontend.fused_frontend(bad_a, bad_fl, **kw)
    with pytest.raises(ValueError, match="feat_dim"):
        cuda_frontend.fused_frontend(a, fl, **{**kw, "feat_dim": 300})


@pytest.mark.cuda
def test_recognizer_features_on_cuda_match_cpu(cuda):
    cfg = Config(unit="char", vocab_size=30, feat_dim=13, enc_units=32,
                 num_enc_channels=4, num_enc_layers=2, dec_units=32,
                 num_dec_layers=2, embedding_size=16, attention_size=16,
                 mode="loc", convert_rate=0.12)
    recs = [Recognizer(las.init(cfg, torch.Generator().manual_seed(0),
                                torch.device("cpu")), cfg, CharEncoder(), d)
            for d in ("cpu", cuda)]
    rng = np.random.default_rng(0)
    sigs = [(rng.standard_normal(int(SR * s)) * 0.1).astype(np.float32)
            for s in (0.5, 1.3, 2.0)]
    (fc, lc), (fg, lg) = (r._features(sigs) for r in recs)
    torch.testing.assert_close(fg.cpu(), fc, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=0)
    logits_c, _ = recs[0].greedy(fc, lc)
    logits_g, _ = recs[1].greedy(fc.to(cuda), lc.to(cuda))
    # same features in: the model alone, float32 on both devices
    torch.testing.assert_close(logits_g[:, 0].cpu(), logits_c[:, 0],
                               rtol=1e-4, atol=1e-4)
    texts = recs[1].transcribe_signals(sigs)
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)


@pytest.mark.cuda
@pytest.mark.parametrize("ctc", [False, True])
def test_train_step_on_cuda_matches_cpu(cuda, ctc):
    """One train step over a raw-audio batch (the fused kernel inside the
    step on the card, the plain frontend on the CPU) from the same init:
    loss and gradient norm rtol 1e-4, as the CPU parity tests hold the
    port to JAX; bias_hh stays zero."""
    from automatic_speech_recognition_torch.training import trainer
    cfg = Config(unit="char", vocab_size=30, feat_dim=13, enc_units=32,
                 num_enc_channels=4, num_enc_layers=2, dec_units=32,
                 num_dec_layers=2, embedding_size=16, attention_size=16,
                 mode="loc", dropout_rate=0.0, scheduled_sampling=False,
                 audio_shards=True, ctc=ctc)
    rng = np.random.default_rng(0)
    S = 2 * SR
    sig = (rng.standard_normal((4, S, 1, 1)) * 0.1).astype(np.float32)
    siglen = np.array([S, S - 5000, S // 2, 9000], np.int32)
    y = rng.integers(3, 29, (4, 12)).astype(np.int32)
    y[2, 8:] = 0
    batch = (sig, siglen, y, (y != 0).sum(1).astype(np.int32))
    got = {}
    for dev in (torch.device("cpu"), cuda):
        ts = trainer.create_train_state(cfg, dev)
        before = cuda_frontend.fused_frontend.launches
        m = trainer.train_step(ts, tuple(torch.from_numpy(a).to(dev)
                                         for a in batch), cfg)
        launched = cuda_frontend.fused_frontend.launches - before
        assert launched == (1 if dev.type == "cuda" else 0)
        got[dev.type] = (m["loss"].item(), m["grad_norm"].item())
        rnn = ts.model.listener.layers[0].birnn
        assert not rnn.bias_hh_l0.any() and not rnn.bias_hh_l0_reverse.any()
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["attention", "lm", "joint_ctc"])
def test_beam_on_cuda_matches_cpu(cuda, mode):
    """Batched beam search (beam 4, log-prob scoring) on the card and on
    the CPU from the same weights and features: rank-0 tokens and lengths
    equal, scores of the ranks holding a hypothesis within rtol 1e-4."""
    import copy
    from automatic_speech_recognition_torch.decoding import beam
    from automatic_speech_recognition_torch.models import char_rnn
    cfg = Config(unit="char", vocab_size=30, feat_dim=13, enc_units=32,
                 num_enc_channels=4, num_enc_layers=2, dec_units=32,
                 num_dec_layers=2, embedding_size=16, attention_size=16,
                 mode="loc", convert_rate=0.12, lm_weight=0.5,
                 ctc=mode == "joint_ctc",
                 ctc_beam_weight=0.5 if mode == "joint_ctc" else 0.0)
    cpu = torch.device("cpu")
    model = las.init(cfg, torch.Generator().manual_seed(0), cpu)
    lm = lm_cfg = None
    if mode == "lm":
        lm_cfg = char_rnn.LMConfig(vocab_size=28, hidden_size=32,
                                   num_layers=2)
        lm = char_rnn.init(lm_cfg, torch.Generator().manual_seed(1), cpu)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((4, 200, 13, 3))
                             .astype(np.float32))
    lens = torch.tensor([200, 151, 90, 40], dtype=torch.int32)
    res = {}
    for dev in (cpu, cuda):
        m = copy.deepcopy(model).to(dev)
        l = copy.deepcopy(lm).to(dev) if lm is not None else None
        r = beam.beam_search(m, feats.to(dev), lens.to(dev), cfg, 24, 4,
                             True, l, lm_cfg)
        res[dev.type] = [x.cpu() for x in r[:3]]
    (ct, cl, cs), (gt, gl, gs) = res["cpu"], res["cuda"]
    real = cs > beam.NEG / 2
    assert real[:, 0].all()
    torch.testing.assert_close(gl[:, 0], cl[:, 0], rtol=0, atol=0)
    for b in range(4):
        torch.testing.assert_close(gt[b, 0, :cl[b, 0]], ct[b, 0, :cl[b, 0]],
                                   rtol=0, atol=0)
    assert torch.equal(gs > beam.NEG / 2, real)
    torch.testing.assert_close(gs[real], cs[real], rtol=1e-4, atol=1e-6)


def _tile_frames(B, S, sr, dev):
    from automatic_speech_recognition_torch.ops import frontend_host as host
    flen, fstride = host.frame_params(sr, 25, 10)
    p = cuda_frontend.plan(flen, fstride, 512, 13, "mfcc", 40, sr)
    T = host.num_frames(S, flen, fstride)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return flen, fstride, cuda_frontend.tiling(p, B, T, sms, 13).tt


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_utterance_60s", "tile_edges",
                                  "all_rows_under_one_tile", "odd_g_15khz",
                                  "whole_frames_11025hz"])
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_subsegment_kernel_edge_cases(cuda, feat_type, case):
    """The redesigned kernel (subsegment DFT on tensor cores, persistent
    tiles, CMVN from per-tile partials) against the plain version."""
    sr = {"odd_g_15khz": 15000, "whole_frames_11025hz": 11025}.get(case, SR)
    rng = np.random.default_rng(7)
    B, S = (1, 60 * sr) if case == "one_utterance_60s" else (8, 4 * sr)
    flen, fstride, tt = _tile_frames(B, S, sr, cuda)
    if case == "tile_edges":
        frames = [tt, 3 * tt, 2 * tt + tt // 2, 5 * tt - 1, 1, 0, 7, 4 * tt]
        lens = [f * fstride + flen for f in frames]
    elif case == "all_rows_under_one_tile":
        lens = [flen - 1, flen, flen + fstride * (tt // 2), 100] * 2
    else:
        lens = [S] * (B - 1) + [S // 3] if B > 1 else [S - 12345]
    audio = torch.from_numpy(
        (rng.standard_normal((B, S)) * 0.1).astype(np.float32)).to(cuda)
    audiolen = torch.tensor(lens, device=cuda)
    for cmvn in (True, False):
        kw = dict(feat_dim=13, feat_type=feat_type, apply_cmvn=cmvn,
                  sample_rate=sr)
        fk, lk = frontend.extract_features(audio, audiolen, use_kernel=True,
                                           **kw)
        fp, lp = frontend.extract_features(audio, audiolen, **kw)
        torch.testing.assert_close(lk, lp, rtol=0, atol=0)
        torch.testing.assert_close(fk, fp, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("speed", [0.9, 1.1])
def test_resample_on_cuda_matches_cpu(cuda, speed):
    """resample_rational_device (cuDNN convolution, TF32 off) against the
    same call on the CPU: atol 1e-5, as the CPU tests hold it to the host
    resampler; new lengths and masked tails equal."""
    from automatic_speech_recognition_torch.ops import augmentation as aug
    rng = np.random.default_rng(3)
    S = 4 * SR
    sig = torch.from_numpy((rng.standard_normal((6, S)) * 0.3)
                           .astype(np.float32))
    lens = torch.tensor([S, S - 7, S // 2, 3 * SR, 12345, 400],
                        dtype=torch.int32)
    frac = aug._rational_speed(speed)
    up, down = frac.denominator, frac.numerator
    want, want_len = aug.resample_rational_device(sig, lens, up, down)
    got, got_len = aug.resample_rational_device(sig.to(cuda), lens.to(cuda),
                                                up, down)
    torch.testing.assert_close(got_len.cpu(), want_len, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["white", "pink"])
def test_noise_on_cuda_keeps_snr_padding_and_silence(cuda, kind):
    """online_noise_perturb on the card: the CPU test's properties (the
    card's generator draws other numbers): SNR over valid samples within
    1e-3 dB of the drawn one, padding and silent rows exactly zero."""
    from automatic_speech_recognition_torch.ops import augmentation as aug
    cfg = Config(online_noise_snr_low=12.0, online_noise_snr_high=12.0,
                 online_noise_kind=kind)
    rng = np.random.default_rng(4)
    S = 2 * SR
    sig = (rng.standard_normal((4, S)) * 0.05).astype(np.float32)
    lens = np.array([S, S - 999, S // 2, S], np.int32)
    sig[3] = 0.0
    for i, n in enumerate(lens):
        sig[i, n:] = 0.0
    out = aug.online_noise_perturb(
        torch.Generator(device=cuda).manual_seed(0),
        torch.from_numpy(sig).to(cuda), torch.from_numpy(lens).to(cuda),
        cfg).cpu().numpy()
    for i, n in enumerate(lens):
        assert not out[i, n:].any()
    assert not out[3].any()
    for i in range(3):
        n = lens[i]
        added = out[i, :n].astype(np.float64) - sig[i, :n]
        snr = 10 * np.log10(np.mean(sig[i, :n].astype(np.float64) ** 2)
                            / np.mean(added ** 2))
        assert abs(snr - 12.0) < 1e-3, snr


@pytest.mark.cuda
def test_spec_augment_on_cuda(cuda):
    """spec_augment on the card: masks inside each utterance and within
    their widths, zeroed values, reproducible from the generator."""
    from automatic_speech_recognition_torch.ops import augmentation as aug
    cfg = Config(spec_augment=True, sa_freq_masks=2, sa_freq_width=3,
                 sa_time_masks=2, sa_time_width=10, sa_time_ratio=0.5)
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(rng.standard_normal((8, 64, 13, 3))
                             .astype(np.float32)).to(cuda)
    lens = torch.tensor([64, 40, 16, 8, 64, 33, 21, 2], dtype=torch.int32,
                        device=cuda)
    gen = lambda: torch.Generator(device=cuda).manual_seed(3)
    out = aug.spec_augment(gen(), audio, lens, cfg)
    assert torch.equal(out, aug.spec_augment(gen(), audio, lens, cfg))
    changed = (out != audio).cpu().numpy()
    assert changed.any()
    for b in range(8):
        n = int(lens[b])
        tcols = np.nonzero(changed[b].all(axis=(1, 2)))[0]
        assert (tcols < n).all() and len(tcols) <= 2 * min(10, n // 2)
        assert len(np.nonzero(changed[b].all(axis=(0, 2)))[0]) <= 6
    assert (out[torch.from_numpy(changed).to(cuda)] == 0).all()


@pytest.mark.cuda
def test_lm_train_step_on_cuda_matches_cpu(cuda):
    """Three LM train steps (lstm 2 x 128, the train_lm defaults) from the
    same weights on the card and the CPU: losses and weights rtol 1e-4 /
    atol 1e-6 (float32 sums in another order)."""
    import copy
    from automatic_speech_recognition_torch.models import char_rnn
    cfg = char_rnn.LMConfig()
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, 28, (3, 20, 11)))
    base = char_rnn.create_lm_train_state(cfg, 0, torch.device("cpu"))
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        model = copy.deepcopy(base.model).to(dev)
        ts = char_rnn.LMTrainState(model,
                                   char_rnn.make_lm_optimizer(model, cfg), 0,
                                   torch.Generator(device=dev).manual_seed(0))
        state = char_rnn.zero_state(cfg, 20, dev)
        losses = []
        for k in range(3):
            x = ids[k].to(dev)
            loss, state = char_rnn.lm_train_step(ts, x[:, :-1], x[:, 1:],
                                                 state, cfg)
            losses.append(loss.item())
        runs[dev.type] = (losses, {k: v.cpu() for k, v in
                                   ts.model.state_dict().items()})
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, v in runs["cpu"][1].items():
        torch.testing.assert_close(runs["cuda"][1][k], v, rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_kernel_subnormal_frame_energy(cuda, feat_type):
    """Frames holding only a few samples of ~1e-22 (a resampler's ringing
    over digital silence): the kernel's Parseval energy is subnormal there,
    and it takes speechpy's eps as the plain version's does."""
    rng = np.random.default_rng(8)
    S = 2 * SR
    audio = (rng.standard_normal((4, S)) * 0.1).astype(np.float32)
    audio[::2, 1600:6400] = 0.0
    audio[::2, 1600:6400:700] = 4.4e-22
    audio = torch.from_numpy(audio).to(cuda)
    audiolen = torch.tensor([S, S, S - 999, S // 2], device=cuda)
    for cmvn in (True, False):
        kw = dict(feat_dim=13, feat_type=feat_type, apply_cmvn=cmvn)
        fk, _ = frontend.extract_features(audio, audiolen, use_kernel=True,
                                          **kw)
        fp, _ = frontend.extract_features(audio, audiolen, **kw)
        torch.testing.assert_close(fk, fp, rtol=RTOL, atol=ATOL)
