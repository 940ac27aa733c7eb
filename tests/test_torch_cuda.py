"""The port's CUDA paths on an NVIDIA GPU; every test here skips without
one.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports JAX to pin it to the CPU.)
The fused frontend kernel is held to its plain PyTorch version at
rtol 1e-4 / atol 2e-4, the tolerance tests/test_pallas_frontend.py holds
the TPU kernel to (float32 sums in another order).  The teacher-forced
speller's CUDA graph pair (models/las.graphed_loop) is held to the eager
loop bit for bit: it replays the kernels the loop launches.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import collections
import threading

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
@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_kernel_rows_do_not_depend_on_the_batch(cuda, feat_type):
    """Each row equals itself alone, bit for bit, in a batch of 5 with
    longer and shorter rows and more padding, and under every work split
    of pass 1 (the statistics reduce each row over a grid that follows
    feat_dim alone)."""
    rng = np.random.default_rng(7)
    sigs = [(rng.standard_normal(int(t * SR)) * 0.1).astype(np.float32)
            for t in (1.3, 0.02, 9.7, 2.2, 0.6)]

    def feats(rows, extra=0):
        audio = np.zeros((len(rows), max(map(len, rows)) + extra),
                         np.float32)
        for r, x in enumerate(rows):
            audio[r, :len(x)] = x
        return frontend.extract_features(
            torch.from_numpy(audio).to(cuda),
            torch.tensor([len(x) for x in rows], device=cuda),
            use_kernel=True, feat_dim=13, feat_type=feat_type)

    f, l = feats(sigs, extra=SR)
    for r, x in enumerate(sigs):
        f1, l1 = feats([x])
        assert int(l1[0]) == int(l[r])
        assert torch.equal(f[r, :int(l[r])], f1[0, :int(l1[0])]), r
    a = torch.from_numpy(
        (rng.standard_normal((4, 3 * SR)) * 0.1).astype(np.float32)).to(cuda)
    fl = torch.tensor([297, 150, 6, 0], dtype=torch.int32, device=cuda)
    kw = dict(flen=400, fstride=160, fft_length=512, feat_dim=13,
              feat_type=feat_type, num_mel_filters=40, sample_rate=SR,
              frames_max=298)
    p = cuda_frontend.plan(400, 160, 512, 13, feat_type, 40, SR)
    for cmvn in (False, True):
        outs = [cuda_frontend.fused_frontend(a, fl, apply_cmvn=cmvn,
                                             work_split=t, **kw)
                for t in cuda_frontend.tiling_options(p, 298, 13)]
        assert all(torch.equal(o, outs[0]) for o in outs), cmvn


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
    tiles, CMVN reduced per utterance) against the plain version."""
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


# ------------------------------------------- the speller's CUDA graphs


def _graph_cfg(**kw):
    base = dict(unit="char", vocab_size=30, feat_dim=13, enc_type="pblstm",
                enc_units=32, num_enc_layers=1, dec_units=64,
                num_dec_layers=2, embedding_size=16, attention_size=24,
                mode="add", loc_kernel_size=9, loc_num_channels=4,
                dropout_rate=0.0, scheduled_sampling=False)
    base.update(kw)
    return Config(**base)


def _speller_inputs(cfg, dev, B, T, L, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    enc = torch.randn(B, T, las.enc_out_dim(cfg), device=dev, generator=g)
    enc_len = torch.randint(T // 2, T + 1, (B,), device=dev, generator=g,
                            dtype=torch.int32)
    enc_len[0] = T
    ids = torch.randint(3, cfg.vocab_size, (B, L), device=dev, generator=g,
                        dtype=torch.int32)
    ids[1, L // 2:] = 0                             # a PAD tail
    return enc, enc_len, ids


def _speller_step(model, cfg, loop, inputs, alphas_in_loss):
    """logits, alphas, the loss and the gradients of enc_out and of every
    speller weight (the float32 masters) through `loop`."""
    enc, enc_len, ids = inputs
    params = [p for n, p in model.speller.named_parameters()
              if not n.startswith("ctc_head")]
    enc = enc.to(las.compute_dtype(cfg)).requires_grad_()
    with las.compute_cast(cfg, model):
        logits, alphas = loop(model.speller, cfg, enc, enc_len, ids)
        loss = las.attention_loss(logits.float(), ids, cfg)
        if alphas_in_loss:
            loss = loss + alphas.float().square().mean()
        grads = torch.autograd.grad(loss, [enc, *params])
    return [logits, alphas, loss, *grads]


# the train cell's speller (bench_torch/configs/las_pblstm_chan2016.json):
# pblstm listener of 2 x 256, 2 x 512 decoder, content attention, 44 ids;
# two of its batch shapes (rows, encoder frames, decoder steps): the
# shortest bucket's and the longest's.  The LSTM speller at toy widths and
# at LAS-6-1280's (bench_torch/configs/las_6_1280_park2019.json: cnn
# listener of 1280, 2 x 1280 LSTM decoder, attention and embedding 512,
# 16384 ids), with the word-piece cell's shortest and longest shapes
WIDTHS = {
    "toy": ({}, {"A": (6, 23, 17), "B": (4, 31, 12)}),
    "cell": (dict(vocab_size=44, feat_dim=40, enc_units=256,
                  num_enc_layers=3, dec_units=512, embedding_size=128,
                  attention_size=128),
             {"A": (96, 80, 96), "B": (48, 214, 219)}),
    "lstm": (dict(rnn_cell="lstm"), {"A": (6, 23, 17), "B": (4, 31, 12)}),
    "lstm_cell": (dict(rnn_cell="lstm", enc_type="cnn", vocab_size=16384,
                       feat_dim=80, enc_units=1280, num_enc_layers=6,
                       dec_units=1280, embedding_size=512,
                       attention_size=512),
                  {"A": (96, 160, 32), "B": (48, 428, 96)}),
}


@pytest.fixture
def cudnn_deterministic():
    """cuDNN's deterministic algorithms: location attention's conv1d
    backward otherwise may sum in another order run to run (at the train
    cell's width it does), in the eager loop as in a replay."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["toy", "cell", "lstm", "lstm_cell"])
@pytest.mark.parametrize("mode", ["add", "loc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_speller_matches_the_eager_loop(cuda, cudnn_deterministic,
                                                dtype, mode, width):
    """Shapes A, A, B, B, A, B, A, B in turn (two eager calls, then a
    capture and a replay, then replays; both shapes' pairs in one memory
    pool), at toy widths and at the train cell's: logits, alphas, the
    loss and every gradient equal the eager loop's bit for bit, with and
    without the alphas in the loss; outputs a step returned stay as they
    were after a later replay of their shape; one capture a shape."""
    from automatic_speech_recognition_torch.utils import spans
    widths, shapes = WIDTHS[width]
    cfg = _graph_cfg(dtype=dtype, mode=mode, **widths)
    model = las.init(cfg, torch.Generator().manual_seed(0), cuda).train()
    before = spans.totals()
    kept = []
    for i, name in enumerate("AABBABAB"):
        inputs = _speller_inputs(cfg, cuda, *shapes[name], seed=i)
        got = _speller_step(model, cfg, las.graphed_loop, inputs, i % 2)
        want = _speller_step(model, cfg, las._teacher_loop, inputs, i % 2)
        for k, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (i, name, k)
        kept.append((got[:2], [t.clone() for t in got[:2]]))
    assert all(torch.equal(a, b) for out, copy in kept
               for a, b in zip(out, copy))
    got = spans.report(before, ("las.speller.",))
    assert got["las.speller.graph_captures"] == {"count": 2}
    assert got["las.speller.graph_steps"] == {
        "count": 2 * (shapes["A"][2] + shapes["B"][2])}
    assert len(las.speller_graphs(model.speller).pairs) == 2


def _graphs_against_eager(model, cfg, dev, shapes, order, alphas_in_loss):
    """Each call of `order` (names of `shapes`) through graphed_loop and
    through the eager loop on the same inputs: every output and gradient
    equal bit for bit."""
    for i, name in enumerate(order):
        inputs = _speller_inputs(cfg, dev, *shapes[name], seed=i)
        got = _speller_step(model, cfg, las.graphed_loop, inputs,
                            alphas_in_loss)
        want = _speller_step(model, cfg, las._teacher_loop, inputs,
                             alphas_in_loss)
        for k, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (i, name, k)


@pytest.mark.cuda
def test_graph_capture_under_a_profiler_and_after_it(cuda):
    """A shape captured while torch.profiler traces the host and the card,
    replayed under it and after it stops, and another shape captured
    after it stopped: every call equals the eager loop bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    from automatic_speech_recognition_torch.utils import spans
    cfg = _graph_cfg()
    model = las.init(cfg, torch.Generator().manual_seed(0), cuda).train()
    shapes = WIDTHS["toy"][1]
    before = spans.totals()
    _graphs_against_eager(model, cfg, cuda, shapes, "AA", True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert spans.profiling()
        _graphs_against_eager(model, cfg, cuda, shapes, "AAB", True)
    assert not spans.profiling()
    _graphs_against_eager(model, cfg, cuda, shapes, "ABBBA", True)
    got = spans.report(before, ("las.speller.",))
    assert got["las.speller.graph_captures"] == {"count": 2}
    assert got["las.speller.graph_steps"] == {"count": 4 * 17 + 2 * 12}


@pytest.mark.cuda
def test_a_failed_capture_leaves_the_next_one_working(cuda, monkeypatch):
    """A capture that raises, after its forward graph was captured, frees
    the only graph of the cache's memory pool while the pool still holds
    its memory; the allocator refuses a capture into such a pool.  The
    next call of the shape captures into a new pool and equals the eager
    loop bit for bit."""
    import gc
    cfg = _graph_cfg()
    model = las.init(cfg, torch.Generator().manual_seed(0), cuda).train()
    shapes = WIDTHS["toy"][1]
    _graphs_against_eager(model, cfg, cuda, shapes, "AA", False)
    cache = las.speller_graphs(model.speller)
    eager, pools = las._teacher_loop, []

    def failing_once(*args):
        out = eager(*args)
        if torch.cuda.is_current_stream_capturing() and not pools:
            pools.append(cache.pool)
            raise RuntimeError("injected failure inside the capture")
        return out

    monkeypatch.setattr(las, "_teacher_loop", failing_once)
    inputs = _speller_inputs(cfg, cuda, *shapes["A"], seed=2)
    with pytest.raises(RuntimeError, match="injected"):
        _speller_step(model, cfg, las.graphed_loop, inputs, False)
    gc.collect()
    assert pools[0] is not None and cache.pool is None
    monkeypatch.setattr(las, "_teacher_loop", eager)
    _graphs_against_eager(model, cfg, cuda, shapes, "AA", False)
    assert [type(v) for v in cache.pairs.values()] == [las.SpellerGraphs]
    assert cache.pool is not None and cache.pool != pools[0]


@pytest.mark.cuda
def test_graph_capture_beside_a_thread_copying_to_the_card(cuda):
    """A capture while another thread copies pageable batches to the card,
    as the loader's DevicePrefetcher does: it succeeds, and the replay
    equals the eager loop bit for bit."""
    cfg = _graph_cfg()
    model = las.init(cfg, torch.Generator().manual_seed(0), cuda).train()
    host = np.random.default_rng(0).standard_normal(
        (48, 200_000)).astype(np.float32)
    started, stop, copies = threading.Event(), threading.Event(), []
    index = torch.cuda.current_device()

    def copier():
        torch.cuda.set_device(index)
        while not stop.is_set():
            copies.append(float(torch.from_numpy(host).to(cuda)[0, 0]))
            started.set()

    thread = threading.Thread(target=copier, daemon=True)
    thread.start()
    try:
        assert started.wait(timeout=60)
        for i in range(4):          # eager, eager, capture, replay
            inputs = _speller_inputs(cfg, cuda, 8, 40, 30, seed=i)
            got = _speller_step(model, cfg, las.graphed_loop, inputs, False)
            want = _speller_step(model, cfg, las._teacher_loop, inputs,
                                 False)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), i
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive() and len(copies) > 1
    assert len(las.speller_graphs(model.speller).pairs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rnn", "lstm"])
@pytest.mark.parametrize("ctc", [False, True])
def test_graphed_train_steps_match_eager_ones(cuda, cudnn_deterministic,
                                              monkeypatch, ctc, cell):
    """N train steps of one batch shape (the listener, the loss with and
    without joint CTC, whose head shares enc_out's gradient, Adam):
    the state that replays the speller's graphs and one that runs the
    eager loop stay equal bit for bit; the counters read one capture and
    (N - 2) x steps replayed decoder steps (two eager calls first)."""
    from automatic_speech_recognition_torch.training import trainer
    from automatic_speech_recognition_torch.utils import spans
    cfg = _graph_cfg(lr=1e-2, ctc=ctc, rnn_cell=cell)
    rng = np.random.default_rng(3)
    B, T, L, N = 6, 64, 19, 4
    feats = rng.standard_normal((N, B, T, 13, 3)).astype(np.float32)
    y = rng.integers(3, 29, (N, B, L)).astype(np.int32)
    y[:, 2, 11:] = 0
    states = [trainer.create_train_state(cfg, cuda) for _ in range(2)]
    counted = collections.Counter()
    for k in range(N):
        batch = (torch.from_numpy(feats[k]).to(cuda),
                 torch.full((B,), T, dtype=torch.int32, device=cuda),
                 torch.from_numpy(y[k]).to(cuda),
                 torch.from_numpy((y[k] != 0).sum(1)).to(cuda))
        before = spans.totals()
        got = trainer.train_step(states[0], batch, cfg)
        counted.update({k: v["count"] for k, v in spans.report(
            before, ("las.speller.",)).items() if "count" in v})
        with monkeypatch.context() as m:
            m.setattr(las, "graph_eligible", lambda *a: False)
            want = trainer.train_step(states[1], batch, cfg)
        for name in ("loss", "grad_norm", "att_peak", "sample_ids",
                     "sample_alphas"):
            assert torch.equal(got[name], want[name]), (k, name)
        for a, b in zip(states[0].model.parameters(),
                        states[1].model.parameters()):
            assert torch.equal(a, b), k
    assert counted == {"las.speller.steps": N * L,
                       "las.speller.graph_captures": 1,
                       "las.speller.graph_steps": (N - 2) * L}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,steps,units", [
    (48, 428, 1280), (96, 214, 1280), (100, 12, 1280), (5, 9, 32)])
def test_lstm_kernels_match_the_plain_recurrence(cuda, rows, steps, units):
    """The recurrence kernels (csrc/lstm_recurrence.cu) against their
    plain PyTorch version, forward and backward over the whole sequence
    (h, c, the activated gates, the gates' gradient), at the word-piece
    cell's longest shapes (48 x 428 and 96 x 214 steps, U 1280), at two
    row tiles (100 rows) and at a toy width, within chip_smoke.LSTM_TOL
    (set from readings at those shapes, PERF.md's kernel table), with
    the launches a torch.profiler trace of the call holds (a forward and
    a backward kernel a direction; a trace that lost one is taken again,
    chip_smoke.lstm_traced).  Prints the kernels' ptxas registers, shared
    memory and spills."""
    from chip_smoke import (LSTM_TOL, lstm_compare, lstm_inputs,
                            lstm_recurrences, lstm_traced)
    from automatic_speech_recognition_torch.ops import _kernels
    _kernels.load("lstm_recurrence")
    print(_kernels.build_log.get("lstm_recurrence", "(built before)"))
    gates, dout, w_hh = lstm_inputs(cuda, rows, steps, units, seed=rows)
    got, launches = lstm_traced(
        lambda: lstm_recurrences(gates, dout, w_hh, "kernel"), (2, 2))
    assert launches == (2, 2)
    want = lstm_recurrences(gates, dout, w_hh, "plain")
    print(lstm_compare(f"{rows}x{steps}x{units}", got, want, LSTM_TOL))


@pytest.mark.cuda
def test_lstm_kernels_are_deterministic_and_routed(cuda):
    """Two calls give the same bits; an nn.LSTM BiRNN on a float32 CUDA
    tensor runs the kernels (a forward and a backward launch a direction
    in a torch.profiler trace of its forward and backward) and counts its
    frame-steps, a bf16 one and a tanh RNN run cuDNN."""
    from chip_smoke import lstm_inputs, lstm_recurrences, lstm_traced
    from automatic_speech_recognition_torch.ops import layers, lstm
    from automatic_speech_recognition_torch.utils import spans
    gates, dout, w_hh = lstm_inputs(cuda, 7, 30, 64, seed=1)
    a = lstm_recurrences(gates, dout, w_hh, "kernel")
    b = lstm_recurrences(gates, dout, w_hh, "kernel")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    x = torch.randn(7, 30, 24, device=cuda)
    rnn = layers.make_birnn(24, 64, "lstm").to(cuda)
    totals = spans.totals()
    layers.birnn_apply(rnn, x)
    got = spans.report(totals, (layers.KERNEL_FRAMES,))
    assert got[layers.KERNEL_FRAMES] == {"count": 2 * 7 * 30}
    _, launches = lstm_traced(
        lambda: layers.birnn_apply(rnn, x).sum().backward(), (2, 2))
    assert launches == (2, 2)
    assert lstm.route(rnn, x) == "bilstm"
    assert lstm.route(rnn, x.bfloat16()) == "library"
    assert lstm.route(layers.make_birnn(24, 64, "rnn"), x) == "library"


@pytest.mark.cuda
def test_lstm_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    from automatic_speech_recognition_torch.ops import lstm
    B, T, U = 3, 5, 16
    gates = torch.zeros(B, T, 8 * U, device=cuda)
    state = [torch.zeros(B, T, 2 * U, device=cuda) for _ in range(2)]
    w = torch.zeros(4 * U, U, device=cuda)
    bad = [((gates.double(), *state), (w, w)),
           ((gates, *state), (w.t(), w)),               # not contiguous
           ((gates, *state), (w[:, :8], w)),            # shape
           ((gates, state[0][:, :4], *state[1:]), (w, w)),
           ((gates.cpu(), *state), (w, w)),
           ((torch.zeros(B, T, 8 * 6, device=cuda), *state), (w, w))]
    for args, w_hh in bad:
        with pytest.raises(ValueError):
            lstm.recurrence_forward(*args, w_hh)
    with pytest.raises(ValueError):
        lstm.recurrence_backward(gates, state[0].double(), gates, state[1],
                                 (w, w))
