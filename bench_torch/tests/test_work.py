"""The yardstick's operation and byte counts: the frontend's, and the
LAS reference module's counts against a hand count and against torch's
FLOP counter on the reference at a tiny configuration."""

import hashlib
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import weights, work
from bench_torch.harness import ROOT, load_json
from bench_torch.reference import las as ref

CNN = load_json(ROOT / "bench_torch/configs/las_cnn_bpe5k.json")["values"]
PBL = load_json(ROOT / "bench_torch/configs/las_pblstm_chan2016.json")["values"]


def test_frontend_bytes_and_bound():
    B, S, T, D = 128, 160000, 997, 13
    nbytes = work.frontend_bytes(B, S, T, D)
    assert nbytes == 4 * (B * S + B * T * D * 3 + B)
    # 128 x 10 s of mfcc 13: the audio and the features, about 101.8 MB
    assert abs(nbytes / 1e6 - 101.8) < 0.1
    least = work.frontend_least_s(CNN, B, S, T)
    assert math.isclose(least, nbytes / work.HBM_BYTES_PER_S)   # bytes bind
    ops = work.frontend_ops_per_frame(CNN)
    # a 512-point real FFT is most of a frame's work
    assert 2.5 * 512 * 9 < ops < 2 * 2.5 * 512 * 9


def test_mel_nonzeros_count_the_filters_support():
    fb = ref._mel_filterbank(40, 257, 16000)
    assert work._mel_nonzeros(40, 512, 16000) == int((fb != 0).sum())
    assert (fb != 0).sum() < 2 * 257


def hand_count_cnn(c, frames, steps):
    """Written out for the tiny config below, term by term."""
    t1, d1 = (frames + frames % 2) // 2, (c["feat_dim"] + c["feat_dim"] % 2) // 2
    t2, d2 = (t1 + t1 % 2) // 2, (d1 + d1 % 2) // 2
    C, u = c["num_enc_channels"], c["enc_units"]
    conv = 2 * t1 * d1 * C * 3 * 9 + 2 * t2 * d2 * C * C * 9
    rnn = 0
    d = d2 * C
    for _ in range(c["num_enc_layers"]):
        rnn += 2 * t2 * (2 * d * u + 2 * u * u) + 2 * t2 * 2 * u * u
        d = u
    A, U, L, E, V = (c["attention_size"], c["dec_units"], c["num_dec_layers"],
                     c["embedding_size"], c["vocab_size"])
    K, Ch = c["loc_kernel_size"], c["loc_num_channels"]
    att = (2 * L * U * A + 3 * t2 * A + 3 * t2 + 2 * t2 * u
           + 2 * t2 * Ch * K + 2 * t2 * Ch * A)
    cells = 2 * (E + u + U) * U + 2 * (U + U) * U
    step = att + cells + 2 * U * V
    return (frames * work.frontend_ops_per_frame(c) + conv + rnn
            + 2 * t2 * u * A + steps * step)


TINY = dict(vocab_size=11, feat_dim=5, num_enc_channels=3, enc_units=6,
            num_enc_layers=2, attention_size=4, loc_kernel_size=5,
            loc_num_channels=2, dec_units=7, embedding_size=3)


def test_las_count_against_a_hand_count():
    c = dict(CNN, **TINY)
    assert work.forward_flops(ref, c, 37, 9) == hand_count_cnn(c, 37, 9)
    assert work.step_budget(c, 100) == 12
    assert work.step_budget(CNN, 3598) == 431


def test_listener_count_against_torch_flop_counter():
    for base in (CNN, PBL):
        c = dict(base, **TINY)
        w = weights.make(ref.param_spec(c), 3, torch.device("cpu"))
        feats = torch.randn(2, 41, c["feat_dim"], 3)
        with FlopCounterMode(display=False) as fc:
            ref.listen(w, c, feats, torch.tensor([41, 30]))
        assert fc.get_total_flops() == 2 * ref.listener_flops(c, 41)



# digests and counts of the LAS arithmetic as the parent of the change
# that moved it into the reference module gave them: the weights drawn in
# the same order, and the same counts, exactly
PINNED_WEIGHTS = {
    1: "b2c21f017700ac3ccd7c2d894178229ffb2b8cb675ec00ce73a2b90032ccd97b",
    2: "16b6d65c6fe7315159acbab24c7a39b8b9f4594002567b017e61fa7a1a71ee35"}
PINNED_FLOPS = {"PBL": [9095574.0, 2271194013.0, 6183003429.0],
                "CNN": [30664211.0, 3466024260.0, 10264481880.0]}
SHAPES = ((1, 1), (639, 77), (1709, 231))


def test_las_weights_and_counts_are_pinned():
    for seed, digest in PINNED_WEIGHTS.items():
        w = weights.make(ref.param_spec(PBL), seed, torch.device("cpu"))
        h = hashlib.sha256()
        for k, v in w.items():
            h.update(f"{k} {tuple(v.shape)} {v.dtype};".encode())
            h.update(v.numpy().tobytes())
        assert len(w) == 50 and h.hexdigest() == digest, seed
    for name, c in (("PBL", PBL), ("CNN", CNN)):
        got = [work.forward_flops(ref, c, f, s) for f, s in SHAPES]
        assert got == PINNED_FLOPS[name], name
