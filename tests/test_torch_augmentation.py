"""The port's augmentation (automatic_speech_recognition_torch/ops/
augmentation.py and its wiring into the train step and the loss) against
the JAX package's ops/augmentation.py.

Tolerances:
- resample_rational_device against JAX's on the same batch: rtol 1e-5 /
  atol 1e-6 (float32 convolutions with sums in another order), and
  against the host _resample_sinc (float64 upfirdn): atol 1e-5;
- the pink-noise FIR: equal (the same NumPy code);
- the noise SNR over valid samples equals the drawn SNR within 1e-3 dB
  (float32 power sums).
The random draws (gains, noise, SNRs, coins, masks) come from
torch.Generators, not JAX keys, so they are held to their ranges and
statistics with fixed seeds.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.ops import augmentation as jaug
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.ops import augmentation as taug
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

from test_torch_las import small_cfg

CPU = torch.device("cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _batch(rng, lens=(3200, 2777), S=4000, scale=0.3):
    sig = np.zeros((len(lens), S), np.float32)
    for i, n in enumerate(lens):
        sig[i, :n] = scale * rng.standard_normal(n).astype(np.float32)
    return sig, np.asarray(lens, np.int32)


@pytest.mark.parametrize("speed", [0.9, 1.0, 1.1])
def test_resampler_matches_jax_and_the_host(rng, speed):
    sig, lens = _batch(rng)
    frac = taug._rational_speed(speed)
    down, up = frac.numerator, frac.denominator
    got, got_len = taug.resample_rational_device(
        torch.from_numpy(sig), torch.from_numpy(lens), up, down)
    want, want_len = jaug.resample_rational_device(
        jnp.asarray(sig), jnp.asarray(lens), up, down)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for i, n in enumerate(lens):
        n_out = int(got_len[i])
        assert n_out == (n * up) // down
        if up != down:
            ref = taug._resample_sinc(sig[i, :n], up, down, n_out)
            np.testing.assert_allclose(got[i, :n_out].numpy(), ref, rtol=0,
                                       atol=1e-5)
        assert not got[i, n_out:].any()        # masked past the new length


def test_pink_fir_equals_jax():
    np.testing.assert_array_equal(taug._pink_fir(), jaug._pink_fir())


def test_speed_perturb_draws_one_configured_rate_per_batch(rng):
    sig, lens = _batch(rng)
    cfg = Config(online_speed_perturb=True, online_speed_rates="0.9,1.0,1.1")
    per_rate = {}
    for up, down in taug._rate_fractions(cfg.online_speed_rates):
        out, n = taug.resample_rational_device(
            torch.from_numpy(sig), torch.from_numpy(lens), up, down)
        per_rate[(up, down)] = (out, n)
    seen = set()
    for step in range(16):
        out, n = taug.online_speed_perturb(taug.rate_generator(0, step),
                                           torch.from_numpy(sig),
                                           torch.from_numpy(lens), cfg)
        hit = [k for k, (o, m) in per_rate.items()
               if torch.equal(o, out) and torch.equal(m, n)]
        assert len(hit) == 1
        seen.add(hit[0])
    assert len(seen) == 3                       # every rate is reachable


def test_volume_gain_range_and_clipping(rng):
    cfg = Config(online_volume_low=0.5, online_volume_high=2.0)
    sig = torch.from_numpy(rng.uniform(-0.2, 0.2, (64, 100))
                           .astype(np.float32))
    sig[:, 0] = 0.9                              # clips at gains > 1.11
    out = taug.online_volume_perturb(_gen(), sig, cfg)
    gains = out[:, 1:] / sig[:, 1:]
    g = gains[:, 0]
    torch.testing.assert_close(gains, g[:, None].expand_as(gains),
                               rtol=1e-5, atol=1e-6)   # one gain a row
    assert float(g.min()) >= 0.5 and float(g.max()) <= 2.0
    assert float(g.max()) - float(g.min()) > 1.0       # spread over range
    torch.testing.assert_close(out[:, 0], torch.clamp(0.9 * g, max=1.0))
    with pytest.raises(ValueError):
        taug.online_volume_perturb(_gen(), sig, Config(online_volume_low=0))


@pytest.mark.parametrize("kind", ["white", "pink"])
def test_noise_snr_padding_and_silent_rows(rng, kind):
    cfg = Config(online_noise_snr_low=10.0, online_noise_snr_high=10.0,
                 online_noise_kind=kind)
    sig, lens = _batch(rng, lens=(3000, 1500, 2200), S=3200, scale=0.05)
    sig[2] = 0.0                                  # a silent row
    out = taug.online_noise_perturb(_gen(), torch.from_numpy(sig),
                                    torch.from_numpy(lens), cfg).numpy()
    for i, n in enumerate(lens):
        assert not out[i, n:].any()               # padding stays zero
    assert not out[2].any()                       # silent: no noise
    for i in range(2):
        n = lens[i]
        added = out[i, :n].astype(np.float64) - sig[i, :n]
        snr = 10 * np.log10(np.mean(sig[i, :n].astype(np.float64) ** 2)
                            / np.mean(added ** 2))
        assert abs(snr - 10.0) < 1e-3, snr


def test_noise_snr_is_drawn_per_utterance_within_range(rng):
    cfg = Config(online_noise_snr_low=5.0, online_noise_snr_high=20.0)
    sig, lens = _batch(rng, lens=[4000] * 32, S=4000, scale=0.01)
    out = taug.online_noise_perturb(_gen(1), torch.from_numpy(sig),
                                    torch.from_numpy(lens), cfg).numpy()
    added = out.astype(np.float64) - sig
    snr = 10 * np.log10(np.mean(sig.astype(np.float64) ** 2, 1)
                        / np.mean(added ** 2, 1))
    assert snr.min() >= 5.0 - 1e-3 and snr.max() <= 20.0 + 1e-3
    assert snr.max() - snr.min() > 5.0


def test_noise_coin_at_p_below_one(rng):
    cfg = Config(online_noise_p=0.3)
    sig, lens = _batch(rng, lens=[800] * 400, S=800, scale=0.05)
    out = taug.online_noise_perturb(_gen(2), torch.from_numpy(sig),
                                    torch.from_numpy(lens), cfg).numpy()
    clean = (out == sig).all(1)
    # 400 Bernoulli(0.7) misses: std of the share ~0.023
    assert abs(clean.mean() - 0.7) < 0.1, clean.mean()
    assert not (out[~clean] == sig[~clean]).all(1).any()
    with pytest.raises(ValueError):
        taug.online_noise_perturb(_gen(), torch.from_numpy(sig),
                                  torch.from_numpy(lens),
                                  Config(online_noise_p=1.5))


def test_spec_augment_masks_within_bounds(rng):
    cfg = Config(spec_augment=True, sa_freq_masks=2, sa_freq_width=3,
                 sa_time_masks=2, sa_time_width=10, sa_time_ratio=0.5)
    B, T, D = 4, 64, 13
    audio = torch.from_numpy(rng.standard_normal((B, T, D, 3))
                             .astype(np.float32))
    audiolen = torch.tensor([64, 40, 16, 8], dtype=torch.int32)
    out = taug.spec_augment(_gen(3), audio, audiolen, cfg)
    assert out.shape == audio.shape
    changed = (out != audio).numpy()
    assert changed.any()
    for b in range(B):
        n = int(audiolen[b])
        # fully changed frames come from a time mask (freq masks cover at
        # most 6 of 13 rows): inside the utterance, at most 2 * cap
        tcols = np.nonzero(changed[b].all(axis=(1, 2)))[0]
        assert (tcols < n).all(), (b, tcols, n)
        assert len(tcols) <= 2 * min(10, int(0.5 * n))
        # fully changed rows come from a frequency mask: at most 2 * 3
        frows = np.nonzero(changed[b].all(axis=(0, 2)))[0]
        assert len(frows) <= 6
        assert (out[b].numpy()[changed[b]] == 0).all()  # zeroed, never moved
    again = taug.spec_augment(_gen(3), audio, audiolen, cfg)
    assert torch.equal(out, again)
    other = taug.spec_augment(_gen(4), audio, audiolen, cfg)
    assert not torch.equal(out, other)


def test_spec_augment_trains_and_leaves_eval_alone(rng):
    cfg = small_cfg(spec_augment=True, sa_freq_width=2, sa_time_width=4,
                    dropout_rate=0.0, scheduled_sampling=False, lr=5e-3)
    audio = torch.from_numpy(rng.standard_normal((4, 32, 13, 3))
                             .astype(np.float32))
    audiolen = torch.full((4,), 32, dtype=torch.int32)
    ys = torch.from_numpy(rng.integers(3, 29, (4, 8)).astype(np.int32))
    ys[:, -1] = 2
    batch = (audio, audiolen, ys, torch.full((4,), 8, dtype=torch.int32))
    ts = trainer.create_train_state(cfg, CPU)
    losses = [trainer.train_step(ts, batch, cfg)["loss"].item()
              for _ in range(20)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # masking happened in the loss: the same state and generator give
    # another loss without it
    g = lambda: torch.Generator().manual_seed(7)
    on = las.total_loss(ts.model, batch, cfg, 8, g(), ts.step)[0]
    off = las.total_loss(ts.model, batch, cfg.replace(spec_augment=False),
                         8, g(), ts.step)[0]
    assert on.item() != off.item()
    a, _ = trainer.eval_forward(ts.model, audio, audiolen, cfg, 8)
    b, _ = trainer.eval_forward(ts.model, audio, audiolen,
                                cfg.replace(spec_augment=False), 8)
    assert torch.equal(a, b)


def _raw_batch(rng, B=4, S=6400):
    lens = np.asarray([S, S - 900, S - 2000, 3000][:B], np.int32)
    sig = np.zeros((B, S, 1, 1), np.float32)
    for i, n in enumerate(lens):
        sig[i, :n, 0, 0] = 0.1 * rng.standard_normal(n)
    ys = rng.integers(3, 29, (B, 6)).astype(np.int32)
    ys[:, -1] = 2
    return tuple(map(torch.from_numpy, (sig, lens, ys,
                                        np.full((B,), 6, np.int32))))


AUG = dict(online_speed_perturb=True, online_volume_perturb=True,
           online_noise_perturb=True, online_noise_kind="pink",
           online_noise_p=0.7)


def test_waveform_augmentation_leaves_the_dropout_stream_alone(rng):
    batch = _raw_batch(rng)
    states = {}
    for on in (False, True):
        cfg = small_cfg(audio_shards=True, dropout_rate=0.3,
                        scheduled_sampling=False, **(AUG if on else {}))
        ts = trainer.create_train_state(cfg, CPU)
        m = trainer.train_step(ts, batch, cfg)
        assert np.isfinite(m["loss"].item())
        states[on] = (ts.generator.get_state(), ts.aug_generator.get_state(),
                      m["loss"].item())
    assert torch.equal(states[True][0], states[False][0])
    assert not torch.equal(states[True][1], states[False][1])
    assert states[True][2] != states[False][2]


def test_resume_reproduces_the_augmentation_draws(tmp_path, rng):
    batch = _raw_batch(rng)
    cfg = small_cfg(audio_shards=True, dropout_rate=0.0,
                    scheduled_sampling=False, **AUG)
    ts = trainer.create_train_state(cfg, CPU)
    trainer.train_step(ts, batch, cfg)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, ts)
    want = [trainer.train_step(ts, batch, cfg)["loss"].item()
            for _ in range(2)]
    resumed = ckpt.restore(trainer.create_train_state(cfg, CPU))
    assert resumed.step == 1
    got = [trainer.train_step(resumed, batch, cfg)["loss"].item()
           for _ in range(2)]
    assert got == want
    # a checkpoint written before the augmentation generator existed
    # restores, with that generator seeded from cfg.seed
    payload = torch.load(str(tmp_path / "1.pt"), weights_only=True)
    del payload["aug_generator"]
    torch.save(payload, str(tmp_path / "1.pt"))
    fresh = trainer.create_train_state(cfg, CPU)
    old = ckpt.restore(trainer.create_train_state(cfg, CPU))
    assert old.step == 1
    assert torch.equal(old.aug_generator.get_state(),
                       fresh.aug_generator.get_state())


def test_online_perturbation_needs_audio_shards(tmp_path):
    from automatic_speech_recognition_torch import train as train_cli
    with pytest.raises(ValueError, match="--audio_shards True"):
        train_cli.main(["--device", "cpu", "--online_noise_perturb", "True",
                        "--shard_dir", str(tmp_path)])
