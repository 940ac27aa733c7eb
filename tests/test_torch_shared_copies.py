"""The port's copies of the JAX package's framework-free modules, held to
their originals.

The port imports nothing of automatic_speech_recognition_tpu, so it keeps
copies of the modules it needs at the same relative paths.  Each copy is
held to its original twice: by source (every top-level definition the
same, apart from the parts the copy leaves out on purpose, listed below)
and by behaviour on the same inputs (configs and flag parsing, tokenizers,
the NumPy frontend golden, ARSH shards written by one package and read by
the other, natively and in Python, loader batches, the speed-rate bound,
synthesized speech).  Two modules are copied in part beside the port's
own code: the host half of ops/augmentation.py and
models/char_rnn.BatchGenerator.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from automatic_speech_recognition_tpu import config as jconfig
from automatic_speech_recognition_tpu.data import pipeline as jpipeline
from automatic_speech_recognition_tpu.data import shards as jshards
from automatic_speech_recognition_tpu.data import shards_native as jnative
from automatic_speech_recognition_tpu.ops import augmentation as jaug
from automatic_speech_recognition_tpu.ops import frontend_host as jhost
from automatic_speech_recognition_tpu.utils import formant_synth as jsynth
from automatic_speech_recognition_tpu.utils import text as jtext
from automatic_speech_recognition_tpu.utils import tokenizer as jtok
from automatic_speech_recognition_torch import config as tconfig
from automatic_speech_recognition_torch.data import pipeline as tpipeline
from automatic_speech_recognition_torch.data import shards as tshards
from automatic_speech_recognition_torch.data import shards_native as tnative
from automatic_speech_recognition_torch.ops import augmentation as taug
from automatic_speech_recognition_torch.ops import frontend_host as thost
from automatic_speech_recognition_torch.utils import formant_synth as tsynth
from automatic_speech_recognition_torch.utils import text as ttext
from automatic_speech_recognition_torch.utils import tokenizer as ttok

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "automatic_speech_recognition_tpu"
PORT = REPO / "automatic_speech_recognition_torch"

# module -> top-level names of the original that the copy leaves out
COPIES = {
    "config.py": (), "utils/tokenizer.py": (), "utils/text.py": (),
    "utils/numerics.py": (), "utils/watchdog.py": (),
    "utils/summary.py": ("profile_trace",),          # jax.profiler
    "utils/formant_synth.py": ("enable_accel", "_voiced_accel",
                               "_accel_fn", "_ACCEL_KPAD", "_ACCEL_TPAD"),
    "data/pipeline.py": (), "data/shards.py": (),
    "data/shards_native.py": (), "data/flac.py": (), "data/audio_io.py": (),
    "data/flac_encode.py": (),
    "training/monitor.py": (), "ops/frontend_host.py": (),
}
# definitions that differ because of what the copy leaves out, or (in
# config.py) because of the port's own fields, PORT_FIELDS
CHANGED = {"utils/formant_synth.py": {"synth_tracks"},
           "config.py": {"Config", "MODEL_FIELDS"}}
# the port's own Config fields (not in the JAX package's) and defaults
PORT_FIELDS = {"rnn_cell": "rnn"}


def _definitions(path: Path):
    """Top-level name -> source of each def, class and assignment, and
    the sorted import lines (the module docstring is not compared)."""
    text = path.read_text()
    defs, imports = {}, []
    for node in ast.parse(text).body:
        src = ast.get_source_segment(text, node)
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defs[node.name] = src
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                defs[ast.unparse(t)] = src
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imports.append(src)
    return defs, sorted(imports)


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_keeps_the_original_source(module):
    want, want_imports = _definitions(JAX_PKG / module)
    got, got_imports = _definitions(PORT / module)
    left_out = set(COPIES[module])
    assert set(want) - set(got) == left_out
    assert set(got) <= set(want)
    for name in set(got) - CHANGED.get(module, set()):
        assert got[name] == want[name], f"{module}: {name} differs"
    assert got_imports == want_imports
    assert f"automatic_speech_recognition_tpu/{module}" in \
        ast.get_docstring(ast.parse((PORT / module).read_text()))


def test_formant_synth_keeps_only_the_numpy_voiced_path():
    body = _definitions(PORT / "utils/formant_synth.py")[0]["synth_tracks"]
    orig = _definitions(JAX_PKG / "utils/formant_synth.py")[0]["synth_tracks"]
    assert "_accel_fn" in orig and "_accel_fn" not in body
    assert "voiced = np.sum(amps * np.sin(phase[:, None] * k[None, :])" \
        in body


def _fields(cfg):
    """The fields both packages have (PORT_FIELDS left out)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in PORT_FIELDS}


def test_config_defaults_field_by_field():
    want, got = _fields(jconfig.Config()), _fields(tconfig.Config())
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    port = tconfig.Config()
    assert {k: getattr(port, k) for k in PORT_FIELDS} == PORT_FIELDS
    assert tuple(f for f in tconfig.MODEL_FIELDS if f not in PORT_FIELDS) \
        == jconfig.MODEL_FIELDS
    assert set(PORT_FIELDS) <= set(tconfig.MODEL_FIELDS)


def test_config_differs_from_the_original_only_by_the_port_fields():
    """Config and MODEL_FIELDS are the original's but for the lines that
    name a PORT_FIELDS field (and the comment above the field)."""
    want = _definitions(JAX_PKG / "config.py")[0]
    got = _definitions(PORT / "config.py")[0]
    for name in CHANGED["config.py"]:
        lines = got[name].splitlines()
        keep = [line for i, line in enumerate(lines)
                if not any(f in line for f in PORT_FIELDS)
                and not (line.strip().startswith("#") and any(
                    f in "".join(lines[i:i + 4]) for f in PORT_FIELDS))]
        assert keep == want[name].splitlines(), name


TRAIN_FLAGS = ["--unit", "char", "--feat_dim", "13", "--enc_units", "64",
               "--num_enc_layers", "2", "--mode", "loc", "--ctc", "True",
               "--ctc_weight", "0.2", "--lr", "1e-4", "--grad_clip", "5",
               "--bucket_boundaries_train", "200,800,1600",
               "--audio_shards", "True", "--epoch", "3", "-bs", "16"]
DECODE_FLAGS = ["--beam_size", "8", "--beam_logprob", "True",
                "--apply_lm", "True", "--lm_weight", "0.5",
                "--ctc_beam_weight", "0.5", "--split", "dev",
                "--use_saved_config", "True", "-vb", "1"]


@pytest.mark.parametrize("argv", [[], TRAIN_FLAGS, DECODE_FLAGS],
                         ids=["defaults", "train", "decode"])
def test_flag_parse(argv):
    want, got = jconfig.parse_args(argv), tconfig.parse_args(argv)
    assert _fields(got) == _fields(want)
    assert _fields(got.replace(lr=3e-4)) == _fields(want.replace(lr=3e-4))


def test_saved_config_round_trips_between_the_packages(tmp_path):
    """A config.json written by the port loads in both packages alike
    (and so do the snapshots PRs 2-3 wrote, which the JAX package's
    writer defines)."""
    tconfig.save_config_snapshot(tconfig.parse_args(TRAIN_FLAGS),
                                 str(tmp_path))
    want, want_over = jconfig.apply_saved_model_config(jconfig.Config(),
                                                       str(tmp_path))
    got, got_over = tconfig.apply_saved_model_config(tconfig.Config(),
                                                     str(tmp_path))
    assert _fields(got) == _fields(want) and got_over == want_over
    assert got.rnn_cell == "rnn"
    assert tconfig.check_model_config(tconfig.Config(), str(tmp_path)) == \
        jconfig.check_model_config(jconfig.Config(), str(tmp_path))


CORPUS = ["hello world", "the quick brown fox jumps over the lazy dog",
          "it's a test, isn't it?", "numbers 123 and UPPER case",
          "repeated repeated words words words"]


def test_char_tokenizer():
    j, t = jtok.CharEncoder(), ttok.CharEncoder()
    assert t.get_vocab_size() == j.get_vocab_size()
    assert t.id_to_token == j.id_to_token
    for s in (jtext.strip_punctuation(c).upper() for c in CORPUS[:3]):
        ids = t.encode(s, with_eos=True)
        assert ids == j.encode(s, with_eos=True)
        assert t.decode(ids) == j.decode(ids)
        assert ttext.convert_idx_to_string(ids, t.id_to_token, "char") == \
            jtext.convert_idx_to_string(ids, j.id_to_token, "char")


def test_subword_tokenizer(tmp_path):
    texts = [s.lower() for s in CORPUS] * 3
    j = jtok.CharBPE.train(texts, 60)
    t = ttok.CharBPE.train(texts, 60)
    jv, jm = j.save(str(tmp_path / "j"))
    tv, tm = t.save(str(tmp_path / "t"))
    assert Path(tv).read_text() == Path(jv).read_text()
    assert Path(tm).read_text() == Path(jm).read_text()
    for s in CORPUS:
        assert t.encode(s.lower()) == j.encode(s.lower())
        assert t.decode(t.encode(s.lower())) == j.decode(j.encode(s.lower()))


def test_lm_vocab_and_text_metrics():
    assert ttext.lm_vocab() == jtext.lm_vocab()
    for r, h in [("a b c", "a c"), ("hello world", "hello word"),
                 ("x", "")]:
        assert ttext.wer(r, h) == jtext.wer(r, h)
        assert ttext.edit_distance(r, h) == jtext.edit_distance(r, h)
    assert ttext.corpus_cer(CORPUS, CORPUS[::-1]) == \
        jtext.corpus_cer(CORPUS, CORPUS[::-1])
    assert [ttext.clean_lm_text(s) for s in CORPUS] == \
        [jtext.clean_lm_text(s) for s in CORPUS]


@pytest.mark.parametrize("n_filters,coeffs,sr",
                         [(40, 257, 16000), (26, 257, 8000),
                          (13, 129, 16000)])
def test_frontend_host_constants(n_filters, coeffs, sr):
    np.testing.assert_array_equal(
        thost.mel_filterbank(n_filters, coeffs, sr, 0, sr / 2),
        jhost.mel_filterbank(n_filters, coeffs, sr, 0, sr / 2))
    np.testing.assert_array_equal(thost.dct_matrix(n_filters, 13),
                                  jhost.dct_matrix(n_filters, 13))


@pytest.mark.parametrize("feat_type", ["mfcc", "fbank"])
def test_frontend_host_process_audio(rng, feat_type):
    sig = rng.standard_normal(16000 + 777) * 0.1
    want = jhost.process_audio(sig, 16000, 25, 10, 13, feat_type, True)
    got = thost.process_audio(sig, 16000, 25, 10, 13, feat_type, True)
    np.testing.assert_array_equal(got, want)


def _records(rng, n=7):
    feats = [rng.standard_normal((int(rng.integers(50, 400)), 1, 1))
             .astype(np.float32) for _ in range(n)]
    toks = [rng.integers(3, 30, int(rng.integers(1, 12))).astype(np.int32)
            for _ in range(n)]
    return feats, toks


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_cross_read(tmp_path, rng, writer, native):
    feats, toks = _records(rng)
    path = str(tmp_path / "x.arsh")
    (jshards if writer == "jax" else tshards).write_shard(path, feats, toks)
    reader_mod = ((tnative.NativeShardReader, jnative.NativeShardReader)
                  if native else (tshards.ShardReader, jshards.ShardReader))
    if native:
        assert tnative.available() and jnative.available()
    readers = [cls(path) for cls in reader_mod]
    for r in readers:
        assert len(r) == len(feats)
    for i in range(len(feats)):
        if native:
            outs = []
            for r in readers:
                a = np.zeros((400, 1, 1), np.float32)
                t = np.zeros((16,), np.int32)
                outs.append((r.read_into(i, a, t), a, t))
            (n0, a0, t0), (n1, a1, t1) = outs
            assert n0 == n1 == (len(feats[i]), len(toks[i]))
            np.testing.assert_array_equal(a0, a1)
            np.testing.assert_array_equal(t0, t1)
        else:
            (f0, k0), (f1, k1) = (r.record(i) for r in readers)
            np.testing.assert_array_equal(f0, feats[i])
            np.testing.assert_array_equal(f1, feats[i])
            np.testing.assert_array_equal(k0, k1)


@pytest.mark.parametrize("is_training", [True, False])
def test_bucketed_loader_batches(tmp_path, rng, is_training):
    feats, toks = _records(rng, n=24)
    for k in range(2):
        tshards.write_shard(str(tmp_path / f"s-{k}.arsh"), feats[k::2],
                            toks[k::2])
    files = sorted(str(p) for p in tmp_path.glob("s-*.arsh"))
    kw = dict(feat_dim=1, bucket_boundaries_train=(150, 300, 450),
              bucket_boundaries_eval=(150, 300, 450),
              bucket_batch_sizes=(4, 3, 2))
    loaders = [mod.BucketedLoader(files, cfg(**kw), is_training=is_training,
                                  seed=5, use_native=native)
               for mod, cfg, native in ((jpipeline, jconfig.Config, False),
                                        (tpipeline, tconfig.Config, True))]
    assert loaders[1].num_records == loaders[0].num_records == 24
    want = [b for _, b in zip(range(8), loaders[0])]
    got = [b for _, b in zip(range(8), loaders[1])]
    assert len(got) == len(want) >= 4
    for bj, bt in zip(want, got):
        for a, b in zip(bj, bt):
            np.testing.assert_array_equal(b, a)
    assert loaders[1].batches_per_epoch() == loaders[0].batches_per_epoch()


@pytest.mark.parametrize("spec", ["0.9,1.1", "0.9,1.0,1.1", "0.95", "1.25"])
@pytest.mark.parametrize("n", [1, 400, 16000, 160_123])
def test_worst_stretch_len(spec, n):
    assert taug.worst_stretch_len(n, spec) == jaug.worst_stretch_len(n, spec)


def test_formant_synth_same_generator():
    phones = ["HH", "AH", "L", "OW", "SP", "W", "ER", "L", "D"]
    got = tsynth.synth_phones(phones, rng=np.random.default_rng(4))
    want = jsynth.synth_phones(phones, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    assert {k: dataclasses.astuple(v) for k, v in tsynth.PHONES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jsynth.PHONES.items()}


# the host half of ops/augmentation.py, copied as it is beside the port's
# own device half; and char_rnn.BatchGenerator beside the port's LM
HOST_HALF = ("_KAISER_BETA", "_NUM_ZEROS", "_rational_speed",
             "design_resample_filter", "_resample_sinc", "speed_perturb",
             "volume_perturb", "SPEED_LIST", "speed_augment_all",
             "host_noise", "make_degrader", "_parse_rates",
             "_rate_fractions", "worst_stretch_len", "_pink_fir")


@pytest.mark.parametrize("module,names", [
    ("ops/augmentation.py", HOST_HALF),
    ("models/char_rnn.py", ("BatchGenerator",)),
    # the exit-code contract; honor_platform_env and
    # enable_compilation_cache are JAX's platform and XLA cache; the
    # markers are held by test_the_port_keeps_every_transient_marker
    ("utils/platform.py", ("TRANSIENT_EXIT_CODE",
                           "is_transient_platform_error",
                           "exit_for_transient_errors")),
    ("utils/memlog.py", ("rss_gb",))])
def test_partial_copy_keeps_the_original_source(module, names):
    want = _definitions(JAX_PKG / module)[0]
    got = _definitions(PORT / module)[0]
    for name in names:
        assert got[name] == want[name], f"{module}: {name} differs"


def test_the_port_keeps_every_transient_marker():
    """The port's _TRANSIENT_MARKERS begin with the original's, in its
    order; the port adds only transport messages of its own collectives
    after them (gloo's dead-peer "Connection closed by peer")."""
    def markers(path):
        src = _definitions(path)[0]["_TRANSIENT_MARKERS"]
        return ast.literal_eval(ast.parse(src).body[0].value)

    want = markers(JAX_PKG / "utils/platform.py")
    got = markers(PORT / "utils/platform.py")
    assert got[:len(want)] == want
    assert got[len(want):] == ("Connection closed by peer",)


@pytest.mark.parametrize("speed", [0.9, 1.1, 1.0, 0.95])
@pytest.mark.parametrize("quality", ["sinc", "linear"])
def test_speed_perturb_same_samples(rng, speed, quality):
    sig = (0.3 * rng.standard_normal(4001)).astype(np.float32)
    np.testing.assert_array_equal(
        taug.speed_perturb(sig, speed, quality),
        jaug.speed_perturb(sig, speed, quality))
    np.testing.assert_array_equal(taug.speed_augment_all([sig], speed)[0],
                                  jaug.speed_augment_all([sig], speed)[0])


def test_volume_noise_and_degrader_same_outputs(rng):
    sig = (0.5 * rng.standard_normal(3000)).astype(np.float32)
    np.testing.assert_array_equal(taug.volume_perturb(sig, 2.5),
                                  jaug.volume_perturb(sig, 2.5))
    for kind in ("white", "pink"):
        np.testing.assert_array_equal(
            taug.host_noise(np.random.default_rng(1), 999, kind),
            jaug.host_noise(np.random.default_rng(1), 999, kind))
    got = taug.make_degrader("5,15", "pink", 0.5)
    want = jaug.make_degrader("5,15", "pink", 0.5)
    for seed in range(4):
        np.testing.assert_array_equal(got(sig, np.random.default_rng(seed)),
                                      want(sig, np.random.default_rng(seed)))
    assert taug.make_degrader("", "white", 0.0) is None
    np.testing.assert_array_equal(taug.design_resample_filter(10, 9),
                                  jaug.design_resample_filter(10, 9))


def test_batch_generator_same_rows(rng):
    from automatic_speech_recognition_tpu.models import char_rnn as jcr
    from automatic_speech_recognition_torch.models import char_rnn as tcr
    ids = rng.integers(0, 28, 301).astype(np.int32)
    j, t = jcr.BatchGenerator(ids, 7, 10), tcr.BatchGenerator(ids, 7, 10)
    for _ in range(12):
        np.testing.assert_array_equal(t.next(), j.next())


def test_flac_encode_same_bytes_and_the_ports_decoder_reads_them(
        tmp_path, rng):
    from automatic_speech_recognition_tpu.data import flac_encode as jenc
    from automatic_speech_recognition_torch.data import flac as tflac
    from automatic_speech_recognition_torch.data import flac_encode as tenc
    pcm = rng.integers(-3000, 3000, 5000).astype(np.int32)
    for kw in (dict(subframe_kind="verbatim", blocksize=4096),
               dict(subframe_kind="fixed2", blocksize=1024),
               dict(subframe_kind="lpc", blocksize=512)):
        data = tenc.encode_flac([pcm], sample_rate=16000, **kw)
        assert data == jenc.encode_flac([pcm], sample_rate=16000, **kw)
        (tmp_path / "x.flac").write_bytes(data)
        sig, rate = tflac.read_flac(str(tmp_path / "x.flac"))
        assert rate == 16000
        np.testing.assert_array_equal(np.round(sig * 32768).astype(np.int32),
                                      pcm)


# the recipe's tools: plain copies, and ports whose other definitions are
# the JAX tool's (tools/<name> -> automatic_speech_recognition_torch/tools/)
TOOLS = REPO / "tools"
PORT_TOOLS = PORT / "tools"
TOOL_COPIES = {
    "error_analysis.py": set(), "study_report.py": set(),
    # the edit distance comes from the port's utils/text copy
    "wer_ci.py": set(),
    # the port's degrader and FLAC encoder copies; no --accel (JAX)
    "synth_corpus.py": {"make_degrader", "write_flac", "main"},
}


@pytest.mark.parametrize("name", sorted(TOOL_COPIES))
def test_tool_keeps_the_jax_tools_source(name):
    want, want_imports = _definitions(TOOLS / name)
    got, got_imports = _definitions(PORT_TOOLS / name)
    assert set(got) == set(want)
    for d in set(got) - TOOL_COPIES[name]:
        assert got[d] == want[d], f"{name}: {d} differs"
    if name in ("error_analysis.py", "study_report.py"):
        assert got_imports == want_imports
    assert not any("automatic_speech_recognition_tpu" in i
                   for i in got_imports)
    assert f"tools/{name}" in ast.get_docstring(
        ast.parse((PORT_TOOLS / name).read_text()))


def test_arguments_shim_names_the_ports_config():
    from automatic_speech_recognition_tpu import arguments as jargs
    from automatic_speech_recognition_torch import arguments as targs
    names = ("Config", "build_parser", "parse_args", "str2bool")
    for name in names:
        assert getattr(targs, name) is getattr(tconfig, name)
        assert hasattr(jargs, name)
    assert targs.parse_args(TRAIN_FLAGS) == tconfig.parse_args(TRAIN_FLAGS)
