"""Boundaries of the PyTorch port: it never imports JAX nor the JAX
package (not even its framework-free modules), never hands back
the CPU for a requested GPU, chip_smoke.py refuses to run without CUDA or
outside the repository, and the kernel build targets sm_90a into a
git-ignored directory."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import automatic_speech_recognition_torch as port
from automatic_speech_recognition_torch.data import _native
from automatic_speech_recognition_torch.ops import _kernels

REPO = Path(__file__).resolve().parent.parent
NO_CUDA = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def _run(code_or_args, cwd=REPO, env=None):
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=cwd, env=env or NO_CUDA,
                          capture_output=True, text=True, timeout=240)


# the recipe stages' entry points, python -m automatic_speech_recognition_
# torch.<name>, beside train, decode and transcribe
ENTRY_POINTS = ("train_subword", "preprocess", "create_shards", "test",
                "train_lm", "sample_lm", "serve")
# the recipe's tools on the port, python -m automatic_speech_recognition_
# torch.tools.<name>
TOOLS = ("synth_corpus", "degrade_corpus", "average_checkpoints", "wer_ci",
         "error_analysis", "study_report")


def test_every_port_module_imports_without_jax_or_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    assert {f"automatic_speech_recognition_torch.{m}" for m in
            ("ops.cuda_frontend", "parallel.distributed", "parallel.mesh",
             "parallel.sharding", "import_checkpoint", *ENTRY_POINTS,
             *(f"tools.{t}" for t in TOOLS))} <= set(names)
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['automatic_speech_recognition_tpu'] = None\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "import chip_smoke, frontend_profile\n"
            "assert not any(m.split('.')[0] in ('jax',\n"
            "               'automatic_speech_recognition_tpu')\n"
            "               for m in sys.modules if sys.modules[m])\n"
            "print('ok', len(sys.modules))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


PORT_SOURCES = sorted(
    [p for p in (REPO / "automatic_speech_recognition_torch").rglob("*.py")
     if "_build" not in p.parts]
    + [REPO / "chip_smoke.py", REPO / "frontend_profile.py"])
FORBIDDEN = ("jax", "automatic_speech_recognition_tpu")


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_of_the_port_names_jax_or_the_jax_package(path):
    """An AST scan: no `import` or `from` of either, at any depth (lazy
    imports inside functions included)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    assert not found, f"{path.relative_to(REPO)} imports {found}"


@pytest.mark.parametrize("name", [n for n in ENTRY_POINTS
                                  if n not in ("train_subword",
                                               "create_shards")])
def test_entry_point_defaults_to_the_gpu_and_refuses_without_one(name):
    """Each device-using entry point, run as `python -m` with no --device,
    asks for CUDA and raises on a host without it."""
    proc = _run([sys.executable, "-m",
                 f"automatic_speech_recognition_torch.{name}"])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]


def test_resolve_device_never_falls_back_to_the_cpu():
    code = ("from automatic_speech_recognition_torch.utils.device import "
            "resolve_device\n"
            "assert resolve_device('cpu').type == 'cpu'\n"
            "try:\n"
            "    resolve_device('cuda')\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "raised: device 'cuda' requested but CUDA is not available" \
        in proc.stdout


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    proc = _run([sys.executable, "chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                env={**env, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_build_targets_sm90a_into_an_ignored_directory(tmp_path):
    cmd = _kernels.nvcc_command(_kernels.CSRC_DIR / "fused_frontend.cu",
                                _kernels.library_path("fused_frontend"))
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    assert {"-shared", "-O3"} <= set(cmd)
    assert _kernels.library_path("fused_frontend").parent == \
        _kernels.BUILD_DIR
    # git's own matcher on the repository's .gitignore, in a scratch repo
    # (the checkout under test need not be a git work tree)
    shutil.copy(REPO / ".gitignore", tmp_path / ".gitignore")
    subprocess.run(["git", "init", "-q"], cwd=tmp_path, check=True)
    rel = _kernels.BUILD_DIR.relative_to(REPO) / "fused_frontend-0.so"
    proc = subprocess.run(["git", "check-ignore", "-q", "--no-index",
                           str(rel)], cwd=tmp_path)
    assert proc.returncode == 0, f"{rel} is not git-ignored"


def test_host_natives_build_from_the_port_into_an_ignored_directory():
    """The shard and FLAC libraries come from the port's csrc/ copies, built
    by the host C++ compiler with native/Makefile's flags into _build/."""
    for lib in ("libshardio.so", "libflacdec.so"):
        src = _native.source_path(lib)
        assert src.parent == _native.CSRC_DIR and src.exists(), src
        assert _native.library_path(lib).parent == _kernels.BUILD_DIR
        cmd = _native.cxx_command(src, _native.library_path(lib))
        assert {"-O3", "-std=c++17", "-fPIC", "-shared"} <= set(cmd)


PORT_SCRIPTS = sorted([REPO / "automatic_speech_recognition_torch" / "run.sh"]
                      + list((REPO / "automatic_speech_recognition_torch"
                              / "tools").glob("*.sh")))


@pytest.mark.parametrize("path", PORT_SCRIPTS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_scripts_call_only_the_ports_modules(path):
    """run.sh and the port's recipe scripts run `python3 -m` of port
    modules (which the scan above covers) and torch's launcher, never a
    root script or a tools/*.py of the JAX package."""
    import re
    text = "\n".join(l for l in path.read_text().splitlines()
                     if not l.lstrip().startswith("#"))
    calls = re.findall(r"python3 (\S+)(?: (\S+))?", text)
    assert calls or path.name == "train_supervised.sh"
    port = {"$port", "automatic_speech_recognition_torch"}
    for first, second in calls:
        if first == "-c":           # the GPU count of run.sh's launcher
            assert "torch.cuda.device_count()" in text
            continue
        assert first == "-m", (path.name, first)
        if second == "torch.distributed.run":
            continue
        package, _, module = second.partition(".")
        assert package in port, (path.name, second)
        rel = module.replace(".", "/") + ".py"
        assert (REPO / "automatic_speech_recognition_torch" / rel).is_file(), \
            second
    assert not re.search(r"(^|\s)(tools/)?\w+\.py\b", text.replace(
        "export_jax_checkpoint.py", "")), path.name


def test_the_exporter_alone_may_import_jax():
    """tools/export_jax_checkpoint.py lies outside the port: it imports
    the JAX package and orbax's manager, never torch; the port's importer
    imports neither."""
    def imported(path):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add((node.module or "").split(".")[0])
        return names
    exporter = imported(REPO / "tools" / "export_jax_checkpoint.py")
    assert {"jax", "automatic_speech_recognition_tpu"} <= exporter
    assert "torch" not in exporter
    importer = imported(REPO / "automatic_speech_recognition_torch"
                        / "import_checkpoint.py")
    assert "torch" in importer and not importer & set(FORBIDDEN)
