"""The port tests' one-thread rule (tests/torch_cpu.py): this process and
the processes it starts run torch on one intra-op thread, and every
tests/test_torch_*.py imports the helper before anything else.  xdist
imports every test module while collecting, so the run-time checks alone
would pass while a single file still imported the helper: the source
check names a file that forgets it."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

HELPER = "torch_cpu"


def test_this_process_and_its_children_run_one_thread():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert os.environ["MKL_NUM_THREADS"] == "1"
    child = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120, check=True)
    assert child.stdout.split() == ["1"]


def _first_import(path: Path):
    """The module's first import statement after its docstring and any
    `from __future__` import, or None."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return node
        if not (isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Constant)):
            return None
    return None


def test_every_port_test_file_imports_the_helper_first():
    files = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(files) > 30
    missing = []
    for path in files:
        node = _first_import(path)
        if not (isinstance(node, ast.Import)
                and [a.name for a in node.names] == [HELPER]):
            missing.append(path.name)
    assert not missing, (f"these files must `import {HELPER}` before any "
                         f"other import: {missing}")
