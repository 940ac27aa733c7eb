"""Nothing under bench_torch imports JAX, the JAX package, bench.py or
benchmarks/; the plain reference imports nothing of the program."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "automatic_speech_recognition_tpu", "bench",
          "benchmarks", "flax", "optax", "orbax")


def imported(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_anywhere():
    files = list(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in imported(f):
            top = name.split(".")[0]
            assert top not in BANNED, f"{f}: imports {name}"


def test_reference_stands_apart_from_the_program():
    for f in (HERE / "reference").rglob("*.py"):
        for name in imported(f):
            assert not name.startswith("automatic_speech_recognition"), f
