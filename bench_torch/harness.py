"""What every driver shares: the cell's files found by name, the run's
record (spans, counters, trace, work, checks), the program's model built
from the yardstick's weights, and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "_cache"


# what no run may load: JAX, its libraries and the JAX package, compared by
# whole top-level names (the port's own name begins with the JAX package's)
FOREIGN = frozenset({"jax", "jaxlib", "flax", "automatic_speech_recognition_tpu"})


class Refused(RuntimeError):
    """A run that may print no result."""


def foreign_modules() -> list:
    """The top-level names of FOREIGN that `sys.modules` holds now."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FOREIGN)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(bench: dict, key: str, name: str) -> dict:
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    """A module from a file whose name may hold dots (metric readers)."""
    spec = importlib.util.spec_from_file_location(
        "bench_torch._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_probe() -> float:
    """Seconds a fixed pure-Python loop takes: the host's speed at that
    moment.  A one-chip machine shares its host's cores, and every
    host-bound metric here moves with this reading, so each run prints
    it beside its numbers."""
    t = time.perf_counter()
    x = 0
    for i in range(300_000):
        x += i * i % 7
    return time.perf_counter() - t


def set_cache_dirs() -> None:
    """Triton's cache at a fixed path inside the checkout (the program's
    nvcc builds go to its own _build/ there)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


@dataclass
class Run:
    """One run of one cell: what the driver records and the harness
    reports."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    control: bool
    t_start: float
    bench: dict
    cell: dict
    config: dict          # the configuration file
    mix: dict             # the traffic file
    faults: Tuple[str, ...] = ()   # planted by the fault tests only
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    e2e: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, list] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)
    traced: Optional[dict] = None
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    control_checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    chips: int = 1
    device: Any = None

    @property
    def values(self) -> dict:
        return self.config["values"]

    def span(self, name: str, *row) -> None:
        self.spans.setdefault(name, []).append(row)

    def note(self, line: str) -> None:
        """A line printed before the result (not compared, not a metric)."""
        print(line, flush=True)

    def check(self, name: str, value: float, control: Optional[float] = None
              ) -> None:
        """A number compared against the mix's limit for it; a control
        reading beside it when the run is a control run."""
        limit = self.mix["check"]["limits"][name]
        self.checks[name] = (value, limit)
        if control is not None:
            self.control_checks[name] = (control, limit)

    def correct(self) -> bool:
        table = self.control_checks if self.control else self.checks
        return bool(table) and all(
            math.isfinite(v) and v <= lim for v, lim in table.values())


def program_config(values: dict, **extra):
    """The program's Config from the configuration file's values."""
    from automatic_speech_recognition_torch.config import Config
    fields = Config.__dataclass_fields__
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in {**values, **extra}.items() if k in fields}
    return Config(**kw)


def build_model(cfg, weights: dict, device):
    """The program's LAS at cfg, built without an init pass and loaded
    with the yardstick's weights (a missing or unexpected tensor fails)."""
    import torch
    from automatic_speech_recognition_torch.models.las import LAS
    with torch.device("meta"):
        model = LAS(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def result_line(run: Run, metrics: Dict[str, Tuple[float, str]],
                device: dict, breakdown: Optional[dict]) -> str:
    out = {"correct": run.correct(), "attempted": run.attempted,
           "failed": run.failed,
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    table = run.control_checks if run.control else run.checks
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in table.items()}
    return json.dumps(out)


def print_checks(run: Run) -> None:
    for name, (v, lim) in run.checks.items():
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    for name, (v, lim) in run.control_checks.items():
        print(f"control {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()


def driver(mix: dict):
    return importlib.import_module(f"bench_torch.drivers.{mix['driver']}")


def reference(config: dict):
    return importlib.import_module(f"bench_torch.reference.{config['reference']}")
