#!/usr/bin/env python3
"""Where the fused frontend kernel's time goes, on one NVIDIA GPU.

    python3 frontend_profile.py          # from the repository root

Builds copies of automatic_speech_recognition_torch/csrc/fused_frontend.cu
into the git-ignored `_build/`: one with clock64() marks between pass 1's
phases (cycles per work item of each team, summed over the run); copies
that each leave one phase out (their output is wrong; only their time
counts); and one that chains the 3xTF32 products through the tensor
cores' accumulator instead of adding each k-step's products on the CUDA
cores.  At 128 x 10 s, mfcc 13 + CMVN + deltas, it prints the cycles per
work item of each phase, the kernel's time beside each copy's (CUDA
events, in turns), and each pass's device time from a torch.profiler
trace.  Then it holds the chained copy to the plain version on
CHAINED_BATCHES seeded batches at the 48 x 8.025 s training shape and
prints how many miss rtol 1e-4 / atol 2e-4 and its worst error.  The copies
are cut from the kernel's source text; a mark that is no longer found once
stops the run.  Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from automatic_speech_recognition_torch.ops import _kernels
from automatic_speech_recognition_torch.ops import cuda_frontend as cf
from automatic_speech_recognition_torch.ops import frontend
from automatic_speech_recognition_torch.ops import frontend_host as host
from chip_smoke import ATOL, RTOL, cuda_ms, kernel_ms

PHASES = ["wait", "stage next", "split", "mma", "combine", "mel", "dct",
          "raw"]
# source line that starts each phase after the first (the loop head)
MARKS = ["    float* seg = buf ? seg1 : seg0;\n",
         "    // split each sample once",
         "    // ares = seg (rows x slen_pad)",
         "    // twiddle combine ->",
         "    // mel (sparse, by filter)",
         "    if (p.mfcc) {  // DCT",
         "    const int n_out = min(p.tt, p.T - t0) * p.D;"]
LOOP = "  for (int buf = 0; item < total; buf ^= 1) {\n"
END = "    item = nxt;\n  }\n}"
# phase -> (text, replacement) that leaves it out
DROP = {"split": ("    for (int h = twarp; h < rows; h += kTeamWarps) {",
                  "    for (int h = twarp; h < 0; h += kTeamWarps) {"),
        "mma": ("    for (int n0 = twarp * 16; n0 < nb2;",
                "    for (int n0 = twarp * 16; n0 < 0;"),
        "combine": ("    if (gk.row < gk.par)", "    if (gk.row < 0)"),
        "mel": ("    if (gf.row < gf.par)", "    if (gf.row < 0)"),
        "dct": ("      if (gd.row < gd.par)", "      if (gd.row < 0)"),
        "statistics": ("  cmvn_stats_kernel<<<", "  if (0) cmvn_stats_kernel<<<")}
# the 3xTF32 products chained through the tensor cores' f32 accumulator,
# instead of a fresh fragment per k-step added on the CUDA cores
CHAINED = (
    """#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) mma_tf32_zero(d[m][c], al[m], bh[c]);
""", """#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            mma_tf32(acc[m][c], al[m], bh[c]);
            mma_tf32(acc[m][c], ah[m], bl[c]);
            mma_tf32(acc[m][c], ah[m], bh[c]);
          }
#if 0
""", """            for (int r = 0; r < 4; ++r) acc[m][c][r] += d[m][c][r];
          }
""", """            for (int r = 0; r < 4; ++r) acc[m][c][r] += d[m][c][r];
          }
#endif
""")
CHAINED_BATCHES = 100
SR = 16000


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"frontend_profile: the kernel source no longer "
                           f"has exactly one {old.strip()!r}")
    return src.replace(old, new)


def chained(src: str) -> str:
    """The source with the tensor cores accumulating across k-steps."""
    return replace_once(replace_once(src, *CHAINED[:2]), *CHAINED[2:])


def instrumented(src: str) -> str:
    """The source with per-phase clock64 sums of each team's thread 0,
    read back by asr_phase_clocks((workers, 10) uint64)."""
    src = replace_once(src, "namespace {\n", "__device__ unsigned long long "
                       "g_clk[4096][10];\nnamespace {\n")
    src = replace_once(src, LOOP, "  unsigned long long clk[10] = {};\n"
                       + LOOP + "    unsigned long long c0 = clock64(), c1;\n")
    for k, mark in enumerate(MARKS):
        src = replace_once(src, mark, f"    c1 = clock64(); clk[{k}] += c1 - "
                           f"c0; c0 = c1;\n{mark}")
    src = replace_once(src, END, f"    clk[{len(MARKS)}] += clock64() - c0; "
                       "clk[9] += 1;\n    item = nxt;\n  }\n  const int w = "
                       "blockIdx.x * kTeams + team;\n  if (ttid == 0 && w < "
                       "4096)\n    for (int k = 0; k < 10; ++k) g_clk[w][k] "
                       "= clk[k];\n}")
    return src + ('\nextern "C" int asr_phase_clocks(unsigned long long* o) {'
                  '\n  return static_cast<int>(cudaMemcpyFromSymbol(o, g_clk,'
                  ' sizeof(g_clk)));\n}\n')


def build(name: str, src: str) -> ctypes.CDLL:
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _kernels.BUILD_DIR / f"{name}.cu"
    path.write_text(src)
    lib = _kernels.load(name, path)
    for fn, argtypes in cf.ARGTYPES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def mfcc_kw(T: int) -> dict:
    return dict(flen=400, fstride=160, fft_length=512, feat_dim=13,
                feat_type="mfcc", num_mel_filters=40, sample_rate=SR,
                frames_max=T, apply_cmvn=True)


def batch(seed: int, B: int, S: int):
    """Seeded noise (B, S) on the card, each row a whole S samples."""
    audio = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (B, S)) * 0.1).astype(np.float32)).cuda()
    T = host.num_frames(S, 400, 160)
    return audio, torch.full((B,), T, dtype=torch.int32, device="cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("frontend_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_kernels.CSRC_DIR / "fused_frontend.cu").read_text()
    libs = {"kernel": build("fused_frontend", src)}
    for phase, (old, new) in DROP.items():
        libs[f"without {phase}"] = build(f"fused_frontend_no_{phase}",
                                         replace_once(src, old, new))
    libs["chained accumulation"] = build("fused_frontend_chained",
                                         chained(src))
    clocks = build("fused_frontend_clocks", instrumented(src))

    B, T = 128, 997
    audio, featlen = batch(0, B, 10 * SR)
    run = lambda: cf.fused_frontend(audio, featlen, **mfcc_kw(T))
    tl = cf.tiling(cf.plan(400, 160, 512, 13, "mfcc", 40, SR), B, T,
                   torch.cuda.get_device_properties(0).multi_processor_count,
                   13)
    cf._lib = lambda: clocks
    run()
    torch.cuda.synchronize()
    raw = np.zeros((4096, 10), np.uint64)
    clocks.asr_phase_clocks(ctypes.c_void_p(raw.ctypes.data))
    used = raw[raw[:, 9] > 0].astype(np.float64)
    per = used[:, :len(PHASES)].sum(0) / used[:, 9].sum()
    print(f"pass 1 at 128 x 10 s, {tl}: cycles per work item of one team: "
          + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, per))
          + f"; total {per.sum():.0f}")

    times = {k: [] for k in libs}
    order = list(libs) + list(libs)[::-1]
    for _ in range(3):
        for k in order:
            cf._lib = lambda lib=libs[k]: lib
            times[k].append(cuda_ms(run, 10))
    base = float(np.median(times["kernel"]))
    for k, v in times.items():
        ms = float(np.median(v))
        print(f"{k:20s} {ms:.4f} ms (runs {[round(x, 4) for x in v]}), "
              f"{base - ms:+.4f} ms against the kernel")
    cf._lib = lambda: libs["kernel"]
    t = kernel_ms(run, ("features_kernel", "cmvn_stats_kernel",
                        "cmvn_deltas_kernel"))
    print(f"device time per launch at 128 x 10 s (torch.profiler): pass 1 "
          f"{t['features_kernel']:.4f} ms, statistics "
          f"{t['cmvn_stats_kernel']:.4f} ms, pass 2 "
          f"{t['cmvn_deltas_kernel']:.4f} ms")

    cf._lib = lambda: libs["chained accumulation"]
    missed, worst = 0, 0.0
    for seed in range(CHAINED_BATCHES):
        audio, featlen = batch(seed, 48, 800 * 160 + 400)
        got = cf.fused_frontend(audio, featlen, **mfcc_kw(801))
        want = frontend.reference_features(audio, featlen, **mfcc_kw(801))
        err = (got - want).abs()
        missed += bool((err > ATOL + RTOL * want.abs()).any())
        worst = max(worst, float(err.max()))
    print(f"chained tensor-core accumulation vs plain at 48 x 8.025 s: "
          f"{missed} of {CHAINED_BATCHES} seeded batches miss rtol {RTOL} / "
          f"atol {ATOL}, worst max abs err {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
