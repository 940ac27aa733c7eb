// Fused acoustic frontend for Hopper (sm_90a): raw padded audio -> power
// spectrum -> mel -> log/DCT (mfcc) or mel energies (fbank) -> masked
// per-utterance CMVN -> feature-axis delta stacking.
//
// Replaces the TPU kernel automatic_speech_recognition_tpu/ops/
// pallas_frontend.py:_fused_kernel, launched there by fused_frontend and,
// past 1710 frames, by fused_frontend_chunked.  The TPU kernel keeps a whole
// utterance in VMEM; this one tiles frames and needs no length limit.
//
// What bounds it on the H100: HBM.  At 128 x 10 s (mfcc 13 + CMVN + deltas)
// it must read 81.92 MB of audio and write 19.91 MB of features: 30.4 us at
// 3.35 TB/s.  Its arithmetic (the shared-subsegment DFT, the twiddle
// combine, mel, DCT) is about 11 GFLOP: 22 us at the 495 TFLOP/s of TF32
// tensor cores, but 165 us on the 67 TFLOP/s of float32 CUDA cores.  So the
// DFT goes to the tensor cores at float32 accuracy.  The design:
//   - Shared-subsegment DFT, as on the TPU.  g = gcd(flen, fstride) (80 at
//     16 kHz, 25/10 ms); frame t is subsegments step*t .. step*t+J-1, so
//     X_t[k] = sum_j w^(g j k) A_(step t + j)[k] with A_h the g-point DFT of
//     subsegment h over the mel-support bins and bins 0 and N/2 (Parseval
//     frame energy): 2.5x fewer MACs than the framed DFT.  Every bin's
//     twiddles, the energy columns' included, come from the plan, so an odd
//     g needs nothing special.  Where a frame would span more than 16
//     subsegments (a tiny gcd) the plan hands the kernel whole frames
//     (J = 1, step = 1): slower, the same code and the same result.
//   - Tensor cores at float32 accuracy: the (segments x g) @ (g x 2 nbins)
//     product runs as 3xTF32 mma.sync m16n8k8 (hi = cvt.rna.tf32(x),
//     lo = cvt.rna.tf32(x - hi); lo*hi + hi*lo + hi*hi).  One TF32 pass
//     keeps about 3 decimal digits, short of rtol 1e-4.  Each k-step's
//     three products go into a fresh fragment that is added to the running
//     sum on the CUDA cores: chained through the tensor cores' truncating
//     f32 accumulator, a frame whose one-bin mel filter held almost no
//     power came out 7.4e-4 off the plain version (H100;
//     frontend_profile.py prints that copy's error).  The three passes run
//     in turn over all of a warp's fragments, so no product waits on the
//     one before it.  The
//     segments are split once per item (hi in place, lo beside it); the
//     basis is split as it is loaded.  Operand pitches (slen_pad + 4,
//     2 nb + 8) keep fragment loads free of bank conflicts.
//   - Mel on CUDA cores, sparse: each filter's nonzero bins in CSR (about
//     200 FMAs a frame instead of 123 x 40 = 4,920 dense), less than the
//     product would cost on tensor cores.  The DCT (40 x 13) on CUDA cores.
//   - A persistent grid, one 512-thread block per SM in two teams of 256
//     that walk (utterance, frame-tile) work items on their own, so one
//     team's CUDA-core phases overlap the other's tensor-core product.  The
//     basis (80 x 264 f32, 84 KB), twiddles, mel CSR and DCT go to shared
//     memory once per block; the next item's audio comes in by cp.async (16
//     bytes where aligned) while the current one computes.  Items of 16 or
//     32 segment rows (6 or 14 frames); the wrapper takes 32 unless that
//     leaves a team without an item (serving's 8 x 2 s: 264 items of 6).
//     With CMVN on, tiles wholly at or past featlen are skipped: their
//     output is zero.
//   - CMVN over the whole card: pass 1 writes each tile's masked count,
//     mean and M2 per feature; pass 2 runs one block per (utterance, 19
//     frames at D = 13), merges its utterance's partials in a fixed order
//     with Chan's formula (deterministic, no atomics), normalizes its
//     frames once into shared memory and writes [static, delta,
//     delta-delta] as one coalesced run.
//
// C interface, loaded with ctypes (ops/cuda_frontend.py): one entry point,
// asr_fused_frontend, that launches both passes and returns the
// cudaError_t of its launches, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads1 = 512;              // pass-1 block: 16 warps
constexpr int kTeams = 2;                   // of 256 threads, own items
constexpr int kTeamThreads = kThreads1 / kTeams;
constexpr int kTeamWarps = kTeamThreads / 32;
constexpr int kMaxMT = 2;                   // 16-row MMA tiles per item
constexpr int kThreads2 = 256;              // pass-2 block; feat_dim <= 256
constexpr float kEpsZero = 2.220446049250313e-16f;  // float64 eps (speechpy)
// a mel sum or frame energy below the smallest normal float counts as zero
// (as on the TPU, which flushes subnormals): the plain version's per-bin
// power underflows there where this kernel's Parseval energy does not
constexpr float kFltMin = 1.17549435e-38f;
constexpr float kEpsCmvn = 9.313225746154785e-10f;  // 2^-30

struct Params {
  const float* audio;
  const int* featlen;
  const float* basis;    // (slen_pad, 2 nb)
  const float* twiddle;  // (J, nb, 2)
  const int* melptr;     // (F + 1,)
  const int* melbin;     // (nnz,) column in [0, ksup)
  const float* melw;     // (nnz,)
  const float* dct;      // (F, D)
  float* raw;            // (B, T, D)
  float* stats;          // (B, n_tiles, 3, D): count, mean, M2
  int B, S, T, fstride, nfft, slen, slen_pad, sstride, J, step, nbins, nb,
      ksup, F, D, nnz, dct_len, mfcc, cmvn, mt, tt, n_tiles, basis_in_smem;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b with a zero accumulator (the first product of a k-step)
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ int clampi(int c, int lo, int hi) {
  return c < lo ? lo : (c > hi ? hi : c);
}

// First work item item, item + stride, ... that has frames to compute (all
// of them with CMVN off; with it on, those starting below featlen), or total.
__device__ __forceinline__ int next_item(const Params& p, int item,
                                         int total, int stride) {
  if (!p.cmvn) return item < total ? item : total;
  for (; item < total; item += stride) {
    const int b = item / p.n_tiles, tile = item - b * p.n_tiles;
    if (tile * p.tt < clampi(p.featlen[b], 0, p.T)) return item;
  }
  return total;
}

// Threads of one team as `par` rows of `lanes` (lanes = min(n, team size)):
// a loop over (row, column) pairs without a division per element.
struct Grid2 {
  int lanes, par, row, lane;
  __device__ Grid2(int n, int ttid) {
    lanes = n < kTeamThreads ? n : kTeamThreads;
    par = kTeamThreads / lanes;
    row = ttid / lanes;
    lane = ttid - row * lanes;
  }
};

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(kTeamThreads)
               : "memory");
}

// Segment rows of one work item into shared memory by cp.async: row h is
// the samples tile*tt*fstride + h*sstride + n, n < slen (clamped at S - 1
// like the plain frame_signal), zero for slen <= n < slen_pad.  Contiguous
// subsegments away from the clamp go as 16-byte copies.
__device__ void stage_segments(const Params& p, float* seg, int lda,
                               int item, int ttid) {
  const int b = item / p.n_tiles, tile = item - b * p.n_tiles;
  const float* x = p.audio + static_cast<size_t>(b) * p.S;
  const long long base = static_cast<long long>(tile) * p.tt * p.fstride;
  const int rows = p.mt * 16;
  const bool vec = p.sstride == p.slen && p.slen % 4 == 0 && lda % 4 == 0 &&
                   base + static_cast<long long>(rows) * p.slen <= p.S &&
                   (reinterpret_cast<uintptr_t>(x + base) & 15) == 0;
  if (vec) {
    const int quads = p.slen / 4;
    const Grid2 g(quads, ttid);
    if (g.row < g.par)
      for (int h = g.row; h < rows; h += g.par)
        for (int c = g.lane; c < quads; c += g.lanes)
          cp_async16(seg + h * lda + 4 * c, x + base + h * p.slen + 4 * c);
    for (int i = ttid; i < rows * (p.slen_pad - p.slen); i += kTeamThreads) {
      const int w = p.slen_pad - p.slen, h = i / w;
      seg[h * lda + p.slen + i - h * w] = 0.f;
    }
  } else {
    const Grid2 g(p.slen_pad, ttid);
    if (g.row < g.par)
      for (int h = g.row; h < rows; h += g.par) {
        const long long s0 = base + static_cast<long long>(h) * p.sstride;
        for (int n = g.lane; n < p.slen_pad; n += g.lanes) {
          float* dst = seg + h * lda + n;
          if (n < p.slen) {
            const long long s = s0 + n;
            cp_async4(dst, x + (s < p.S ? s : p.S - 1));
          } else {
            *dst = 0.f;
          }
        }
      }
  }
  cp_async_commit();
}

// Pass 1: raw features (B, T, D) and per-tile CMVN partials.  Two teams of
// 256 threads per block share the constants and work on their own items,
// so one team's CUDA-core phases overlap the other's tensor-core product.
template <int MT>  // 16-row MMA tiles per work item (p.mt)
__global__ void __launch_bounds__(kThreads1, 1)
features_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nb2 = 2 * p.nb;
  const int ldb_s = nb2 + 8, lda = p.slen_pad + 4, ldr = nb2 + 8;
  const int rows = MT * 16;
  // shared memory, in the order ops/cuda_frontend.smem_bytes counts it:
  // the constants, then one set of buffers per team
  float* bs = smem;                                    // basis
  float* tw = bs + (p.basis_in_smem ? p.slen_pad * ldb_s : 0);
  int* melptr = reinterpret_cast<int*>(tw + 2 * p.J * p.nb);
  int* melbin = melptr + p.F + 1;
  float* melw = reinterpret_cast<float*>(melbin + p.nnz);
  float* dct = melw + p.nnz;
  const int tid = threadIdx.x, team = tid / kTeamThreads;
  const int ttid = tid - team * kTeamThreads;
  // each team's buffers start on 16 bytes (cp.async 16, float2 stores)
  const int consts = round4(static_cast<int>(dct + p.dct_len - smem));
  const int team_floats =
      round4(2 * rows * lda + max(rows * lda, p.tt * p.nb) +
             max(rows * ldr, p.tt * (p.F + p.D + 1)) + rows);
  float* seg0 = smem + consts + team * team_floats;   // segments (hi part)
  float* seg1 = seg0 + rows * lda;
  float* lo = seg1 + rows * lda;                       // segments' lo part
  float* psb = lo;                                     // after the product
  float* ares = lo + max(rows * lda, p.tt * p.nb);     // partial DFTs
  float* lm = ares;                                    // after the combine
  float* ft = lm + p.tt * p.F;
  float* le = ft + p.tt * p.D;
  float* q = ares + max(rows * ldr, p.tt * (p.F + p.D + 1));
  const float2* tw2 = reinterpret_cast<const float2*>(tw);

  const int twarp = ttid / 32, lane = tid % 32;
  const int gid = lane >> 2, tq = lane & 3;
  const int total = p.B * p.n_tiles;
  const int workers = gridDim.x * kTeams;

  int item = next_item(p, blockIdx.x * kTeams + team, total, workers);
  if (item < total) stage_segments(p, seg0, lda, item, ttid);
  // constants once per block
  if (p.basis_in_smem)
    for (int n = tid / 32; n < p.slen_pad; n += kThreads1 / 32)
      for (int c = lane; c < nb2; c += 32)
        bs[n * ldb_s + c] = p.basis[n * nb2 + c];
  for (int i = tid; i < 2 * p.J * p.nb; i += blockDim.x) tw[i] = p.twiddle[i];
  for (int i = tid; i <= p.F; i += blockDim.x) melptr[i] = p.melptr[i];
  for (int i = tid; i < p.nnz; i += blockDim.x) {
    melbin[i] = p.melbin[i];
    melw[i] = p.melw[i];
  }
  for (int i = tid; i < p.dct_len; i += blockDim.x) dct[i] = p.dct[i];
  __syncthreads();
  const float* bm = p.basis_in_smem ? bs : p.basis;
  const int ldb = p.basis_in_smem ? ldb_s : nb2;
  const float inv_n = 1.f / static_cast<float>(p.nfft);
  const Grid2 gk(p.nb, ttid), gf(p.F, ttid), gd(p.D, ttid);

  for (int buf = 0; item < total; buf ^= 1) {
    const int nxt = next_item(p, item + workers, total, workers);
    cp_async_wait_all();
    team_sync(team);  // this item's segments are in; the last item is done
    float* seg = buf ? seg1 : seg0;
    if (nxt < total) stage_segments(p, buf ? seg0 : seg1, lda, nxt, ttid);
    const int b = item / p.n_tiles, tile = item - b * p.n_tiles;
    const int t0 = tile * p.tt;

    // split each sample once into TF32 hi (in place) and lo; segment
    // energies sum x^2 (Parseval), one warp per row
    for (int h = twarp; h < rows; h += kTeamWarps) {
      float s = 0.f;
      for (int n = lane; n < p.slen_pad; n += 32) {
        const float v = seg[h * lda + n];
        uint32_t hi, lw;
        split_tf32(v, hi, lw);
        seg[h * lda + n] = __uint_as_float(hi);
        lo[h * lda + n] = __uint_as_float(lw);
        s = fmaf(v, v, s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) q[h] = s;
    }
    team_sync(team);

    // ares = seg (rows x slen_pad) @ basis (slen_pad x 2 nb) as 3xTF32;
    // each warp owns pairs of 8-column tiles over every row tile.  Each
    // k-step's three products go into a fresh fragment that is then added
    // to the running sum on the CUDA cores (round to nearest): the tensor
    // cores' own f32 accumulation truncates, and over the 10 k-steps of a
    // badly cancelling bin that breaks rtol 1e-4 / atol 2e-4.
    for (int n0 = twarp * 16; n0 < nb2; n0 += kTeamWarps * 16) {
      float acc[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][c][r] = 0.f;
      for (int k0 = 0; k0 < p.slen_pad; k0 += 8) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* bp = bm + (k0 + tq) * ldb + n0 + c * 8 + gid;
          split_tf32(bp[0], bh[c][0], bl[c][0]);
          split_tf32(bp[4 * ldb], bh[c][1], bl[c][1]);
        }
        uint32_t ah[MT][4], al[MT][4];
        float d[MT][2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int o = (m * 16 + gid) * lda + k0 + tq;
          const int offs[4] = {o, o + 8 * lda, o + 4, o + 8 * lda + 4};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ah[m][r] = __float_as_uint(seg[offs[r]]);
            al[m][r] = __float_as_uint(lo[offs[r]]);
          }
        }
        // the three passes in turn over every fragment, so that no product
        // waits on the one before it
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) mma_tf32_zero(d[m][c], al[m], bh[c]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) mma_tf32(d[m][c], ah[m], bl[c]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            mma_tf32(d[m][c], ah[m], bh[c]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[m][c][r] += d[m][c][r];
          }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* r0 = ares + (m * 16 + gid) * ldr + n0 + c * 8 + 2 * tq;
          *reinterpret_cast<float2*>(r0) =
              make_float2(acc[m][c][0], acc[m][c][1]);
          *reinterpret_cast<float2*>(r0 + 8 * ldr) =
              make_float2(acc[m][c][2], acc[m][c][3]);
        }
    }
    team_sync(team);

    // twiddle combine -> power spectrum |X|^2 / N at the listed bins; two
    // frames a thread, t and u = t + par, for independent FMA chains
    if (gk.row < gk.par)
      for (int t = gk.row; t < p.tt; t += 2 * gk.par) {
        const int u = t + gk.par < p.tt ? t + gk.par : t;  // u == t: none
        for (int kb = gk.lane; kb < p.nbins; kb += gk.lanes) {
          float re = 0.f, im = 0.f, re2 = 0.f, im2 = 0.f;
#pragma unroll 5
          for (int j = 0; j < p.J; ++j) {
            const float* r = ares + (t * p.step + j) * ldr + kb;
            const float* r2 = ares + (u * p.step + j) * ldr + kb;
            const float2 w = tw2[j * p.nb + kb];
            re = fmaf(r[0], w.x, fmaf(-r[p.nb], w.y, re));
            im = fmaf(r[0], w.y, fmaf(r[p.nb], w.x, im));
            re2 = fmaf(r2[0], w.x, fmaf(-r2[p.nb], w.y, re2));
            im2 = fmaf(r2[0], w.y, fmaf(r2[p.nb], w.x, im2));
          }
          psb[t * p.nb + kb] = (re * re + im * im) * inv_n;
          if (u > t) psb[u * p.nb + kb] = (re2 * re2 + im2 * im2) * inv_n;
        }
      }
    team_sync(team);

    // mel (sparse, by filter); zero or subnormal -> eps; log for mfcc; two
    // frames a thread as above
    if (gf.row < gf.par)
      for (int t = gf.row; t < p.tt; t += 2 * gf.par) {
        const int u = t + gf.par < p.tt ? t + gf.par : t;
        for (int f = gf.lane; f < p.F; f += gf.lanes) {
          const float* ps = psb + t * p.nb;
          const float* ps2 = psb + u * p.nb;
          float acc = 0.f, acc2 = 0.f;
          for (int z = melptr[f]; z < melptr[f + 1]; ++z) {
            const int k = melbin[z];
            const float w = melw[z];
            acc = fmaf(ps[k], w, acc);
            acc2 = fmaf(ps2[k], w, acc2);
          }
          if (acc < kFltMin) acc = kEpsZero;
          if (acc2 < kFltMin) acc2 = kEpsZero;
          float* o = p.mfcc ? lm : ft;  // fbank: F == D
          o[t * p.F + f] = p.mfcc ? logf(acc) : acc;
          if (u > t) o[u * p.F + f] = p.mfcc ? logf(acc2) : acc2;
        }
      }
    if (p.mfcc)
      for (int t = ttid; t < p.tt; t += kTeamThreads) {
        // sum_k |X_k|^2 / N over all N/2 + 1 bins, from Parseval
        float e = 0.f;
        for (int j = 0; j < p.J; ++j) e += q[t * p.step + j];
        const float* ps = psb + t * p.nb;
        e = 0.5f * e + 0.5f * (ps[p.ksup] + ps[p.ksup + 1]);
        le[t] = logf(e < kFltMin ? kEpsZero : e);
      }
    team_sync(team);

    if (p.mfcc) {  // DCT; c0 = log frame energy; two frames a thread
      if (gd.row < gd.par)
        for (int t = gd.row; t < p.tt; t += 2 * gd.par) {
          const int u = t + gd.par < p.tt ? t + gd.par : t;
          for (int d = gd.lane; d < p.D; d += gd.lanes) {
            float v = le[t], v2 = le[u];
            if (d > 0) {
              const float* l = lm + t * p.F;
              const float* l2 = lm + u * p.F;
              v = v2 = 0.f;
              for (int f = 0; f < p.F; ++f) {
                const float c = dct[f * p.D + d];
                v = fmaf(l[f], c, v);
                v2 = fmaf(l2[f], c, v2);
              }
            }
            ft[t * p.D + d] = v;
            if (u > t) ft[u * p.D + d] = v2;
          }
        }
      team_sync(team);
    }

    const int n_out = min(p.tt, p.T - t0) * p.D;
    float* rw = p.raw + (static_cast<size_t>(b) * p.T + t0) * p.D;
    for (int i = ttid; i < n_out; i += kTeamThreads) rw[i] = ft[i];
    if (p.cmvn) {
      // masked count, mean and M2 of this tile's frames < featlen: one
      // warp per feature, lanes over frames, a fixed shuffle tree
      const int n = clampi(clampi(p.featlen[b], 0, p.T) - t0, 0, p.tt);
      float* st = p.stats +
                  static_cast<size_t>(b * p.n_tiles + tile) * 3 * p.D;
      for (int d = twarp; d < p.D; d += kTeamWarps) {
        float s = 0.f;
        for (int t = lane; t < n; t += 32) s += ft[t * p.D + d];
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        const float mean = n > 0 ? s / static_cast<float>(n) : 0.f;
        float m2 = 0.f;
        for (int t = lane; t < n; t += 32) {
          const float c = ft[t * p.D + d] - mean;
          m2 = fmaf(c, c, m2);
        }
        for (int o = 16; o > 0; o >>= 1)
          m2 += __shfl_xor_sync(0xffffffffu, m2, o);
        if (lane == 0) {
          st[d] = static_cast<float>(n);
          st[p.D + d] = mean;
          st[2 * p.D + d] = m2;
        }
      }
    }
    item = nxt;
  }
}

// Chan et al.'s pairwise update of (count, mean, M2) with another partial
__device__ __forceinline__ void chan_merge(float& n, float& m, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    m = mb;
    m2 = m2b;
    return;
  }
  const float nn = n + nb, delta = mb - m;
  m = fmaf(delta, nb / nn, m);
  m2 = m2 + m2b + delta * delta * (n * nb / nn);
  n = nn;
}

// frames of one pass-2 block: its normalized rows fill kThreads2 values
__host__ __device__ __forceinline__ int frames2(int D) {
  return D < kThreads2 ? kThreads2 / D : 1;
}

// speechpy's feature-axis derivative of row x (D values) at c, edge-padded:
// (x[c+1] - x[c-1] + 2 x[c+2] - x[c-2]) / 10
__device__ __forceinline__ float delta_at(const float* x, int c, int D) {
  return (x[clampi(c + 1, 0, D - 1)] - x[clampi(c - 1, 0, D - 1)] +
          2.f * x[clampi(c + 2, 0, D - 1)] - x[clampi(c - 2, 0, D - 1)]) /
         10.f;
}

// Pass 2: one block per (utterance, kThreads2 / D frames).  Merges the utterance's
// pass-1 partials (population variance over the first featlen frames,
// count floored at 1), normalizes its frames once into shared memory,
// stacks [static, d, dd] on a trailing axis of 3 and zeroes frames
// >= featlen; the block's output is one contiguous run, written coalesced.
__global__ void __launch_bounds__(kThreads2)
cmvn_deltas_kernel(const float* __restrict__ raw,
                   const int* __restrict__ featlen,
                   const float* __restrict__ stats, float* __restrict__ out,
                   int T, int D, int tt1, int n_tiles1) {
  __shared__ float pn[kThreads2], pm[kThreads2], pm2[kThreads2];
  __shared__ float mean[kThreads2], den[kThreads2];
  __shared__ float v[3][kThreads2];  // normalized, d, dd of the frames
  const int b = blockIdx.y, tid = threadIdx.x;
  const int fl = clampi(featlen[b], 0, T);
  const int n_valid = (fl + tt1 - 1) / tt1;
  const int groups = blockDim.x / D, d = tid % D, g = tid / D;
  const float* st = stats + static_cast<size_t>(b) * n_tiles1 * 3 * D;

  // groups merge strided tiles, then thread d merges the groups in order
  float n = 0.f, m = 0.f, m2 = 0.f;
  if (g < groups)
#pragma unroll 4
    for (int i = g; i < n_valid; i += groups) {
      const float* s = st + static_cast<size_t>(i) * 3 * D;
      chan_merge(n, m, m2, s[d], s[D + d], s[2 * D + d]);
    }
  pn[tid] = n;
  pm[tid] = m;
  pm2[tid] = m2;
  __syncthreads();
  if (tid < D) {
    n = m = m2 = 0.f;
    for (int q = 0; q < groups; ++q)
      chan_merge(n, m, m2, pn[q * D + tid], pm[q * D + tid], pm2[q * D + tid]);
    mean[tid] = m;
    den[tid] = sqrtf(m2 / fmaxf(n, 1.f)) + kEpsCmvn;
  }
  __syncthreads();

  const int t0 = blockIdx.x * frames2(D);
  const int n_el = min(frames2(D), T - t0) * D;
  const float* x = raw + (static_cast<size_t>(b) * T + t0) * D;
  for (int i = tid; i < n_el; i += blockDim.x) {
    const int j = i % D;
    v[0][i] = t0 + i / D < fl ? (x[i] - mean[j]) / den[j] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < n_el; i += blockDim.x)
    v[1][i] = delta_at(v[0] + (i - i % D), i % D, D);
  __syncthreads();
  for (int i = tid; i < n_el; i += blockDim.x)
    v[2][i] = delta_at(v[1] + (i - i % D), i % D, D);
  __syncthreads();
  float* o = out + (static_cast<size_t>(b) * T + t0) * D * 3;
  for (int i = tid; i < 3 * n_el; i += blockDim.x) o[i] = v[i % 3][i / 3];
}

}  // namespace

// audio (B, S) f32; featlen (B,) i32; the plan's constants (basis, twiddle,
// melptr, melbin, melw, dct); raw (B, T, D) f32 (the output when cmvn == 0);
// stats (B, n_tiles, 3, D) f32 scratch and out (B, T, D, 3) f32 when
// cmvn != 0.  The wrapper (ops/cuda_frontend.py) validates every shape and
// pointer and picks the tiling and the shared memory (smem bytes).
extern "C" int asr_fused_frontend(
    const float* audio, const int* featlen, const float* basis,
    const float* twiddle, const int* melptr, const int* melbin,
    const float* melw, const float* dct, float* raw, float* stats, float* out,
    int B, int S, int T, int fstride, int nfft, int slen, int slen_pad,
    int sstride, int J, int step, int nbins, int nb, int ksup, int F, int D,
    int nnz, int dct_len, int mfcc, int cmvn, int mt, int tt, int n_tiles,
    int basis_in_smem,
    int smem, int grid, void* stream) {
  if (mt < 1 || mt > kMaxMT || D > kThreads2 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{audio, featlen, basis, twiddle, melptr, melbin, melw, dct,
                 raw,   stats,   B,     S,       T,      fstride, nfft,
                 slen,  slen_pad, sstride, J,    step,   nbins,  nb,
                 ksup,  F,       D,     nnz,     dct_len, mfcc,  cmvn,
                 mt,    tt,      n_tiles, basis_in_smem};
  auto kernel = mt == 1 ? features_kernel<1> : features_kernel<2>;
  // the shared-memory opt-in on every launch: it is per device, and cheap
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads1, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || !cmvn) return static_cast<int>(e);
  const dim3 grid2((T + frames2(D) - 1) / frames2(D), B);
  cmvn_deltas_kernel<<<grid2, kThreads2, 0, st>>>(raw, featlen, stats, out, T,
                                                  D, tt, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
