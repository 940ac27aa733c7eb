// Fused acoustic frontend for Hopper (sm_90a): raw padded 16 kHz audio ->
// power spectrum -> mel -> log/DCT (mfcc) or mel energies (fbank) ->
// masked per-utterance CMVN -> feature-axis delta stacking.
//
// Replaces the TPU kernel automatic_speech_recognition_tpu/ops/
// pallas_frontend.py:_fused_kernel, launched there by fused_frontend and,
// past 1710 frames, by fused_frontend_chunked.  The TPU kernel keeps a
// whole utterance in 16 MB of VMEM; an SM has 227 KB of shared memory, so
// this kernel tiles frames and needs no length limit (no chunked variant).
//
// What bounds it on the H100: the DFT.  Per frame it costs
// nbins * flen * 2 FMAs (125 * 400 * 2 = 100k at 16 kHz) against 640 new
// bytes of audio read and 156 bytes of features written, so it is bound by
// FP32 issue and shared-memory loads, never by HBM.  The design:
//   - mel-support pruning: only the bins the filterbank touches (plus bins
//     0 and N/2 for the Parseval frame energy) are computed, ~125 of 257;
//   - one thread per bin, kTileT frames per thread in registers: one
//     twiddle lookup feeds kTileT frames, and each audio sample load is a
//     warp-wide broadcast from shared memory;
//   - exact twiddles from an N-entry table indexed by (n * k) mod N, so
//     the constants are 4 KB and match the plain path's DFT matrix;
//   - FP32 FMA throughout (tolerance rtol 1e-4 / atol 2e-4 vs the plain
//     path; no TF32, no bf16 splits).
// Pass 2 (CMVN + deltas) needs whole-utterance statistics: one block per
// utterance, a bandwidth-trivial pass over the (T, D) raw features.
//
// C interface, loaded with ctypes (ops/_kernels.py); returns the
// cudaError_t of the launches, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kTileT = 16;      // frames per pass-1 block
constexpr int kThreads1 = 128;  // pass-1 block size (one DFT bin per thread)
constexpr int kThreads2 = 256;  // pass-2 block size; feat_dim <= kThreads2
constexpr float kEpsZero = 2.220446049250313e-16f;  // float64 eps (speechpy)
constexpr float kEpsCmvn = 9.313225746154785e-10f;  // 2^-30

// Pass 1: raw features (B, T, D) for a tile of kTileT frames of one
// utterance.  bins = [lo..hi] mel-support bins (ksup of them), then 0 and
// N/2.  twiddle = (cos, sin)(2 pi m / N), m < N.  mel = (ksup, F) rows
// lo..hi of the filterbank.  dct = (F, D) (mfcc only).
__global__ void __launch_bounds__(kThreads1)
features_kernel(const float* __restrict__ audio, const int* __restrict__ bins,
                const float2* __restrict__ twiddle,
                const float* __restrict__ mel, const float* __restrict__ dct,
                float* __restrict__ raw, int S, int T, int flen, int fstride,
                int nfft, int nbins, int ksup, int F, int D, int mfcc) {
  extern __shared__ float smem[];
  const int win_len = (kTileT - 1) * fstride + flen;
  float2* tw = reinterpret_cast<float2*>(smem);  // nfft
  float* win = smem + 2 * nfft;                  // win_len
  float* ps = win + win_len;                     // kTileT * nbins
  float* logmel = ps + kTileT * nbins;           // kTileT * F
  float* energy = logmel + kTileT * F;           // kTileT

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileT;
  const int tid = threadIdx.x;
  const float* x = audio + static_cast<size_t>(b) * S;
  const long long start = static_cast<long long>(t0) * fstride;

  // audio window; the gather clamps at S - 1 like the plain frame_signal
  for (int i = tid; i < win_len; i += blockDim.x) {
    const long long s = start + i;
    win[i] = x[s < S ? s : S - 1];
  }
  for (int i = tid; i < nfft; i += blockDim.x) tw[i] = twiddle[i];
  __syncthreads();

  // sum of x^2 per frame (Parseval energy): one warp per frame
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  for (int t = warp; t < kTileT; t += nwarps) {
    const float* f = win + t * fstride;
    float q = 0.f;
    for (int n = lane; n < flen; n += 32) q = fmaf(f[n], f[n], q);
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    if (lane == 0) energy[t] = q;
  }

  // DFT at the listed bins: one thread per bin, kTileT frames in registers
  const int mask = nfft - 1;
  const float inv_n = 1.f / static_cast<float>(nfft);
  for (int kb = tid; kb < nbins; kb += blockDim.x) {
    const int k = bins[kb];
    float re[kTileT], im[kTileT];
#pragma unroll
    for (int t = 0; t < kTileT; ++t) {
      re[t] = 0.f;
      im[t] = 0.f;
    }
    int idx = 0;  // (n * k) mod nfft
#pragma unroll 4
    for (int n = 0; n < flen; ++n) {
      const float2 w = tw[idx];
      idx = (idx + k) & mask;
#pragma unroll
      for (int t = 0; t < kTileT; ++t) {
        const float v = win[t * fstride + n];
        re[t] = fmaf(v, w.x, re[t]);
        im[t] = fmaf(v, w.y, im[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTileT; ++t)
      ps[t * nbins + kb] = (re[t] * re[t] + im[t] * im[t]) * inv_n;
  }
  __syncthreads();

  // mel filterbank; zero -> eps; log for mfcc, written out for fbank
  for (int i = tid; i < kTileT * F; i += blockDim.x) {
    const int t = i / F, f = i % F;
    const float* p = ps + t * nbins;
    float acc = 0.f;
    for (int kb = 0; kb < ksup; ++kb) acc = fmaf(p[kb], mel[kb * F + f], acc);
    if (acc == 0.f) acc = kEpsZero;
    if (mfcc) {
      logmel[i] = logf(acc);
    } else if (t0 + t < T) {
      raw[(static_cast<size_t>(b) * T + t0 + t) * D + f] = acc;
    }
  }
  if (!mfcc) return;  // uniform across the block
  if (tid < kTileT) {
    // sum_k |X_k|^2 / N over all N/2 + 1 bins, from Parseval
    const float* p = ps + tid * nbins;
    float e = 0.5f * energy[tid] + 0.5f * (p[ksup] + p[ksup + 1]);
    energy[tid] = logf(e == 0.f ? kEpsZero : e);
  }
  __syncthreads();

  // DCT; c0 = log frame energy
  for (int i = tid; i < kTileT * D; i += blockDim.x) {
    const int t = i / D, d = i % D;
    if (t0 + t >= T) continue;
    float v;
    if (d == 0) {
      v = energy[t];
    } else {
      const float* lm = logmel + t * F;
      v = 0.f;
      for (int f = 0; f < F; ++f) v = fmaf(lm[f], dct[f * D + d], v);
    }
    raw[(static_cast<size_t>(b) * T + t0 + t) * D + d] = v;
  }
}

__device__ __forceinline__ int clampi(int c, int hi) {
  return c < 0 ? 0 : (c > hi ? hi : c);
}

// CMVN-normalized feature c of one frame (c clamped: edge padding)
__device__ __forceinline__ float norm_at(const float* row, const float* mean,
                                         const float* den, int c, int D) {
  c = clampi(c, D - 1);
  return (row[c] - mean[c]) / den[c];
}

// speechpy feature-axis derivative of the normalized row at clamped c
__device__ __forceinline__ float delta1_at(const float* row, const float* mean,
                                           const float* den, int c, int D) {
  c = clampi(c, D - 1);
  return (norm_at(row, mean, den, c + 1, D) - norm_at(row, mean, den, c - 1, D) +
          2.f * norm_at(row, mean, den, c + 2, D) -
          norm_at(row, mean, den, c - 2, D)) / 10.f;
}

// Pass 2: one block per utterance.  Masked population mean/variance over
// the first featlen frames (count floored at 1), normalize, stack
// [static, d, dd] on a trailing axis of 3, zero frames >= featlen.
__global__ void __launch_bounds__(kThreads2)
cmvn_deltas_kernel(const float* __restrict__ raw,
                   const int* __restrict__ featlen, float* __restrict__ out,
                   int T, int D) {
  __shared__ float part[kThreads2];
  __shared__ float mean[kThreads2];
  __shared__ float den[kThreads2];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int fl = featlen[b];
  const float n = static_cast<float>(fl > 1 ? fl : 1);
  const int rows = blockDim.x / D;
  const int d = tid % D, r = tid / D;
  const float* x = raw + static_cast<size_t>(b) * T * D;

  float s = 0.f;
  if (r < rows)
    for (int t = r; t < fl; t += rows) s += x[static_cast<size_t>(t) * D + d];
  part[tid] = s;
  __syncthreads();
  if (tid < D) {
    float m = 0.f;
    for (int q = 0; q < rows; ++q) m += part[q * D + tid];
    mean[tid] = m / n;
  }
  __syncthreads();
  s = 0.f;
  if (r < rows)
    for (int t = r; t < fl; t += rows) {
      const float c = x[static_cast<size_t>(t) * D + d] - mean[d];
      s = fmaf(c, c, s);
    }
  part[tid] = s;
  __syncthreads();
  if (tid < D) {
    float v = 0.f;
    for (int q = 0; q < rows; ++q) v += part[q * D + tid];
    den[tid] = sqrtf(v / n) + kEpsCmvn;
  }
  __syncthreads();

  float* o = out + static_cast<size_t>(b) * T * D * 3;
  for (int i = tid; i < T * D; i += blockDim.x) {
    const int t = i / D, j = i % D;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if (t < fl) {
      const float* row = x + static_cast<size_t>(t) * D;
      v0 = norm_at(row, mean, den, j, D);
      v1 = delta1_at(row, mean, den, j, D);
      v2 = (delta1_at(row, mean, den, j + 1, D) -
            delta1_at(row, mean, den, j - 1, D) +
            2.f * delta1_at(row, mean, den, j + 2, D) -
            delta1_at(row, mean, den, j - 2, D)) / 10.f;
    }
    o[static_cast<size_t>(i) * 3 + 0] = v0;
    o[static_cast<size_t>(i) * 3 + 1] = v1;
    o[static_cast<size_t>(i) * 3 + 2] = v2;
  }
}

}  // namespace

// audio (B, S) f32; featlen (B,) i32; raw (B, T, D) f32 scratch (the output
// when cmvn == 0); out (B, T, D, 3) f32 when cmvn != 0.  The wrapper
// (ops/cuda_frontend.py) validates every shape and pointer.
extern "C" int asr_fused_frontend(const float* audio, const int* featlen,
                                  const int* bins, const float* twiddle,
                                  const float* mel, const float* dct,
                                  float* raw, float* out, int B, int S, int T,
                                  int flen, int fstride, int nfft, int nbins,
                                  int ksup, int F, int D, int mfcc, int cmvn,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int win_len = (kTileT - 1) * fstride + flen;
  const size_t smem =
      sizeof(float) * (2 * nfft + win_len + kTileT * (nbins + F + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid1((T + kTileT - 1) / kTileT, B);
  features_kernel<<<grid1, kThreads1, smem, st>>>(
      audio, bins, reinterpret_cast<const float2*>(twiddle), mel, dct, raw, S,
      T, flen, fstride, nfft, nbins, ksup, F, D, mfcc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !cmvn) return static_cast<int>(e);
  cmvn_deltas_kernel<<<B, kThreads2, 0, st>>>(raw, featlen, out, T, D);
  return static_cast<int>(cudaGetLastError());
}
