// The float32 BiLSTM recurrence of the listener, for Hopper (sm_90a): a
// forward kernel and a backward kernel, one persistent cooperative launch a
// direction each, in clusters of two CTAs (ops/lstm.py wraps them in one
// autograd.Function).
//
// It replaces no Pallas kernel: the JAX package has no LSTM listener, and
// its conversions refuse rnn_cell 'lstm'.  It replaces cuDNN's float32 LSTM,
// which at 1280 units falls back to one sgemm a time step a direction for
// h W_hh^T (and for dgates W_hh in the backward) at 48 or 96 rows: tiles
// that waste a quarter of M, 80 CTAs on 132 SMs, and W_hh (26.2 MB a
// direction) read again from L2 every step.
//
// The function is nn.LSTM's, unpacked: gates i, f, g, o; c' = s(f) c +
// s(i) tanh(g); h' = s(o) tanh(c'); zero initial states; the reverse
// direction runs over the whole padded sequence reversed.  The input
// projection x W_ih^T + b, the input gradient and the weight gradients are
// plain large products outside (torch.matmul).  Every product here is
// float32 FFMA on the CUDA cores: no TF32, no 3xTF32.
//
// What bounds it: FFMA, 67 TFLOP/s, while W_hh stays on chip; else the L2
// bytes of re-reading it (26.2 MB a direction a step), and then the bytes
// of the step's operand that every SM must take in from L2.  The design:
// - Every CTA keeps 80 rows x half the k of W_hh (or of its transpose),
//   206 KB with padding, in shared memory for the whole sequence: 128 CTAs
//   hold a direction's W_hh at 1280 units, and no step reads it again.
// - Forward step: a cluster of two CTAs owns 20 hidden units and the 80
//   rows of their four gates, each CTA half of k.  Each reads its half of
//   h_{t-1} (48 rows x U / 2, 123 KB: the output's rows of the previous
//   step, written before the step's barrier) from L2 through cp.async
//   stages and computes its 48 x 80 partial gate block (threads: 6 rows
//   x 5 gate rows each, two k-groups summed in a fixed order); the halves meet
//   through distributed shared memory, rank 0's first; each CTA then runs
//   the gate math and the cell update of 10 of the units (a unit's four
//   gates are local to the cluster), writing h_t, c_t and the activated
//   gates.  One grid barrier a step.
// - Backward step: CTA c runs the cell's gradient for units 10c .. 10c + 9
//   (dh from dy and the four gates' dh of the step before; dgates out, dc
//   kept); a grid barrier; then a cluster multiplies one gate's dgates
//   (48 rows x U, each CTA half of it) by 80 columns of that gate's W_hh
//   rows, the same product as the forward's, into dh of 80 units by gate;
//   a grid barrier.
// Every sum runs in a fixed order: the kernels are deterministic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 10;               // hidden units of a CTA's cell update
constexpr int kPair = 2;                 // CTAs of a cluster: the halves of k
constexpr int kCols = 4 * kUnits * kPair;   // 80 rows of W_hh a CTA keeps
constexpr int kThreads = 256;
constexpr int kTile = 48;                // rows of a tile: the product's M
constexpr int kKC = 32;                  // k of an operand stage
constexpr int kStage = kTile * kKC;      // floats of an operand stage
constexpr int kStages = 4;               // operand stages in flight

// k of a CTA's half: ceil(U / 2) rounded up to a float4.
__host__ __device__ inline int half_k(int U) {
  return ((U + 1) / 2 + 3) / 4 * 4;
}

// Row stride of the W_hh rows in shared memory: the k the operand stages
// reach, padded to 4 mod 32 so that neighbouring rows fall in other banks.
__host__ __device__ inline int wstride(int U) {
  return (half_k(U) + 63) / 64 * 64 + 4;
}

// CTAs of a forward launch: a cluster for every 20 units.
__host__ __device__ inline int forward_grid(int U) {
  return kPair * ((U + kPair * kUnits - 1) / (kPair * kUnits));
}

// CTAs of a backward launch: the cell gradient's (10 units a CTA, an even
// count), or a cluster for each gate and block of 80 columns.
__host__ __device__ inline int backward_grid(int U) {
  int cells = forward_grid(U);
  int product = 4 * kPair * ((U + kCols - 1) / kCols);
  return product > cells ? product : cells;
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;                // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// All CTAs of the (co-resident, cooperative) grid meet; `target` is the
// count of arrivals the barrier waits for: (its index + 1) x gridDim.x.
__device__ __forceinline__ void grid_sync(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// The CTA's 48 x 80 block of a product: rows r0 .. r0 + 47 of the operand
// (row r at src + r * ld, K floats, 16-byte aligned; rows past B and
// columns past K read as zero) times the 80 rows of ws (k contiguous).  The
// operand streams from L2 through kStages cp.async stages; each thread
// sums 6 rows x 5 columns over its k-group's half of a stage, and the two
// k-groups' sums meet in a fixed order.  On return stage[m * 80 + n] holds
// the block (all threads synchronised).
__device__ __forceinline__ void tile_product(const float* src, size_t ld,
                                             int B, int r0, int K,
                                             const float* ws, int WS,
                                             float* stage) {
  constexpr int KQ = kKC / 2 / 4;             // float4 columns of a group
  const int tid = threadIdx.x;
  const int g = tid / 128;                    // k-group
  const int lane = tid % 128;
  const int mlane = (lane / 32) * 2 + (lane % 32) / 16;   // rows mlane + 8i
  const int nlane = lane % 16;                // columns nlane + 16j
  const int NQ = (K + kKC - 1) / kKC;
  float acc[6][5];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) acc[i][j] = 0.f;
  auto fetch = [&](int q) {
    if (q < NQ) {
      float* dst = stage + (q % kStages) * kStage;
      for (int idx = tid; idx < kStage / 4; idx += kThreads) {
        int m = idx / (kKC / 4), c4 = idx % (kKC / 4), k = q * kKC + 4 * c4;
        bool ok = r0 + m < B && k < K;
        const float* from = ok ? src + (size_t)(r0 + m) * ld + k : src;
        cp_async16(dst + m * kKC + 4 * (c4 ^ (m & 3)), from, ok);
      }
    }
    cp_async_commit();                        // empty groups keep the count
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) fetch(q);
  for (int q = 0; q < NQ; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                          // stage q is in; q - 1 is done
    fetch(q + kStages - 1);
    const float* hs = stage + (q % kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int c4 = g * KQ + kk;
      float4 a[6], b[5];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        int m = mlane + 8 * i;
        a[i] = *reinterpret_cast<const float4*>(hs + m * kKC +
                                                4 * (c4 ^ (m & 3)));
      }
#pragma unroll
      for (int j = 0; j < 5; ++j)
        b[j] = *reinterpret_cast<const float4*>(ws + (nlane + 16 * j) * WS +
                                                q * kKC + 4 * c4);
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          float v = acc[i][j];
          v = fmaf(a[i].x, b[j].x, v);
          v = fmaf(a[i].y, b[j].y, v);
          v = fmaf(a[i].z, b[j].z, v);
          v = fmaf(a[i].w, b[j].w, v);
          acc[i][j] = v;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // k-group 1 writes its sums at the stages' place, group 0 adds its own
  if (g == 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j)
        stage[(mlane + 8 * i) * kCols + nlane + 16 * j] = acc[i][j];
  }
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        int at = (mlane + 8 * i) * kCols + nlane + 16 * j;
        stage[at] = acc[i][j] + stage[at];
      }
  }
  __syncthreads();
}

// gates (B, T, 8U): x W_ih^T + b on entry, the activated gates i, f, g, o
// on exit, direction-major; cells, out (B, T, 2U): c_t and h_t, whose row
// of the previous step is the step's operand h_{t-1}.
// Cluster p owns units 20p .. 20p + 19 (row g * 20 + j of ws: gate g of
// unit 20p + j), its CTA of rank r half r of k and the cell update of
// units 20p + 10r .. + 9.
__global__ void __launch_bounds__(kThreads, 1)
    lstm_forward_kernel(const float* __restrict__ w_hh, float* gates,
                        float* cells, float* out, unsigned* counter, int B,
                        int T, int U, int dir) {
  constexpr int ITEMS = (kTile * kUnits + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int WS = wstride(U);
  const int kb = rank * half_k(U);            // this CTA's k: kb .. kb + kn
  const int kn = min(U, kb + half_k(U)) - kb;
  float* ws = smem;
  float* stage = smem + kCols * WS;
  const float* peer = cluster.map_shared_rank(stage, rank ^ 1);
  const float* p0 = rank == 0 ? stage : peer;     // the halves, in order
  const float* p1 = rank == 0 ? peer : stage;
  const int tid = threadIdx.x;
  const int ub = (blockIdx.x / kPair) * kPair * kUnits;   // cluster's units
  const int u0 = blockIdx.x * kUnits;                     // cell update's
  const int cols = WS / 4;
  for (int idx = tid; idx < kCols * cols; idx += kThreads) {
    int n = idx / cols, k = 4 * (idx % cols);
    int u = ub + n % (kPair * kUnits), gi = n / (kPair * kUnits);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < U && k < kn)
      v = *reinterpret_cast<const float4*>(
          w_hh + (size_t)(gi * U + u) * U + kb + k);
    *reinterpret_cast<float4*>(ws + n * WS + k) = v;
  }
  __syncthreads();

  const int tiles = (B + kTile - 1) / kTile;
  const size_t G8 = 8 * (size_t)U, H2 = 2 * (size_t)U;
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const int tp = dir == 0 ? t - 1 : t + 1;  // the previous step
    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile;
      // this thread's cells: their gate inputs and c_prev, ahead of the
      // product so that their loads overlap it
      float xg[ITEMS][4], cp[ITEMS];
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        int e = tid + q * kThreads, m = e / kUnits, u = u0 + e % kUnits;
        bool ok = e < kTile * kUnits && r0 + m < B && u < U;
        size_t row = (size_t)(r0 + m) * T + t;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          xg[q][gi] = ok ? gates[row * G8 + dir * 4 * U + gi * U + u] : 0.f;
        cp[q] = ok && s > 0
                    ? cells[((size_t)(r0 + m) * T + tp) * H2 + dir * U + u]
                    : 0.f;
      }
      if (s > 0) {
        tile_product(out + (size_t)tp * H2 + dir * U + kb, T * H2, B, r0,
                     kn, ws, WS, stage);
        cluster.sync();                       // both halves are in
      }
      // the gates and the cell update of this thread's cells
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        int e = tid + q * kThreads, m = e / kUnits, j = e % kUnits;
        int u = u0 + j;
        if (e >= kTile * kUnits || r0 + m >= B || u >= U) continue;
        float pre[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          int at = m * kCols + gi * kPair * kUnits + rank * kUnits + j;
          pre[gi] = s > 0 ? xg[q][gi] + (p0[at] + p1[at]) : xg[q][gi];
        }
        float ig = sigm(pre[0]), fg = sigm(pre[1]), gg = tanhf(pre[2]),
              og = sigm(pre[3]);
        float c = fg * cp[q] + ig * gg;
        float h = og * tanhf(c);
        size_t row = (size_t)(r0 + m) * T + t;
        float* gr = gates + row * G8 + dir * 4 * U + u;
        gr[0] = ig;
        gr[U] = fg;
        gr[2 * U] = gg;
        gr[3 * U] = og;
        cells[row * H2 + dir * U + u] = c;
        out[row * H2 + dir * U + u] = h;
      }
      if (s > 0) cluster.sync();              // the peer has read ours
      __syncthreads();                        // the next tile refills
    }
    if (s + 1 < T) grid_sync(counter, (unsigned)(s + 1) * gridDim.x);
  }
}

// dgates (B, T, 8U): the gradient of the gates' pre-activations; dout
// (B, T, 2U) the output's; part (4, Bp, U): dh_{t-1} by gate, before the
// sum over gates; dcell (B, U): dc carried between steps.  Two roles a
// CTA: the cell gradient of units 10c .. 10c + 9 (as the forward), and, in
// cluster (gate, block), half r of the product of that gate's dgates with
// its W_hh rows' columns 80 block .. + 79, whose rows of W_hh^T (half r of
// their k) it keeps in shared memory.
__global__ void __launch_bounds__(kThreads, 1)
    lstm_backward_kernel(const float* __restrict__ w_hh,
                         const float* __restrict__ gates,
                         const float* __restrict__ cells,
                         const float* __restrict__ dout, float* dgates,
                         float* part, float* dcell, unsigned* counter, int B,
                         int T, int U, int dir) {
  constexpr int ITEMS = (kTile * kUnits + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int WS = wstride(U);
  const int kb = rank * half_k(U);
  const int kn = min(U, kb + half_k(U)) - kb;
  float* ws = smem;
  float* stage = smem + kCols * WS;
  const float* peer = cluster.map_shared_rank(stage, rank ^ 1);
  const float* p0 = rank == 0 ? stage : peer;
  const float* p1 = rank == 0 ? peer : stage;
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kUnits;
  const int NB = (U + kCols - 1) / kCols;     // column blocks a gate
  const int job = blockIdx.x / kPair;
  const int gate = job / NB, c0 = kCols * (job % NB);
  const bool product = gate < 4;
  // row kl, column k: W_hh[gate * U + kb + k][c0 + kl]
  if (product) {
    for (int idx = tid; idx < kCols * WS; idx += kThreads) {
      int k = idx / kCols, kl = idx % kCols;
      float v = 0.f;
      if (k < kn && c0 + kl < U)
        v = w_hh[(size_t)(gate * U + kb + k) * U + c0 + kl];
      ws[kl * WS + k] = v;
    }
  }
  __syncthreads();

  const int tiles = (B + kTile - 1) / kTile;
  const int Bp = tiles * kTile;
  const size_t G8 = 8 * (size_t)U, H2 = 2 * (size_t)U;
  const size_t PG = (size_t)Bp * U;            // one gate's part
  unsigned syncs = 0;
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? T - 1 - s : s;
    const int tp = dir == 0 ? t - 1 : t + 1;  // the forward's previous step
    const bool has_prev = tp >= 0 && tp < T;
    // the cell gradient of this CTA's units
    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile;
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        int e = tid + q * kThreads, m = e / kUnits, u = u0 + e % kUnits;
        int r = r0 + m;
        if (e >= kTile * kUnits || r >= B || u >= U) continue;
        size_t row = (size_t)r * T + t;
        const float* gr = gates + row * G8 + dir * 4 * U + u;
        float ig = gr[0], fg = gr[U], gg = gr[2 * U], og = gr[3 * U];
        float c = cells[row * H2 + dir * U + u];
        float c_prev =
            has_prev ? cells[((size_t)r * T + tp) * H2 + dir * U + u] : 0.f;
        float dh = dout[row * H2 + dir * U + u];
        float dc = 0.f;
        if (s > 0) {
          const float* pr = part + (size_t)r * U + u;
          float rec = __ldcg(pr);
#pragma unroll
          for (int gi = 1; gi < 4; ++gi) rec += __ldcg(pr + gi * PG);
          dh += rec;
          dc = dcell[(size_t)r * U + u];
        }
        float tc = tanhf(c);
        float dct = dc + dh * og * (1.f - tc * tc);
        float* dr = dgates + row * G8 + dir * 4 * U + u;
        dr[0] = dct * gg * ig * (1.f - ig);
        dr[U] = dct * c_prev * fg * (1.f - fg);
        dr[2 * U] = dct * ig * (1.f - gg * gg);
        dr[3 * U] = dh * tc * og * (1.f - og);
        dcell[(size_t)r * U + u] = dct * fg;
      }
    }
    if (s + 1 == T) break;
    grid_sync(counter, ++syncs * gridDim.x);
    // dh of the step before, by gate: this step's dgates of one gate times
    // 80 columns of its W_hh rows, the two halves of k summed in order
    if (product) {
      for (int tile = 0; tile < tiles; ++tile) {
        const int r0 = tile * kTile;
        tile_product(dgates + (size_t)t * G8 + dir * 4 * U + gate * U + kb,
                     T * G8, B, r0, kn, ws, WS, stage);
        cluster.sync();                       // both halves are in
        for (int idx = tid; idx < kTile * kCols / kPair; idx += kThreads) {
          int m = idx / (kCols / kPair);
          int kl = rank * (kCols / kPair) + idx % (kCols / kPair);
          int at = m * kCols + kl;
          if (c0 + kl < U)
            part[gate * PG + (size_t)(r0 + m) * U + c0 + kl] =
                p0[at] + p1[at];
        }
        cluster.sync();                       // the peer has read ours
      }
    }
    grid_sync(counter, ++syncs * gridDim.x);
  }
}

// Shared memory of a CTA, either kernel: the 80 rows of W_hh (or of its
// transpose), then the operand stages.
size_t smem_bytes(int U) {
  return (size_t)(kCols * wstride(U) + kStages * kStage) * sizeof(float);
}

template <typename F>
int launch(F* fn, int grid, int U, void** args, cudaStream_t stream) {
  size_t smem = smem_bytes(U);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kPair;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = 2;
  return (int)cudaLaunchKernelExC(&config, (const void*)fn, args);
}

}  // namespace

extern "C" {

// CTAs the larger of the two launches takes at U units; all must be
// co-resident.
int asr_lstm_ctas(int U) { return backward_grid(U); }

// Floats of the backward's partial buffer: dh by gate, 4 x Bp x U.
long long asr_lstm_partial_floats(int B, int U) {
  return 4 * (long long)((B + kTile - 1) / kTile * kTile) * U;
}

// One direction's forward: w_hh (4U, U); gates (B, T, 8U) holding
// x W_ih^T + b, overwritten with the activated gates; cells, out
// (B, T, 2U); counter: one zeroed unsigned.  Returns the cudaError_t of
// the launch.
int asr_lstm_forward(const float* w_hh, float* gates, float* cells,
                     float* out, unsigned* counter, int B, int T, int U,
                     int dir, cudaStream_t stream) {
  void* args[] = {&w_hh, &gates, &cells, &out, &counter, &B, &T, &U, &dir};
  return launch(lstm_forward_kernel, forward_grid(U), U, args, stream);
}

// One direction's backward: w_hh (4U, U); gates, cells the forward's;
// dout (B, T, 2U); dgates (B, T, 8U) out; part (asr_lstm_partial_floats)
// and dcell (B, U) scratch; counter: one zeroed unsigned.  Returns the
// cudaError_t of the launch.
int asr_lstm_backward(const float* w_hh, const float* gates,
                      const float* cells, const float* dout, float* dgates,
                      float* part, float* dcell, unsigned* counter, int B,
                      int T, int U, int dir, cudaStream_t stream) {
  void* args[] = {&w_hh, &gates, &cells,   &dout, &dgates, &part,
                  &dcell, &counter, &B, &T, &U, &dir};
  return launch(lstm_backward_kernel, backward_grid(U), U, args, stream);
}

}  // extern "C"
