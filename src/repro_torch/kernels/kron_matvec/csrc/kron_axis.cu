// Per-axis Kronecker factor kernel for Hopper (sm_90a):
//
//     o[l, q, r] = sum_k S[q, k] * x[l, k, r]      S (m, n), x (L, n, R), o (L, m, R)
//
// Replaces the Pallas TPU kernel src/repro/kernels/kron_matvec/kron_matvec.py
// (_kron_axis_kernel, launched by kron_axis_matvec).  The TPU version pads m
// and n to 8 and R to 512 so the MXU sees whole tiles; none of that applies
// here: the kernel masks its own ragged edge and takes any L, n, R, m.
//
// Design: a register-blocked small GEMM.  Each launch is O = S X with
// M = m, K = n and N = L * R "columns" c = l * R + r, read at their strides.
// A block of 128 threads (4 warps) owns a kBM x kBN tile of O; blockIdx.y
// walks the q tiles and blockIdx.x the column tiles.  Each warp owns 32 q by
// 32 columns, its lanes 4 (q) by 8 (columns), and each thread accumulates
// an 8 x 4 micro-tile in registers: 32 independent fmaf chains, so the
// issue rate is set by throughput, not by the latency of one chain.  Per k a
// thread reads its 8 S values and its 4 x values as three 16-byte shared
// loads (the S loads shared by the 8 lanes of a row, the x loads by the 4 of
// a column): 3 loads per 32 FMAs.  The tile's shape follows m
// (axis_geometry): 4 warps along q (128 q by 32 columns) when m > 64, as on
// Adult's widest factors (m = 99), so x is read once and the grid has many
// narrow tiles; 2 x 2 (64 by 64) when 32 < m <= 64; 1 x 4 (32 by 128) for
// m <= 32.  A warp whose q rows all lie past m skips the arithmetic.
//
// k is walked in chunks of kBK = 8: the chunk of S (transposed, As[k][q])
// and of x (Bs[k][column]) are staged in shared memory, with the next
// chunk's global loads issued into registers before the current chunk is
// multiplied.  The result goes through shared memory (Cs[column][q]) so
// that its stores run along memory order: one column a thread along r when
// R > 1, q fastest when R == 1 (where each column's m outputs are
// contiguous).  Loads also follow memory order: along r when R > 1 (each
// thread keeps one column, whose base offset it divides out once a block),
// along k when R == 1.  Shared memory is about 22 KB whatever the factor:
// every (m, n) fits a block, under the 48 KB default, so the kernel needs
// no cudaFuncSetAttribute at all.  Entries past n (the last chunk) and past
// m or the last column are staged as 0.
//
// Bound.  At the shapes the main path gives it (chains whose rows are too
// wide for the fused kernel, e.g. Adult's (100, 100, 100) chain: n = 100,
// m = 99, L * R = 2e4 columns a launch) it does 2*m*n FLOP per column
// against 4*(n + m) bytes, about 25 FLOP/B, above the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s, 20 FLOP/B): it is bound by the fp32 FMA rate,
// 5.9 us a launch there.  That launch gives 625 blocks of 128 q by 32
// columns, about 4.7 a SM.  The padding of m = 99 to 128 costs a fifth of
// the FMAs issued.  Tensor cores (TF32 wgmma) would lift the bound but keep
// about 10 bits, and would break the summation contract below.
//
// Summation order: every output is summed with one fmaf per term, from 0,
// in the order k = 0 .. n-1 (chunk after chunk, k ascending inside each;
// the zeros staged past n add nothing: fmaf(0, 0, acc) == acc, and acc is
// never -0 starting from +0).  fused_chain.cu sums in the same order, so a
// chain run through this kernel axis by axis and the same chain run
// through the fused kernel agree bit for bit.
//
// kron_matvec.py's axis_geometry computes the launch (tile sizes, grid,
// shared memory) and passes it here; the launcher refuses a geometry that
// is not this kernel's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBK = 8;             // k values a chunk
constexpr int kTM = 8;             // q values a thread
constexpr int kTN = 4;             // columns a thread

// The tile of kWQ warps along q (each 32 q) by 4 / kWQ warps along the
// columns (each 32 columns); kron_matvec.py's axis_geometry mirrors it.
template <int kWQ>
struct Tile {
  static constexpr int kWC = 4 / kWQ;
  static constexpr int kBM = 32 * kWQ;
  static constexpr int kBN = 32 * kWC;
  static constexpr int kLdA = kBM + 4;   // As row stride: 16-byte rows
  static constexpr int kLdB = kBN + 4;   // Bs row stride: 16-byte rows
  static constexpr int kLdC = kBM + 1;   // Cs row stride
  static constexpr int kALoads = kBM * kBK / kThreads;   // S values a thread stages
  static constexpr int kBLoads = kBN * kBK / kThreads;   // x values a thread stages
  static constexpr int kSmem = 4 * (kBK * kLdA + kBK * kLdB + kBN * kLdC);
};

template <int kWQ, bool kRowOne>   // kRowOne: R == 1, a column's k values are contiguous
__global__ void __launch_bounds__(kThreads)
kron_axis_kernel(const float* __restrict__ s, const float* __restrict__ x,
                 float* __restrict__ o, long long L, int n, long long R,
                 int m) {
  using G = Tile<kWQ>;
  constexpr int kBM = G::kBM, kBN = G::kBN;
  __shared__ __align__(16) float As[kBK * G::kLdA];   // S chunk, [k][q]
  __shared__ __align__(16) float Bs[kBK * G::kLdB];   // x chunk, [k][column]
  __shared__ float Cs[kBN * G::kLdC];                 // the result, [column][q]
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wq = warp / G::kWC, wc = warp % G::kWC;
  const int tq = wq * 32 + (lane / 8) * kTM;     // the thread's first q
  const int tcol = wc * 32 + (lane % 8) * kTN;   // the thread's first column
  const long long cols = L * R;
  const long long c0 = static_cast<long long>(blockIdx.x) * kBN;
  const int q0 = blockIdx.y * kBM;
  const bool live = q0 + wq * 32 < m;   // warp-uniform

  // Staging map.  S: slot i = tid + t * 128 of the (kBM, kBK) chunk is
  // q = i / kBK, kk = i % kBK (k fastest: contiguous reads of S's rows).
  // x, R > 1: j = tid % kBN is fixed, kk = tid / kBN + t * (128 / kBN)
  // (r fastest); x, R == 1: kk = tid % kBK, j = tid / kBK + 16 t (k fastest).
  const int a_kk = tid % kBK;
  const int a_q = tid / kBK;
  long long b_base = 0;     // R > 1: x offset of this thread's column at k = 0
  bool b_col = true;
  if (!kRowOne) {
    const long long c = c0 + tid % kBN;
    b_col = c < cols;
    if (b_col) {
      const long long l = c / R;
      b_base = l * n * R + (c - l * R);
    }
  }
  float ra[G::kALoads], rb[G::kBLoads];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int t = 0; t < G::kALoads; ++t) {
      const int q = q0 + a_q + t * (kThreads / kBK);
      const int k = k0 + a_kk;
      ra[t] = (q < m && k < n) ? s[q * n + k] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < G::kBLoads; ++t) {
      if constexpr (kRowOne) {
        const long long c = c0 + tid / kBK + t * (kThreads / kBK);
        const int k = k0 + tid % kBK;
        rb[t] = (c < cols && k < n) ? x[c * n + k] : 0.f;
      } else {
        const int k = k0 + tid / kBN + t * (kThreads / kBN);
        rb[t] = (b_col && k < n) ? x[b_base + static_cast<long long>(k) * R]
                                 : 0.f;
      }
    }
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int t = 0; t < G::kALoads; ++t)
      As[a_kk * G::kLdA + a_q + t * (kThreads / kBK)] = ra[t];
#pragma unroll
    for (int t = 0; t < G::kBLoads; ++t) {
      if constexpr (kRowOne)
        Bs[(tid % kBK) * G::kLdB + tid / kBK + t * (kThreads / kBK)] = rb[t];
      else
        Bs[(tid / kBN + t * (kThreads / kBN)) * G::kLdB + tid % kBN] = rb[t];
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load_chunk(0);
  for (int k0 = 0; k0 < n; k0 += kBK) {
    store_chunk();
    __syncthreads();
    if (k0 + kBK < n) load_chunk(k0 + kBK);   // in flight during the FMAs
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&As[kk * G::kLdA + tq]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk * G::kLdA + tq + 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Bs[kk * G::kLdB + tcol]);
        const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Through shared memory, so that the stores run along memory order.
  if (live) {
#pragma unroll
    for (int j = 0; j < kTN; ++j)
#pragma unroll
      for (int i = 0; i < kTM; ++i) Cs[(tcol + j) * G::kLdC + tq + i] = acc[i][j];
  }
  __syncthreads();
  const int qn = m - q0 < kBM ? m - q0 : kBM;
  if constexpr (kRowOne) {
    // A column's q values are contiguous in o: q fastest.
    for (int idx = tid; idx < kBN * kBM; idx += kThreads) {
      const int col = idx / kBM, q = idx % kBM;
      const long long c = c0 + col;
      if (c < cols && q < qn) o[c * m + q0 + q] = Cs[col * G::kLdC + q];
    }
  } else {
    // Neighbouring columns are neighbouring r: one column a thread.
    const int col = tid % kBN;
    const long long c = c0 + col;
    if (c < cols) {
      const long long l = c / R;
      float* out = o + (l * m + q0) * R + (c - l * R);
      for (int q = tid / kBN; q < qn; q += kThreads / kBN)
        out[static_cast<long long>(q) * R] = Cs[col * G::kLdC + q];
    }
  }
}

template <int kWQ>
int launch(const float* s, const float* x, float* o, long long L, int n,
           long long R, int m, int bn, int bk, int grid_q, long long grid_c,
           int smem, cudaStream_t st) {
  using G = Tile<kWQ>;
  const long long cols = L * R;
  if (bn != G::kBN || bk != kBK || smem != G::kSmem ||
      grid_q != (m + G::kBM - 1) / G::kBM || grid_q > 65535 ||
      grid_c != (cols + G::kBN - 1) / G::kBN || grid_c > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(grid_c),
                  static_cast<unsigned int>(grid_q));
  if (R == 1)
    kron_axis_kernel<kWQ, true><<<grid, kThreads, 0, st>>>(s, x, o, L, n, R, m);
  else
    kron_axis_kernel<kWQ, false><<<grid, kThreads, 0, st>>>(s, x, o, L, n, R, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bm, bn, bk, grid_q, grid_c, smem: the launch as kron_matvec.py's
// axis_geometry computes it (bm 32, 64 or 128 chooses the tile); refused
// (cudaErrorInvalidValue) unless it is one of this kernel's.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int kron_axis_launch(const float* s, const float* x, float* o, long long L,
                     int n, long long R, int m, int bm, int bn, int bk,
                     int grid_q, long long grid_c, int smem, void* stream) {
  if (L * R <= 0 || m <= 0) return 0;
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 32:
      return launch<1>(s, x, o, L, n, R, m, bn, bk, grid_q, grid_c, smem, st);
    case 64:
      return launch<2>(s, x, o, L, n, R, m, bn, bk, grid_q, grid_c, smem, st);
    case 128:
      return launch<4>(s, x, o, L, n, R, m, bn, bk, grid_q, grid_c, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
