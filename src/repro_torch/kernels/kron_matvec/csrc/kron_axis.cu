// Per-axis Kronecker factor kernel for Hopper (sm_90a):
//
//     o[l, q, r] = sum_k S[q, k] * x[l, k, r]      S (m, n), x (L, n, R), o (L, m, R)
//
// Replaces the Pallas TPU kernel src/repro/kernels/kron_matvec/kron_matvec.py
// (_kron_axis_kernel, launched by kron_axis_matvec).  The TPU version pads m
// and n to 8 and R to 512 so the MXU sees whole tiles; none of that applies
// here: the kernel masks its own ragged edge and takes any L, n, R, m.
//
// Design.  The (l, r) pairs are the "columns" of the problem, ordered r
// fastest.  A block owns `tile` consecutive columns.  It copies S into shared
// memory, stages the block's slab x[l, :, r] (n x tile) into shared memory,
// then every thread computes outputs (q, column) with an FMA loop over k.
// Loads walk memory order: r fastest when R > 1 (neighbouring threads read
// neighbouring r), and k fastest when R == 1 (the slab is then one
// contiguous run of tile * n floats).  The slab's row stride is tile + 1 so
// the k-fastest store does not hit one shared-memory bank 32 times.
//
// Bound.  At the shapes the main path gives it (chains whose rows are too
// wide for the fused kernel, e.g. Adult's (100, 100, 100) chain: n = 100,
// m = 99) it does 2*m*n FLOP per column against 4*(n + m) bytes, about 25
// FLOP/B, just above the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20
// FLOP/B), so it is bound by the fp32 FMA rate rather than by memory.
// Tensor cores (TF32 wgmma) would lift that; this first version keeps plain
// FMA so that its summation order matches the fused kernel's.
//
// The accumulation order (k = 0 .. n-1, one fmaf per term, from 0) is the
// same as fused_chain.cu's, so a chain run through this kernel axis by axis
// and the same chain run through the fused kernel agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kron_axis_kernel(const float* __restrict__ s, const float* __restrict__ x,
                 float* __restrict__ o, long long L, int n, long long R, int m,
                 int tile) {
  extern __shared__ float smem[];
  float* ss = smem;            // S, m x n
  float* xs = smem + m * n;    // slab, n rows of stride tile + 1
  const int ld = tile + 1;
  const long long cols = L * R;
  const long long c0 = static_cast<long long>(blockIdx.x) * tile;
  const int width = static_cast<int>(cols - c0 < tile ? cols - c0 : tile);

  for (int i = threadIdx.x; i < m * n; i += blockDim.x) ss[i] = s[i];

  if (R == 1) {
    // Columns are consecutive l: the slab is x[c0 * n, (c0 + width) * n).
    const float* src = x + c0 * n;
    for (int i = threadIdx.x; i < width * n; i += blockDim.x) {
      const int j = i / n;
      const int k = i - j * n;
      xs[k * ld + j] = src[i];
    }
  } else {
    for (int i = threadIdx.x; i < n * tile; i += blockDim.x) {
      const int k = i / tile;
      const int j = i - k * tile;
      if (j < width) {
        const long long c = c0 + j;
        const long long l = c / R;
        const long long r = c - l * R;
        xs[k * ld + j] = x[(l * n + k) * R + r];
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < m * tile; i += blockDim.x) {
    const int q = i / tile;
    const int j = i - q * tile;
    if (j >= width) continue;
    const float* srow = ss + q * n;
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc = fmaf(srow[k], xs[k * ld + j], acc);
    const long long c = c0 + j;
    const long long l = c / R;
    const long long r = c - l * R;
    o[(l * m + q) * R + r] = acc;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int kron_axis_launch(const float* s, const float* x, float* o, long long L,
                     int n, long long R, int m, int tile, void* stream) {
  const long long cols = L * R;
  if (cols <= 0 || m <= 0) return 0;
  // S plus the slab; kron_matvec.py's _axis_smem_bytes is the same formula.
  const long long smem =
      4LL * (static_cast<long long>(m) * n + static_cast<long long>(n) * (tile + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kron_axis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (cols + tile - 1) / tile;
  kron_axis_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                     static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(s, x, o, L, n, R, m,
                                                          tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
