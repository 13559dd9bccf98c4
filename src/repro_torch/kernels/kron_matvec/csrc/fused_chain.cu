// Fused Kronecker-chain kernel for Hopper (sm_90a):
//
//     Y[b, :] = (S_1 (x) S_2 (x) ... (x) S_k) X[b, :]      for every row b
//
// Each row of X (B, prod n_i) is viewed as a tensor (n_1, ..., n_k) and
// contracted with every non-identity factor S_i (m_i, n_i) along its axis in
// one launch; Y is (B, prod m_i).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kron_matvec/fused.py
// (_make_fused_kernel, launched by _build_fused_call).  The TPU version pads
// the batch to the sublane quantum and the row to the 128-lane quantum, once
// on entry and once on exit; here rows are read and written at their true
// width, so there is no pad and no slice.
//
// Design.  One block owns `rows` consecutive rows.  It copies all factors
// (tiny: at most 101 x 101 floats each on the main path) into shared memory,
// loads its rows with coalesced reads into buffer A, and contracts axis by
// axis between two shared-memory buffers A and B (ping-pong), each sized for
// the largest intermediate of the chain.  Threads stride over the output
// elements of the current axis, each an FMA loop over n_i, with
// __syncthreads() between axes.  The last buffer is written straight to Y.
// So each row crosses device memory twice (in and out) and every
// intermediate stays on chip.  fused.py's plan_chain sizes `rows` so the
// buffers and factors fit the 227 KB a block may use; a chain that does not
// fit even one row goes to the per-axis kernel (kron_axis.cu).
//
// Bound.  At the main-path shapes it is bound by memory: the (10, 10, 10)
// measure chain with Sub_10 does 48.8 kFLOP per row against 6.9 kB moved,
// about 7 FLOP/B, below the card's fp32 ridge of about 20 FLOP/B (67 TFLOP/s
// over 3.35 TB/s).  At Synth-10^100's 3-way measure chain (323,400 rows) the
// least time is 2.24 GB / 3.35 TB/s, about 0.67 ms; at the 3-way reconstruct
// chain (161,700 rows, (10,10,10) -> (10,10,10)) 1.29 GB, about 0.39 ms.
// Attribute sizes (2 to 101) are far below wgmma's 64-row tile, so this
// first version uses FMA loops; batch rows as the M dimension of a tensor-
// core product is later work.
//
// Summation order: k = 0 .. n-1, one fmaf per term, from 0 -- the same as
// kron_axis.cu, so the two kernels agree bit for bit on the same chain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAxes = 16;   // fused.py's _MAX_AXES

struct Chain {
  int k;               // number of axes
  int n[kMaxAxes];     // input size of each axis
  int m[kMaxAxes];     // output size of each axis (n for an identity axis)
  int off[kMaxAxes];   // offset of S_i in the packed factors, -1: identity
};

__global__ void __launch_bounds__(kThreads)
fused_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const float* __restrict__ f, long long B, Chain ch, int nf,
                   int rows, int buf, int w_in, int w_out) {
  extern __shared__ float smem[];
  float* fs = smem;
  float* src = smem + nf;
  float* dst = src + rows * buf;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const int nr = static_cast<int>(B - r0 < rows ? B - r0 : rows);

  for (int i = threadIdx.x; i < nf; i += blockDim.x) fs[i] = f[i];
  const float* xin = x + r0 * w_in;
  for (int i = threadIdx.x; i < nr * w_in; i += blockDim.x) {
    const int r = i / w_in;
    src[r * buf + (i - r * w_in)] = xin[i];
  }
  __syncthreads();

  for (int a = 0; a < ch.k; ++a) {
    if (ch.off[a] < 0) continue;
    int pre = 1, post = 1;
    for (int j = 0; j < a; ++j) pre *= ch.m[j];
    for (int j = a + 1; j < ch.k; ++j) post *= ch.n[j];
    const int n = ch.n[a];
    const int mp = ch.m[a] * post;
    const int out = pre * mp;
    const float* S = fs + ch.off[a];
    for (int i = threadIdx.x; i < nr * out; i += blockDim.x) {
      const int r = i / out;
      const int e = i - r * out;
      const int p = e / mp;
      const int rem = e - p * mp;
      const int q = rem / post;
      const int t = rem - q * post;
      const float* xr = src + r * buf + p * n * post + t;
      const float* srow = S + q * n;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc = fmaf(srow[k], xr[k * post], acc);
      dst[r * buf + e] = acc;
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  float* yout = y + r0 * w_out;
  for (int i = threadIdx.x; i < nr * w_out; i += blockDim.x) {
    const int r = i / w_out;
    yout[i] = src[r * buf + (i - r * w_out)];
  }
}

}  // namespace

extern "C" {

// n, m, off: host arrays of k ints (fused.py packs them).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int fused_chain_launch(const float* x, float* y, const float* f, long long B,
                       int k, const int* n, const int* m, const int* off,
                       int nf, int rows, int buf, void* stream) {
  if (k < 1 || k > kMaxAxes || rows < 1) return cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Chain ch;
  ch.k = k;
  int w_in = 1, w_out = 1;
  for (int a = 0; a < k; ++a) {
    ch.n[a] = n[a];
    ch.m[a] = m[a];
    ch.off[a] = off[a];
    w_in *= n[a];
    w_out *= m[a];
  }
  const long long smem = 4LL * (nf + 2LL * rows * buf);
  cudaError_t err = cudaFuncSetAttribute(
      fused_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + rows - 1) / rows;
  fused_chain_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      x, y, f, B, ch, nf, rows, buf, w_in, w_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
