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
//
// Epilogue.  An axis marked in `epi` gets an inclusive prefix sum along it
// after the whole chain (the implicit form of the prefix matrix tril(1) that
// ResidualPlanner+ reconstruction needs for prefix and range queries).  The
// TPU kernel computes it as a contraction with an iota-built triangular ones
// matrix on the MXU (fused.py: _tril_ones); here that would be O(n^2) work
// for an O(n) scan, so each thread instead runs a serial scan over one line
// of the row tensor (m_a elements at stride `post`), in place in the current
// buffer, marked axes in axis order with __syncthreads() between them.
// Shared memory does not grow.  The scan adds from index 0 upward in float32;
// torch.cumsum (the plain version) sums in another order on the card and in
// double on the CPU, so the two agree to a tolerance, not bit for bit.  The
// scan is O(rows * w_out) adds per axis against the chain's O(rows * w * n)
// FMAs, so it leaves the bound of the launch as it was.

// Narrow operands.  The kernel is a template on the operand type T: float,
// __nv_bfloat16 or __half (one instantiation each, chosen by the launcher's
// dtype code).  The factors (packed at T by fused.py) and both ping-pong
// buffers are held at T, so at two bytes an element twice the rows fit a
// block; the float32 stack is rounded to T as it is staged into shared
// memory, each FMA widens both operands to float and accumulates with fmaf
// from 0 in the order k = 0 .. n-1, each axis's result is rounded to T when
// it is stored, the epilogue keeps its running sum in a float register and
// stores each prefix rounded to T, and the last buffer is widened to float32
// when it is written to Y.  These are the rounding points of the TPU
// kernel's _contract (fused.py: fp32 dot, narrowed after every contraction,
// the tril epilogue included).  The TPU package casts the stack to the
// narrow type in a separate pass before the kernel (one more read and write
// of it); here the cast happens while staging, so the narrow kernel moves
// the same device-memory bytes as the float one (rows in and out at four
// bytes): on this card a narrow type buys shared-memory room, hence more
// rows per block and chains that fit the fused kernel at all, not bytes.
// Its bound counts the float32 read and write.  With bf16 or fp16 operands
// every product is exact in float32, so fmaf and a separate multiply and
// add give the same sum: the kernel agrees with fused.py's narrow plain
// version bit for bit (the epilogue aside, whose plain version is
// torch.cumsum).  The float instantiation is the float kernel as it was.
//
// The shared-memory attribute (up to 227 KB of dynamic shared memory) is set
// once per instantiation and device, not on every launch.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAxes = 16;          // fused.py's _MAX_AXES
constexpr int kSmemMax = 232448;      // 227 KB: what one Hopper block may use

struct Chain {
  int k;               // number of axes
  int n[kMaxAxes];     // input size of each axis
  int m[kMaxAxes];     // output size of each axis (n for an identity axis)
  int off[kMaxAxes];   // offset of S_i in the packed factors, -1: identity
  int epi[kMaxAxes];   // 1: inclusive prefix sum along the axis after the chain
};

// Widening to float and rounding (to nearest, ties to even) to the operand.
template <typename T> struct Operand;
template <> struct Operand<float> {
  static __device__ __forceinline__ float wide(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};
template <> struct Operand<__nv_bfloat16> {
  static __device__ __forceinline__ float wide(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Operand<__half> {
  static __device__ __forceinline__ float wide(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half narrow(float v) {
    return __float2half_rn(v);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const T* __restrict__ f, long long B, Chain ch, int nf,
                   int rows, int buf, int w_in, int w_out) {
  using Op = Operand<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fs = reinterpret_cast<T*>(smem_raw);
  T* src = fs + nf;
  T* dst = src + rows * buf;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const int nr = static_cast<int>(B - r0 < rows ? B - r0 : rows);

  for (int i = threadIdx.x; i < nf; i += blockDim.x) fs[i] = f[i];
  const float* xin = x + r0 * w_in;
  for (int i = threadIdx.x; i < nr * w_in; i += blockDim.x) {
    const int r = i / w_in;
    src[r * buf + (i - r * w_in)] = Op::narrow(xin[i]);
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
    const T* S = fs + ch.off[a];
    for (int i = threadIdx.x; i < nr * out; i += blockDim.x) {
      const int r = i / out;
      const int e = i - r * out;
      const int p = e / mp;
      const int rem = e - p * mp;
      const int q = rem / post;
      const int t = rem - q * post;
      const T* xr = src + r * buf + p * n * post + t;
      const T* srow = S + q * n;
      float acc = 0.f;
      for (int k = 0; k < n; ++k)
        acc = fmaf(Op::wide(srow[k]), Op::wide(xr[k * post]), acc);
      dst[r * buf + e] = Op::narrow(acc);
    }
    __syncthreads();
    T* tmp = src;
    src = dst;
    dst = tmp;
  }

  // The buffer now holds (nr, m_1, ..., m_k).  Scan each marked axis (an
  // identity axis too): one thread per (row, pre, post) line.
  for (int a = 0; a < ch.k; ++a) {
    if (!ch.epi[a]) continue;
    int pre = 1, post = 1;
    for (int j = 0; j < a; ++j) pre *= ch.m[j];
    for (int j = a + 1; j < ch.k; ++j) post *= ch.m[j];
    const int n = ch.m[a];
    const int pp = pre * post;
    for (int i = threadIdx.x; i < nr * pp; i += blockDim.x) {
      const int r = i / pp;
      const int e = i - r * pp;
      const int p = e / post;
      const int t = e - p * post;
      T* line = src + r * buf + p * n * post + t;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) {
        acc += Op::wide(line[k * post]);
        line[k * post] = Op::narrow(acc);
      }
    }
    __syncthreads();
  }

  float* yout = y + r0 * w_out;
  for (int i = threadIdx.x; i < nr * w_out; i += blockDim.x) {
    const int r = i / w_out;
    yout[i] = Op::wide(src[r * buf + (i - r * w_out)]);
  }
}

// Allows the instantiation up to kSmemMax bytes of dynamic shared memory on
// the current device, once per device.
template <typename T>
cudaError_t allow_max_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fused_chain_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

template <typename T>
int launch(const float* x, float* y, const void* f, long long B,
           const Chain& ch, int nf, int rows, int buf, int w_in, int w_out,
           cudaStream_t stream) {
  const long long smem =
      static_cast<long long>(sizeof(T)) * (nf + 2LL * rows * buf);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + rows - 1) / rows;
  fused_chain_kernel<T><<<static_cast<unsigned int>(blocks), kThreads,
                          static_cast<size_t>(smem), stream>>>(
      x, y, static_cast<const T*>(f), B, ch, nf, rows, buf, w_in, w_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n, m, off, epi: host arrays of k ints (fused.py packs them).  f holds the
// packed factors at the operand type of `dtype`: 0 float, 1 bfloat16,
// 2 float16.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int fused_chain_launch(const float* x, float* y, const void* f, long long B,
                       int k, const int* n, const int* m, const int* off,
                       const int* epi, int nf, int rows, int buf, int dtype,
                       void* stream) {
  if (k < 1 || k > kMaxAxes || rows < 1) return cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Chain ch;
  ch.k = k;
  int w_in = 1, w_out = 1;
  for (int a = 0; a < k; ++a) {
    ch.n[a] = n[a];
    ch.m[a] = m[a];
    ch.off[a] = off[a];
    ch.epi[a] = epi[a];
    w_in *= n[a];
    w_out *= m[a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, f, B, ch, nf, rows, buf, w_in, w_out, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, f, B, ch, nf, rows, buf, w_in, w_out, s);
    case 2:
      return launch<__half>(x, y, f, B, ch, nf, rows, buf, w_in, w_out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
