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
// Bound.  At the main-path shapes it is bound by memory: the (10, 10, 10)
// measure chain with Sub_10 does 48.8 kFLOP per row against 6.9 kB moved,
// about 7 FLOP/B, below the card's fp32 ridge of about 20 FLOP/B (67 TFLOP/s
// over 3.35 TB/s).  At Synth-10^100's 3-way measure chain (323,400 rows) the
// least time is 2.24 GB / 3.35 TB/s, about 0.67 ms, against 0.24 ms of fp32
// FMAs; at the 3-way reconstruct chain (161,700 rows, (10,10,10) ->
// (10,10,10)) 1.29 GB, about 0.39 ms.  The FMAs fit under the byte floor
// only if each costs about one issued instruction, so the design is about
// the instructions around each FMA.
//
// Design.  One block owns `rows` consecutive rows.  It copies all factors
// into shared memory, loads its rows into buffer A, and contracts axis by
// axis between two shared-memory buffers A and B (ping-pong), with
// __syncthreads() between axes; the last buffer is written straight to Y.
// So each row crosses device memory twice (in and out) and every
// intermediate stays on chip.  fused.py's plan_chain sizes `rows` so the
// factors and both buffers fit the 227 KB a block may use; a chain that does
// not fit even one row goes to the per-axis kernel (kron_axis.cu).
//
// - Dense intermediates.  Before axis a the block's rows hold the tensor
//   (rows * pre, n_a, post) contiguously (pre = prod m_j, j < a, already
//   contracted; post = prod n_j, j > a), so the rows merge with `pre`, and
//   staging in and out is one flat contiguous copy: 16-byte global loads
//   and stores (with a scalar edge) when the row span is aligned, no
//   division per element.
// - Two contractions, by the width n_a of the axis; fused.py's axis_cap
//   chooses (cap = n_a up to 16, else 0) and the launcher refuses any other.
//   * n_a <= 16 (Synth's 10, most of Adult's attributes): one thread per
//     line.  A line is (o, t), o < rows * pre, t < post: the n_a inputs
//     x[o, :, t] and the m_a outputs y[o, :, t].  The thread divides once
//     per line (o = line / post), loads the line's n_a inputs into a
//     register array (a template on n_a, so its length is known at compile
//     time), then produces all m_a outputs from it.
//   * n_a > 16 (Adult's 42 to 100): one thread per item (4 consecutive
//     outputs q of one line), the items of one q group next to each other.
//     The thread streams the line four inputs at a time against four rows
//     of S, with four independent sums.  At Adult's widest chains a block
//     holds one row, so a line per thread would leave most threads idle
//     and each of the rest with one long dependent chain of FMAs; items
//     spread m_a / 4 times as much work over the block, and no register
//     array of length n_a holds the kernel's register count up.
//   fused.py's fused_geometry precomputes pre, post and the epilogue's
//   stride per axis on the host and passes them in Chain.
// - Broadcast factor reads.  Each factor is packed with its rows padded to
//   a multiple of 4 columns (zeros), so S[q, :] is read four values at a
//   time: a 16-byte load for float, 8 bytes for the two-byte types, and
//   warp-uniform (every thread of the warp reads the same S[q, k]), hence a
//   broadcast.  On the register path an output costs n_a FMAs, n_a / 4
//   loads of S and one store; the streamed path adds one load per input
//   per item (n_a / 4 an output).
// - Bank conflicts.  On the last axis (post = 1) the lines are contiguous
//   runs of n_a, so neighbouring threads read at stride n_a: 2-way
//   conflicts at Synth's n = 10, on one load per input.  Not padded.
//
// Summation order: k = 0 .. n-1, one fmaf per term, from 0 -- the same as
// kron_axis.cu, so the two kernels agree bit for bit on the same chain.  The
// padding terms past n_a are fmaf(0, 0, acc), which leaves acc as it is
// (acc is never -0 starting from +0).
//
// Epilogue.  An axis marked in `epi` gets an inclusive prefix sum along it
// after the whole chain (the implicit form of the prefix matrix tril(1) that
// ResidualPlanner+ reconstruction needs for prefix and range queries).  The
// TPU kernel computes it as a contraction with an iota-built triangular ones
// matrix on the MXU (fused.py: _tril_ones); here that would be O(n^2) work
// for an O(n) scan, so each thread instead runs a serial scan over one line
// (the same line mapping as the contraction, m_a elements at stride
// `epost`), in place in the current buffer, marked axes in axis order with
// __syncthreads() between them.  Shared memory does not grow.  The scan adds
// from index 0 upward in float32; torch.cumsum (the plain version) sums in
// another order on the card and in double on the CPU, so the two agree to a
// tolerance, not bit for bit.
//
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
// the tril epilogue included).  The narrow kernel moves the same device-
// memory bytes as the float one (rows in and out at four bytes): a narrow
// type buys shared-memory room, hence more rows per block and chains that
// fit the fused kernel at all, not bytes.  With bf16 or fp16 operands every
// product is exact in float32, so fmaf and a separate multiply and add give
// the same sum: the kernel agrees with fused.py's narrow plain version bit
// for bit (the epilogue aside, whose plain version is torch.cumsum).
//
// The shared-memory attribute (up to 227 KB of dynamic shared memory) is set
// once per instantiation and device, not on every launch.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAxes = 16;          // fused.py's _MAX_AXES
constexpr int kSmemMax = 232448;      // 227 KB: what one Hopper block may use
constexpr int kExactCap = 16;         // fused.py's _EXACT_CAP
constexpr int kFields = 8;            // ints of an Axis record (fused.py's FusedAxis)

// One axis of the chain, as fused.py's fused_geometry lays it out.
struct Axis {
  int n;       // input size
  int m;       // output size (n for an identity axis)
  int off;     // offset of S in the packed factors (rows of pad4(n)); -1: identity
  int epi;     // 1: inclusive prefix sum along the axis after the chain
  int pre;     // prod m_j, j < a: lines of a row before the axis
  int post;    // prod n_j, j > a: the contraction's line stride
  int epost;   // prod m_j, j > a: the epilogue's line stride
  int cap;     // n: the inputs in registers (n <= 16); 0: streamed
};

struct Chain {
  int k;
  Axis ax[kMaxAxes];
};

// Widening to float and rounding (to nearest, ties to even) to the operand,
// and reading or writing four consecutive operands (16 bytes of float, 8 of
// a two-byte type; the address is aligned to that).
template <typename T> struct Operand;
template <> struct Operand<float> {
  static __device__ __forceinline__ float wide(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
  static __device__ __forceinline__ void load4(const float* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <> struct Operand<__nv_bfloat16> {
  static __device__ __forceinline__ float wide(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<unsigned int*>(&lo), *reinterpret_cast<unsigned int*>(&hi));
  }
};
template <> struct Operand<__half> {
  static __device__ __forceinline__ float wide(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half narrow(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ void load4(const __half* p, float* v) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store4(__half* p, float4 v) {
    __half2 lo = __floats2half2_rn(v.x, v.y);
    __half2 hi = __floats2half2_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<unsigned int*>(&lo), *reinterpret_cast<unsigned int*>(&hi));
  }
};

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// Contracts one axis of at most 16 inputs for the block's rows: src
// (lines * n) -> dst (lines * m) with `lines` = rows * pre * post, one thread
// per line.  N = n: the line's inputs live in registers.
template <typename T, int N>
__device__ __forceinline__ void contract_exact(const T* __restrict__ src,
                                               T* __restrict__ dst,
                                               const T* __restrict__ S, int nr,
                                               const Axis& A) {
  using Op = Operand<T>;
  constexpr int ld = (N + 3) & ~3;
  const int lines = nr * A.pre * A.post;
  for (int l = threadIdx.x; l < lines; l += kThreads) {
    const int o = l / A.post;
    const int t = l - o * A.post;
    const T* xr = src + o * N * A.post + t;
    T* yr = dst + o * A.m * A.post + t;
    float xv[N];
#pragma unroll
    for (int k = 0; k < N; ++k) xv[k] = Op::wide(xr[k * A.post]);
    for (int q = 0; q < A.m; ++q) {
      const T* sq = S + q * ld;
      float acc = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < N; k4 += 4) {
        float s4[4];
        Op::load4(sq + k4, s4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k4 + j < N) acc = fmaf(s4[j], xv[k4 + j], acc);
      }
      yr[q * A.post] = Op::narrow(acc);
    }
  }
}

// Contracts one axis of more than 16 inputs: one thread per item (q group
// g of 4 consecutive q, line l), g-major so that a warp shares g (its S
// loads are broadcasts) and holds neighbouring lines.  The item streams its
// line four inputs at a time and keeps four independent sums; inputs past n
// are 0, against S's zero padding.
template <typename T>
__device__ void contract_streamed(const T* __restrict__ src,
                                  T* __restrict__ dst,
                                  const T* __restrict__ S, int nr,
                                  const Axis& A) {
  using Op = Operand<T>;
  const int n = A.n;
  const int ld = pad4(n);
  const int lines = nr * A.pre * A.post;
  const int items = lines * ((A.m + 3) / 4);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int g = it / lines;
    const int l = it - g * lines;
    const int o = l / A.post;
    const int t = l - o * A.post;
    const T* xr = src + o * n * A.post + t;
    T* yr = dst + o * A.m * A.post + t;
    const int q0 = 4 * g;
    const int qn = A.m - q0 < 4 ? A.m - q0 : 4;
    const T* sq = S + q0 * ld;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k4 = 0; k4 < n; k4 += 4) {
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xv[j] = k4 + j < n ? Op::wide(xr[(k4 + j) * A.post]) : 0.f;
      float s4[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r < qn) {
          Op::load4(sq + r * ld + k4, s4[r]);
        } else {
          s4[r][0] = s4[r][1] = s4[r][2] = s4[r][3] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = fmaf(s4[r][j], xv[j], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < qn) yr[(q0 + r) * A.post] = Op::narrow(acc[r]);
  }
}

template <typename T>
__device__ __forceinline__ void contract_axis(const T* src, T* dst, const T* S,
                                              int nr, const Axis& A) {
  switch (A.cap) {
#define EXACT(N) case N: contract_exact<T, N>(src, dst, S, nr, A); return;
    EXACT(1) EXACT(2) EXACT(3) EXACT(4) EXACT(5) EXACT(6) EXACT(7) EXACT(8)
    EXACT(9) EXACT(10) EXACT(11) EXACT(12) EXACT(13) EXACT(14) EXACT(15)
    EXACT(16)
#undef EXACT
    default: contract_streamed<T>(src, dst, S, nr, A); return;
  }
}

// Staging: count elements of a contiguous row span between device memory
// (float32) and shared memory (T).  16-byte global accesses when both sides
// are aligned for a four-element vector, else scalar; either way coalesced.
template <typename T>
__device__ __forceinline__ void stage_in(const float* __restrict__ g,
                                         T* __restrict__ s, int count) {
  using Op = Operand<T>;
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(s) & (4 * sizeof(T) - 1)) == 0;
  int done = 0;
  if (vec) {
    const int nv = count / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      const float4 u = __ldg(g4 + v);
      Op::store4(s + 4 * v, u);
    }
    done = 4 * nv;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads)
    s[i] = Op::narrow(__ldg(g + i));
}

template <typename T>
__device__ __forceinline__ void stage_out(const T* __restrict__ s,
                                          float* __restrict__ g, int count) {
  using Op = Operand<T>;
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(s) & (4 * sizeof(T) - 1)) == 0;
  int done = 0;
  if (vec) {
    const int nv = count / 4;
    float4* g4 = reinterpret_cast<float4*>(g);
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      float w[4];
      Op::load4(s + 4 * v, w);
      g4[v] = make_float4(w[0], w[1], w[2], w[3]);
    }
    done = 4 * nv;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads)
    g[i] = Op::wide(s[i]);
}

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

  // nf is a multiple of 4, so the factors copy in 8-byte words.
  {
    const uint2* f8 = reinterpret_cast<const uint2*>(f);
    uint2* s8 = reinterpret_cast<uint2*>(fs);
    const int words = nf * static_cast<int>(sizeof(T)) / 8;
    for (int i = threadIdx.x; i < words; i += kThreads) s8[i] = f8[i];
  }
  stage_in<T>(x + r0 * w_in, src, nr * w_in);
  __syncthreads();

  for (int a = 0; a < ch.k; ++a) {
    const Axis A = ch.ax[a];
    if (A.off < 0) continue;
    contract_axis<T>(src, dst, fs + A.off, nr, A);
    __syncthreads();
    T* tmp = src;
    src = dst;
    dst = tmp;
  }

  // The buffer now holds (nr, m_1, ..., m_k).  Scan each marked axis (an
  // identity axis too): one thread per (row * pre, epost) line.
  for (int a = 0; a < ch.k; ++a) {
    const Axis A = ch.ax[a];
    if (!A.epi) continue;
    const int lines = nr * A.pre * A.epost;
    for (int l = threadIdx.x; l < lines; l += kThreads) {
      const int o = l / A.epost;
      T* line = src + o * A.m * A.epost + (l - o * A.epost);
      float acc = 0.f;
      for (int k = 0; k < A.m; ++k) {
        acc += Op::wide(line[k * A.epost]);
        line[k * A.epost] = Op::narrow(acc);
      }
    }
    __syncthreads();
  }

  stage_out<T>(src, y + r0 * w_out, nr * w_out);
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
           long long blocks, int smem, cudaStream_t stream) {
  const long long need =
      static_cast<long long>(sizeof(T)) * (nf + 2LL * rows * buf);
  if (need != smem || smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_chain_kernel<T><<<static_cast<unsigned int>(blocks), kThreads,
                          static_cast<size_t>(smem), stream>>>(
      x, y, static_cast<const T*>(f), B, ch, nf, rows, buf, w_in, w_out);
  return static_cast<int>(cudaGetLastError());
}

bool valid_cap(int n, int cap) { return cap == (n <= kExactCap ? n : 0); }

}  // namespace

extern "C" {

// geo: k records of kFields ints (n, m, off, epi, pre, post, epost, cap), as
// fused.py's fused_geometry lays them out; f holds the packed factors (rows
// padded to a multiple of 4 columns) at the operand type of `dtype`:
// 0 float, 1 bfloat16, 2 float16.  blocks and smem are the launch as
// fused.py computes it; the launcher refuses a geometry it would not
// compute itself.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int fused_chain_launch(const float* x, float* y, const void* f, long long B,
                       int k, const int* geo, int nf, int rows, int buf,
                       long long blocks, int smem, int dtype, void* stream) {
  if (k < 1 || k > kMaxAxes || rows < 1 || nf % 4) return cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (blocks != (B + rows - 1) / rows || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Chain ch;
  ch.k = k;
  int w_in = 1, w_out = 1, pre = 1;
  for (int a = 0; a < k; ++a) {
    Axis& A = ch.ax[a];
    const int* g = geo + a * kFields;
    A = Axis{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7]};
    if (A.n < 1 || A.m < 1 || A.pre != pre) return cudaErrorInvalidValue;
    if (A.off >= 0 && (A.off % 4 || A.off + A.m * ((A.n + 3) & ~3) > nf ||
                       !valid_cap(A.n, A.cap)))
      return cudaErrorInvalidValue;
    pre *= A.m;
    w_in *= A.n;
    w_out *= A.m;
  }
  for (int a = 0, post = w_in, epost = w_out; a < k; ++a) {
    const Axis& A = ch.ax[a];
    post /= A.n;
    epost /= A.m;
    if (A.post != post || A.epost != epost) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, f, B, ch, nf, rows, buf, w_in, w_out, blocks,
                           smem, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, f, B, ch, nf, rows, buf, w_in, w_out,
                                   blocks, smem, s);
    case 2:
      return launch<__half>(x, y, f, B, ch, nf, rows, buf, w_in, w_out, blocks,
                            smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
