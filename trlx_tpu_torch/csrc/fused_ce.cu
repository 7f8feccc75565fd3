// Log-probability of labels over a large vocabulary, and its gradient,
// for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_fused_kernel` (trlx_tpu/ops/fused_ce.py:50,
// reached through `_logprobs_pallas`) and the gradient that the JAX
// package leaves to XLA (`_fused_bwd`, trlx_tpu/ops/fused_ce.py:197). For
// each row of logits [N, V] (f32 or bf16) and its label (already clamped
// into [0, V) by the wrapper):
//   forward   lse[r]     = max + log(sum exp(logits[r] - max))   (f32 [N])
//             logprob[r] = logits[r, label[r]] - lse[r]          (f32 [N])
//   backward  dlogits[r, c] = g[r] * ((c == label[r]) - exp(logits[r, c] - lse[r])),
//             in f32, rounded once to the logits' type            ([N, V])
// The forward writes nothing of size [N, V]; the backward reads the
// logits once and writes dlogits once.
//
// Bound. Both are bound by memory bytes on this card: the forward reads
// every logit once (SFT's [8184, 50257] bf16 is 823 MB, 0.246 ms at
// 3.35 TB/s), the backward reads and writes it (0.491 ms). The forward's
// one exponential per element is close behind: the special-function units
// take 16 a clock per SM, 823 M of them about 0.2 ms at 1.98 GHz, so the
// exponentials and the loads must overlap, and the arithmetic around each
// exponential must stay small.
//
// Design.
// - The row walk. V is odd, so bf16 rows start at every 2-byte
//   alignment. Each row is peeled: the elements before its first 16-byte
//   boundary (the head, at most 7 bf16 or 3 f32), then whole 16-byte
//   vectors, then the rest (the tail). The vectors are read with
//   `ld.global.nc.L1::no_allocate.v4` and, in the backward, written with
//   streaming 16-byte stores; the head and the tail are read one element
//   a thread. A row starts at `row * stride` elements; the stride is V
//   today (contiguous logits), and the walk needs nothing else should a
//   padded row stride come later.
// - The forward's tiles. A thread reads TILE vectors at once (TILE x 16
//   bytes in flight), takes their max over packed bf16 pairs (`max.bf16x2`,
//   exact) before converting, rescales its running sum once a tile, and
//   sums exp2(x * log2e - m * log2e): one FMA and one `ex2.approx` an
//   element.
// - The split. A row's vectors may be cut into `n_splits` (1, 2, 4 or 8)
//   contiguous slices, one thread block each, planned from the shapes
//   alone by the wrapper (`split_plan`, `bwd_split_plan` in
//   ops/fused_ce.py). In the forward, few rows (the PPO step's 1,280)
//   would otherwise fill the card's 132 SMs for about 1.2 waves; the
//   slices of a row form one thread-block cluster, each block leaves its
//   (max, sum) in its shared memory and the cluster's first block merges
//   them through distributed shared memory in rank order, so a result is
//   the same bit for bit from run to run. The backward's blocks are
//   independent, and it splits every long row.
// - The backward writes zeros for a row whose incoming gradient is 0
//   (masked and padding positions) without reading its logits.
//
// The kernels are templates over their levers (load width, tile, the
// exponential, the packed max) so that `scripts/fused_ce_ablation.py` can
// time each lever apart in its own build; the package instantiates one
// configuration of each, below (`FwdChoice`, `BwdChoice`).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Elements, vectors and the row walk
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// BYTES bytes of T read or written at once (16: one v4 access; 4: one word)
template <typename T, int BYTES>
struct Vec {
  static constexpr int WORDS = BYTES / 4;
  static constexpr int N = BYTES / (int)sizeof(T);
  uint32_t w[WORDS];

  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[e]);
    } else {  // bf16: the low half of a word is the earlier element
      const uint32_t word = w[e / 2];
      return __uint_as_float(e % 2 == 0 ? word << 16 : word & 0xffff0000u);
    }
  }
  __device__ __forceinline__ void fill_neg_inf() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = sizeof(T) == 4 ? 0xff800000u : 0xff80ff80u;
  }
};

template <typename T, int BYTES>
__device__ __forceinline__ Vec<T, BYTES> load_vec(const void* p) {
  Vec<T, BYTES> v;
  if constexpr (BYTES == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.w[0]), "=r"(v.w[1]), "=r"(v.w[2]), "=r"(v.w[3])
        : "l"(p));
  } else {
    static_assert(BYTES == 4, "16- or 4-byte accesses");
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v.w[0]) : "l"(p));
  }
  return v;
}

template <typename T, int BYTES>
__device__ __forceinline__ void store_vec(void* p, const Vec<T, BYTES>& v) {
  if constexpr (BYTES == 16) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.w[0]), "r"(v.w[1]),
                 "r"(v.w[2]), "r"(v.w[3])
                 : "memory");
  } else {
    asm volatile("st.global.cs.u32 [%0], %1;" ::"l"(p), "r"(v.w[0]) : "memory");
  }
}

// Pack f[0..N) into a vector of T (bf16: pairs rounded with cvt.rn.bf16x2).
template <typename T, int BYTES>
__device__ __forceinline__ Vec<T, BYTES> pack(const float* f) {
  Vec<T, BYTES> v;
#pragma unroll
  for (int i = 0; i < Vec<T, BYTES>::WORDS; ++i) {
    if constexpr (sizeof(T) == 4) {
      v.w[i] = __float_as_uint(f[i]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      v.w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return v;
}

// A row of `vocab` elements at `x`: `head` elements before the first
// BYTES-aligned address, `n_vec` whole vectors, `tail` elements after.
struct RowSpan {
  int head, n_vec, tail;
};

template <typename T, int BYTES>
__device__ __forceinline__ RowSpan row_span(const T* x, int vocab) {
  constexpr int N = BYTES / (int)sizeof(T);
  const int misaligned = (int)(reinterpret_cast<uintptr_t>(x) % BYTES);
  const int head = min(misaligned ? (BYTES - misaligned) / (int)sizeof(T) : 0, vocab);
  const int n_vec = (vocab - head) / N;
  return {head, n_vec, vocab - head - n_vec * N};
}

// The vectors [begin, end) of slice `rank` of `n_splits`.
__device__ __forceinline__ void slice(int n_vec, int rank, int n_splits, int& begin, int& end) {
  begin = (int)((long long)n_vec * rank / n_splits);
  end = (int)((long long)n_vec * (rank + 1) / n_splits);
}

// ---------------------------------------------------------------------------
// Exponentials
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the FMA units (no special-function unit): x = i + f with i the
// nearest integer (by the 1.5 * 2^23 rounding trick, no conversion
// instruction), 2^f on [-0.5, 0.5] by a degree-5 polynomial (relative
// error 2.5e-7, the size of ex2.approx's), i added into the exponent.
__device__ __forceinline__ float soft_ex2(float x) {
  x = fmaxf(x, -126.f);
  const float r = x + 12582912.f;
  const float f = x - (r - 12582912.f);
  float p = fmaf(1.3400432653725147e-3f, f, 9.676037356257439e-3f);
  p = fmaf(p, f, 5.550327152013779e-2f);
  p = fmaf(p, f, 2.402210682630539e-1f);
  p = fmaf(p, f, 6.931471824645996e-1f);
  p = fmaf(p, f, 1.0000001192092896f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(r) << 23));
}

// EXP: 0 = expf of the difference (libm), 1 = ex2.approx of x * log2e -
// m * log2e, 2 = as 1 with the tile's last vector on soft_ex2.
template <int EXP>
__device__ __forceinline__ float exp_diff(float a, float b) {  // exp(a - b)
  if constexpr (EXP == 0) {
    return expf(a - b);
  } else {
    return ex2((a - b) * LOG2E);
  }
}

// Merge (m2, l2) into (m, l): each a max and a sum of exp(x - max).
template <int EXP>
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * exp_diff<EXP>(m, mn) + l2 * exp_diff<EXP>(m2, mn);
  m = mn;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int BYTES, int TILE, bool HMAX>
__device__ __forceinline__ float tile_max(const Vec<T, BYTES> (&t)[TILE]) {
  if constexpr (HMAX && sizeof(T) == 2) {
    __nv_bfloat162 mx = *reinterpret_cast<const __nv_bfloat162*>(&t[0].w[0]);
#pragma unroll
    for (int u = 0; u < TILE; ++u)
#pragma unroll
      for (int i = 0; i < Vec<T, BYTES>::WORDS; ++i)
        mx = __hmax2(mx, *reinterpret_cast<const __nv_bfloat162*>(&t[u].w[i]));
    return fmaxf(__low2float(mx), __high2float(mx));
  } else {
    float mx = __uint_as_float(0xff800000u);  // -inf
#pragma unroll
    for (int u = 0; u < TILE; ++u)
#pragma unroll
      for (int e = 0; e < Vec<T, BYTES>::N; ++e) mx = fmaxf(mx, t[u].get(e));
    return mx;
  }
}

template <int EXP>
__device__ __forceinline__ void fold(float& m, float& l, float x) {  // one element into (m, l)
  const float mn = fmaxf(m, x);
  l = l * exp_diff<EXP>(m, mn) + exp_diff<EXP>(x, mn);
  m = mn;
}

template <typename T, int BYTES, int TILE, int EXP, bool HMAX>
__global__ void __launch_bounds__(THREADS)
    label_logprob_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                         float* __restrict__ out, float* __restrict__ lse_out, int vocab, int n_splits) {
  using V = Vec<T, BYTES>;
  __shared__ float red_m[WARPS], red_l[WARPS];
  __shared__ float part[2];  // this block's (max, sum), merged by rank 0 of the cluster
  const int row = blockIdx.x / n_splits, rank = blockIdx.x % n_splits;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t stride = vocab;  // the row stride in elements: contiguous logits
  const T* x = logits + row * stride;
  const RowSpan sp = row_span<T, BYTES>(x, vocab);
  const bool first = rank == 0 && tid == 0;
  const float label_logit = first ? to_f32(x[labels[row]]) : 0.f;  // loaded before the walk

  float m = NEG_INF, l = 0.f;
  if (rank == 0 && tid < sp.head) fold<EXP>(m, l, to_f32(x[tid]));
  if (rank == n_splits - 1 && tid < sp.tail) fold<EXP>(m, l, to_f32(x[sp.head + sp.n_vec * V::N + tid]));
  const V* vx = reinterpret_cast<const V*>(x + sp.head);
  int v0, v1;
  slice(sp.n_vec, rank, n_splits, v0, v1);
  for (int v = v0 + tid; v < v1; v += THREADS * TILE) {
    V t[TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int i = v + u * THREADS;
      if (i < v1) {
        t[u] = load_vec<T, BYTES>(vx + i);
      } else {
        t[u].fill_neg_inf();
      }
    }
    const float mn = fmaxf(m, tile_max<T, BYTES, TILE, HMAX>(t));
    float s = 0.f;
    if constexpr (EXP == 0) {
#pragma unroll
      for (int u = 0; u < TILE; ++u)
#pragma unroll
        for (int e = 0; e < V::N; ++e) s += expf(t[u].get(e) - mn);
    } else {
      const float ml = mn * LOG2E;
      float s2 = 0.f;  // a second chain for the soft exponentials
#pragma unroll
      for (int u = 0; u < TILE; ++u)
#pragma unroll
        for (int e = 0; e < V::N; ++e) {
          const float a = fmaf(t[u].get(e), LOG2E, -ml);
          if (EXP == 2 && u == TILE - 1) {
            s2 += soft_ex2(a);
          } else {
            s += ex2(a);
          }
        }
      s += s2;
    }
    l = l * exp_diff<EXP>(m, mn) + s;
    m = mn;
  }

  // the block: a butterfly in each warp, then one over the warps' results
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge<EXP>(m, l, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, l, off));
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < WARPS ? red_m[lane] : NEG_INF;
    l = lane < WARPS ? red_l[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge<EXP>(m, l, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, l, off));
  }
  // the cluster: rank 0 merges the blocks' results in rank order
  if (n_splits > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) {
      part[0] = m;
      part[1] = l;
    }
    cluster.sync();
    if (first) {
      m = NEG_INF;
      l = 0.f;
      for (int r = 0; r < n_splits; ++r) {
        const float* p = cluster.map_shared_rank(part, r);
        merge<EXP>(m, l, p[0], p[1]);
      }
    }
    cluster.sync();  // no block leaves while rank 0 may still read its part
  }
  if (first) {
    const float lse = m + logf(l);
    lse_out[row] = lse;
    out[row] = label_logit - lse;
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <typename T, int BYTES, int TILE>
__global__ void __launch_bounds__(THREADS)
    label_logprob_bwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                             const float* __restrict__ lse, const float* __restrict__ g,
                             T* __restrict__ dlogits, int vocab, int n_splits) {
  using V = Vec<T, BYTES>;
  const int row = blockIdx.x / n_splits, rank = blockIdx.x % n_splits;
  const int tid = threadIdx.x;
  const size_t stride = vocab;
  const T* x = logits + row * stride;
  T* d = dlogits + row * stride;  // the same alignment as x (the wrapper's)
  const RowSpan sp = row_span<T, BYTES>(x, vocab);
  int v0, v1;
  slice(sp.n_vec, rank, n_splits, v0, v1);
  const int tail0 = sp.head + sp.n_vec * V::N;
  V* vd = reinterpret_cast<V*>(d + sp.head);
  const float gr = g[row];
  if (gr == 0.f) {  // a masked row: zeros, its logits unread
    V z;
#pragma unroll
    for (int i = 0; i < V::WORDS; ++i) z.w[i] = 0u;
    if (rank == 0 && tid < sp.head) d[tid] = from_f32<T>(0.f);
    if (rank == n_splits - 1 && tid < sp.tail) d[tail0 + tid] = from_f32<T>(0.f);
    for (int v = v0 + tid; v < v1; v += THREADS) store_vec<T, BYTES>(vd + v, z);
    return;
  }
  const int lab = labels[row];
  const float lr = lse[row];
  // d = g * (onehot - p), the plain version's order of operations
  auto grad = [&](float xv, int c) { return gr * ((c == lab ? 1.f : 0.f) - ex2((xv - lr) * LOG2E)); };
  if (rank == 0 && tid < sp.head) d[tid] = from_f32<T>(grad(to_f32(x[tid]), tid));
  if (rank == n_splits - 1 && tid < sp.tail) d[tail0 + tid] = from_f32<T>(grad(to_f32(x[tail0 + tid]), tail0 + tid));
  const V* vx = reinterpret_cast<const V*>(x + sp.head);
  for (int v = v0 + tid; v < v1; v += THREADS * TILE) {
    V t[TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int i = v + u * THREADS;
      if (i < v1) t[u] = load_vec<T, BYTES>(vx + i);
    }
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int i = v + u * THREADS;
      if (i >= v1) break;
      const int c0 = sp.head + i * V::N;  // the vector's first column
      float f[V::N];
      if ((unsigned)(lab - c0) < (unsigned)V::N) {  // the vector holding the label
#pragma unroll
        for (int e = 0; e < V::N; ++e) f[e] = grad(t[u].get(e), c0 + e);
      } else {
#pragma unroll
        for (int e = 0; e < V::N; ++e) f[e] = gr * -ex2((t[u].get(e) - lr) * LOG2E);
      }
      store_vec<T, BYTES>(vd + i, pack<T, BYTES>(f));
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers (templates: the ablation script instantiates other levers)
// ---------------------------------------------------------------------------

template <int BYTES_, int TILE_, int EXP_, bool HMAX_>
struct FwdCfg {
  static constexpr int BYTES = BYTES_, TILE = TILE_, EXP = EXP_;
  static constexpr bool HMAX = HMAX_;
};

template <int BYTES_, int TILE_>
struct BwdCfg {
  static constexpr int BYTES = BYTES_, TILE = TILE_;
};

// the package's configurations
using FwdChoice = FwdCfg<16, 4, 1, true>;
using BwdChoice = BwdCfg<16, 4>;

template <typename T, class C>
int launch_fwd(const void* logits, const int32_t* labels, float* out, float* lse, int n, int vocab,
               int n_splits, cudaStream_t s) {
  auto kernel = label_logprob_kernel<T, C::BYTES, C::TILE, C::EXP, C::HMAX>;
  const T* x = static_cast<const T*>(logits);
  if (n_splits == 1) {
    kernel<<<n, THREADS, 0, s>>>(x, labels, out, lse, vocab, 1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * n_splits);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, x, labels, out, lse, vocab, n_splits);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

template <typename T, class C>
int launch_bwd(const void* logits, const int32_t* labels, const float* lse, const float* g, void* dlogits,
               int n, int vocab, int n_splits, cudaStream_t s) {
  label_logprob_bwd_kernel<T, C::BYTES, C::TILE><<<(unsigned)n * n_splits, THREADS, 0, s>>>(
      static_cast<const T*>(logits), labels, lse, g, static_cast<T*>(dlogits), vocab, n_splits);
  return (int)cudaGetLastError();
}

bool valid_args(int n, int vocab, int n_splits) {
  return n > 0 && vocab > 0 && (n_splits == 1 || n_splits == 2 || n_splits == 4 || n_splits == MAX_SPLITS) &&
         (long long)n * n_splits < (1LL << 31);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 logits [n, vocab]; labels int32 [n] in
// [0, vocab); n_splits in {1, 2, 4, 8}. Returns the CUDA error of the
// launch (0 = success).
int trlx_label_logprobs(const void* logits, const void* labels, void* out, void* lse, int n, int vocab,
                        int dtype, int n_splits, void* stream) {
  if (!valid_args(n, vocab, n_splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return launch_fwd<float, FwdChoice>(logits, lab, o, l, n, vocab, n_splits, s);
    case 1: return launch_fwd<__nv_bfloat16, FwdChoice>(logits, lab, o, l, n, vocab, n_splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dlogits [n, vocab] of the logits' type, 16-byte aligned where the
// logits are (the same address mod 16); lse and g f32 [n].
int trlx_label_logprobs_bwd(const void* logits, const void* labels, const void* lse, const void* g,
                            void* dlogits, int n, int vocab, int dtype, int n_splits, void* stream) {
  if (!valid_args(n, vocab, n_splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  switch (dtype) {
    case 0: return launch_bwd<float, BwdChoice>(logits, lab, l, gg, dlogits, n, vocab, n_splits, s);
    case 1: return launch_bwd<__nv_bfloat16, BwdChoice>(logits, lab, l, gg, dlogits, n, vocab, n_splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
