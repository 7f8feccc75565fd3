// Causal flash attention, forward and backward, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the four TPU kernels of trlx_tpu/ops/attention.py:
//   K3 `_flash_fwd_kernel`       -> flash_fwd_kernel<T, HD, false>
//   K4 `_flash_fwd_kernel_lse`   -> flash_fwd_kernel<T, HD, true>
//   K5 `_flash_bwd_dq_kernel`    -> flash_bwd_dq_kernel<T, HD>
//   K6 `_flash_bwd_dkv_kernel`   -> flash_bwd_dkv_kernel<T, HD>
//
// Layouts (the model's, read in place; no transposes around the calls):
//   q, out, dout  [b, tq, nh, hd]    T (f32 or bf16)
//   k, v          [b, tk, nkv, hd]   T
//   mask          [b, tk]            int32 key validity (1 = attend)
//   lse, delta    [b, nh, tq]        f32
//   dq            [b, tq, nh, hd]    T
//   dk, dv        [b, tk, nh, hd]    f32, one slice per q head (the caller
//                                    sums each kv head's group, as the TPU
//                                    wrapper does outside its kernel)
// GQA: q head h reads kv head h / (nh / nkv).
//
// Math: every product and sum in f32, as the TPU kernels do (they cast
// q, k, v to f32 and compute p.V with p in f32). A key is allowed when its
// mask is set and, if causal, its index is <= the query's index. Scores of
// disallowed keys are NEG_INF = -1e30 and get exactly zero weight; the
// online-softmax shift is clamped as on the TPU, so a query with no
// allowed key (left padding, an empty row) writes exactly 0 and, in the
// LSE variant, lse = DEAD_LSE = 1e9. The backward relies on that:
// exp(s - 1e9) underflows to 0, so dead rows add nothing to dq/dk/dv.
//
// Design. One thread block of 256 threads owns a 64-row tile: a q tile in
// the forward and dq kernels, a k tile in the dk/dv kernel. It loops over
// the other side's 64-row tiles (the TPU's sequential grid axis becomes
// this loop), and with causal=1 skips the tiles that lie wholly above the
// diagonal. Tiles are staged in shared memory as f32 with one padding
// column, so that the 16 threads of a half warp read 16 distinct banks.
// Thread (ty, tx) = (tid / 16, tid % 16) owns the 4 rows ty*4..ty*4+3 of
// the 64x64 score tile at columns tx + 16 j, and the same rows of the
// accumulator at columns tx + 16 jj: row statistics reduce over the 16
// lanes of a half warp with shuffles, and the corrections apply in
// registers. The forward runs its q tiles in reverse order, so the long
// causal rows start first.
//
// Bound. At gpt2-small training shapes (b 8, t 1024, 12 heads, hd 64) the
// forward does 2 * 2 * b * nh * hd * t^2 / 2 ~ 12.9 GFLOP of causal
// products against ~50 MB of q/k/v/out, so it is bound by operations: the
// least time is 0.013 ms at the 989 TFLOP/s bf16 tensor-core peak. These
// kernels compute on the CUDA cores in f32 (67 TFLOP/s peak, and an
// f32 FMA tile reading shared memory reaches a fraction of that), which
// keeps them equal to the TPU kernels' arithmetic; moving the products
// to wgmma (bf16 q.k^T, with p.V split into bf16 hi/lo parts) is the next
// kernel PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float DEAD_LSE = 1e9f;
constexpr int THREADS = 256;
constexpr int TILE = 64;         // rows of every tile (q and k side)
constexpr int TP = TILE + 1;     // padded row length of a 64-wide score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum / max over the 16 lanes of a half warp (lanes differing in bits 0-3).
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Stage rows [row0, row0 + TILE) of head `head` of a [batch, t, heads, HD]
// tensor into dst[r * stride + d] as f32; rows at or past t read 0.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* src, int batch, int t,
                                           int heads, int head, int row0) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < t) x = to_f32(src[(((size_t)batch * t + row) * heads + head) * HD + d]);
    dst[r * stride + d] = x;
  }
}

template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int32_t* __restrict__ mask, T* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, int nh, int nkv, int causal,
                     float scale) {
  constexpr int J = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [TILE][HD + 1]
  float* Ks = Qs + TILE * (HD + 1);  // [TILE][HD + 1]
  float* Vs = Ks + TILE * (HD + 1);  // [TILE][HD]
  float* Ps = Vs + TILE * HD;        // [TILE][TP]
  int* Ms = reinterpret_cast<int*>(Ps + TILE * TP);  // [TILE]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);

  stage_rows<T, HD>(Qs, HD + 1, q, bi, tq, nh, h, q0);

  float m[4], l[4], acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + TILE) : tk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, HD>(Ks, HD + 1, k, bi, tk, nkv, kvh, k0);
    stage_rows<T, HD>(Vs, HD, v, bi, tk, nkv, kvh, k0);
    if (tid < TILE) Ms[tid] = (k0 + tid < tk) ? mask[(size_t)bi * tk + k0 + tid] : 0;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = Ms[c] > 0 && (!causal || k0 + c <= row);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      mc = half_warp_max(mc);
      const float m_new = fmaxf(m[i], mc);
      const float shift = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= NEG_INF / 2 ? 0.f : expf(s[i][j] - shift);
        Ps[(ty * 4 + i) * TP + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      const float corr = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * TP + kk];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float vv = Vs[kk * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= tq) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    T* o = out + (((size_t)bi * tq + row) * nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) o[tx + 16 * jj] = from_f32<T>(acc[i][jj] / denom);
    if (LSE && tx == 0)
      lse[((size_t)bi * nh + h) * tq + row] = l[i] > 0.f ? m[i] + logf(denom) : DEAD_LSE;
  }
}

// dq = sum over allowed keys of ds * k, with p = exp(s * scale - lse) and
// ds = p * (dp - delta) * scale, dp = dout . v (FlashAttention-2).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int32_t* __restrict__ mask,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int tq, int tk,
                        int nh, int nkv, int causal, float scale) {
  constexpr int J = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [TILE][HD + 1]
  float* Os = Qs + TILE * (HD + 1);    // dout tile
  float* Ks = Os + TILE * (HD + 1);
  float* Vs = Ks + TILE * (HD + 1);
  float* Ds = Vs + TILE * (HD + 1);    // ds tile [TILE][TP]
  int* Ms = reinterpret_cast<int*>(Ds + TILE * TP);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);

  stage_rows<T, HD>(Qs, HD + 1, q, bi, tq, nh, h, q0);
  stage_rows<T, HD>(Os, HD + 1, dout, bi, tq, nh, h, q0);
  float lse_r[4], delta_r[4], acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const size_t at = ((size_t)bi * nh + h) * tq + row;
    lse_r[i] = row < tq ? lse[at] : DEAD_LSE;
    delta_r[i] = row < tq ? delta[at] : 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + TILE) : tk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    stage_rows<T, HD>(Ks, HD + 1, k, bi, tk, nkv, kvh, k0);
    stage_rows<T, HD>(Vs, HD + 1, v, bi, tk, nkv, kvh, k0);
    if (tid < TILE) Ms[tid] = (k0 + tid < tk) ? mask[(size_t)bi * tk + k0 + tid] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * (HD + 1) + d];
        ov[i] = Os[(ty * 4 + i) * (HD + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = Ms[c] > 0 && (!causal || k0 + c <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        Ds[(ty * 4 + i) * TP + c] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(ty * 4 + i) * TP + kk];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float kv = Ks[kk * (HD + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(dsv[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= tq) continue;
    T* o = dq + (((size_t)bi * tq + row) * nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) o[tx + 16 * jj] = from_f32<T>(acc[i][jj]);
  }
}

// Per q head h and k tile: dv = sum over queries of p * dout and
// dk = sum of ds * q, in f32, written to the head's own slice.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int32_t* __restrict__ mask,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int tq, int tk, int nh, int nkv, int causal,
                         float scale) {
  constexpr int J = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                    // [TILE][HD + 1]
  float* Vs = Ks + TILE * (HD + 1);
  float* Qs = Vs + TILE * (HD + 1);
  float* Os = Qs + TILE * (HD + 1);    // dout tile
  float* Pt = Os + TILE * (HD + 1);    // p^T  [key][query], [TILE][TP]
  float* Dt = Pt + TILE * TP;          // ds^T
  float* Ls = Dt + TILE * TP;          // lse of the q tile [TILE]
  float* Es = Ls + TILE;               // delta of the q tile [TILE]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * TILE;
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);

  stage_rows<T, HD>(Ks, HD + 1, k, bi, tk, nkv, kvh, k0);
  stage_rows<T, HD>(Vs, HD + 1, v, bi, tk, nkv, kvh, k0);
  bool key_ok[4];
  float dk_acc[4][J], dv_acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    key_ok[i] = key < tk && mask[(size_t)bi * tk + key] > 0;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;
  }

  // causal: only q tiles holding a row >= k0 can reach this k tile
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  for (int q0 = q_begin; q0 < tq; q0 += TILE) {
    __syncthreads();
    stage_rows<T, HD>(Qs, HD + 1, q, bi, tq, nh, h, q0);
    stage_rows<T, HD>(Os, HD + 1, dout, bi, tq, nh, h, q0);
    if (tid < TILE) {
      const int row = q0 + tid;
      const size_t at = ((size_t)bi * nh + h) * tq + row;
      Ls[tid] = row < tq ? lse[at] : DEAD_LSE;
      Es[tid] = row < tq ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * (HD + 1) + d];
        vv[i] = Vs[(ty * 4 + i) * (HD + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * (HD + 1) + d];
        ov[j] = Os[(tx + 16 * j) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        const bool ok = key_ok[i] && row < tq && (!causal || key <= row);
        const float p = ok ? expf(s[i][j] * scale - Ls[c]) : 0.f;
        Pt[(ty * 4 + i) * TP + c] = p;
        Dt[(ty * 4 + i) * TP + c] = p * (dp[i][j] - Es[c]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < TILE; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty * 4 + i) * TP + qq];
        dsv[i] = Dt[(ty * 4 + i) * TP + qq];
      }
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float ov = Os[qq * (HD + 1) + tx + 16 * jj];
        const float qv = Qs[qq * (HD + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][jj] = fmaf(pv[i], ov, dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(dsv[i], qv, dk_acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= tk) continue;
    const size_t base = (((size_t)bi * tk + key) * nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      dk[base + tx + 16 * jj] = dk_acc[i][jj];
      dv[base + tx + 16 * jj] = dv_acc[i][jj];
    }
  }
}

size_t fwd_smem(int hd) {
  return (2 * TILE * (hd + 1) + TILE * hd + TILE * TP) * sizeof(float) + TILE * sizeof(int);
}
size_t dq_smem(int hd) {
  return (4 * TILE * (hd + 1) + TILE * TP) * sizeof(float) + TILE * sizeof(int);
}
size_t dkv_smem(int hd) { return (4 * TILE * (hd + 1) + 2 * TILE * TP + 2 * TILE) * sizeof(float); }

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, const int32_t* mask, void* out, float* lse,
        int b, int tq, int tk, int nh, int nkv, int causal, float scale, cudaStream_t s) {
  const size_t smem = fwd_smem(HD);
  const dim3 grid((tq + TILE - 1) / TILE, b * nh);
  if (lse != nullptr) {
    auto kernel = flash_fwd_kernel<T, HD, true>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), mask, static_cast<T*>(out), lse,
                                       tq, tk, nh, nkv, causal, scale);
  } else {
    auto kernel = flash_fwd_kernel<T, HD, false>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), mask, static_cast<T*>(out),
                                       nullptr, tq, tk, nh, nkv, causal, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd_dq(const void* q, const void* k, const void* v, const int32_t* mask, const void* dout,
           const float* lse, const float* delta, void* dq, int b, int tq, int tk, int nh, int nkv,
           int causal, float scale, cudaStream_t s) {
  const size_t smem = dq_smem(HD);
  auto kernel = flash_bwd_dq_kernel<T, HD>;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((tq + TILE - 1) / TILE, b * nh);
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), mask, static_cast<const T*>(dout),
                                     lse, delta, static_cast<T*>(dq), tq, tk, nh, nkv, causal,
                                     scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd_dkv(const void* q, const void* k, const void* v, const int32_t* mask, const void* dout,
            const float* lse, const float* delta, float* dk, float* dv, int b, int tq, int tk,
            int nh, int nkv, int causal, float scale, cudaStream_t s) {
  const size_t smem = dkv_smem(HD);
  auto kernel = flash_bwd_dkv_kernel<T, HD>;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((tk + TILE - 1) / TILE, b * nh);
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), mask, static_cast<const T*>(dout),
                                     lse, delta, dk, dv, tq, tk, nh, nkv, causal, scale);
  return (int)cudaGetLastError();
}

// Dispatch on (dtype code, head_dim): 0 = f32, 1 = bf16; hd in {16, 32, 64, 128}.
#define TRLX_FLASH_DISPATCH(FN, ...)                                         \
  switch (dtype * 1000 + hd) {                                               \
    case 16: return FN<float, 16>(__VA_ARGS__);                              \
    case 32: return FN<float, 32>(__VA_ARGS__);                              \
    case 64: return FN<float, 64>(__VA_ARGS__);                              \
    case 128: return FN<float, 128>(__VA_ARGS__);                            \
    case 1016: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                    \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                    \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                    \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                   \
    default: return (int)cudaErrorInvalidValue;                              \
  }

bool bad_shape(int b, int tq, int tk, int nh, int nkv) {
  return b <= 0 || tq <= 0 || tk <= 0 || nkv <= 0 || nh % nkv != 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes: which = 0 forward,
// 1 dq, 2 dk/dv.
size_t trlx_flash_smem_bytes(int which, int hd) {
  return which == 0 ? fwd_smem(hd) : which == 1 ? dq_smem(hd) : dkv_smem(hd);
}

// K3 (lse == NULL) and K4. Returns the CUDA error of the launch.
int trlx_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int dtype, int b, int tq, int tk, int nh, int nkv, int hd,
                   int causal, float scale, void* stream) {
  if (bad_shape(b, tq, tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* m = static_cast<const int32_t*>(mask);
  float* l = static_cast<float*>(lse);
  TRLX_FLASH_DISPATCH(fwd, q, k, v, m, out, l, b, tq, tk, nh, nkv, causal, scale, s)
}

// K5.
int trlx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* delta, void* dq, int dtype,
                      int b, int tq, int tk, int nh, int nkv, int hd, int causal, float scale,
                      void* stream) {
  if (bad_shape(b, tq, tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* m = static_cast<const int32_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* e = static_cast<const float*>(delta);
  TRLX_FLASH_DISPATCH(bwd_dq, q, k, v, m, dout, l, e, dq, b, tq, tk, nh, nkv, causal, scale, s)
}

// K6: dk, dv are f32 [b, tk, nh, hd].
int trlx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int dtype, int b, int tq, int tk, int nh, int nkv, int hd, int causal,
                       float scale, void* stream) {
  if (bad_shape(b, tq, tk, nh, nkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* m = static_cast<const int32_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  const float* e = static_cast<const float*>(delta);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  TRLX_FLASH_DISPATCH(bwd_dkv, q, k, v, m, dout, l, e, gk, gv, b, tq, tk, nh, nkv, causal, scale,
                      s)
}

}  // extern "C"
