// Log-probability of labels over a large vocabulary for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU kernel `_fused_kernel` (trlx_tpu/ops/fused_ce.py:50,
// reached through `_logprobs_pallas`): for each row of logits [N, V]
// (f32 or bf16) and its label (already clamped into [0, V) by the
// wrapper), one streaming pass over the vocabulary gives the row's
// log-sum-exp and the label's logit; nothing of size [N, V] is written.
//   logprob[r] = logits[r, label[r]] - lse[r]      (f32 [N])
//   lse[r]     = max + log(sum exp(logits[r] - max)) (f32 [N])
//
// Design. One block of 256 threads per row. Each thread walks the row at
// a stride of 256 columns, eight loads in flight, and keeps an online
// (running max, running sum of exp) pair in f32, rescaling its sum when
// the max grows, as the TPU kernel does per vocabulary block; the block
// then merges the 256 pairs (warp shuffles, then one warp over the warp
// results). The label's logit is read directly at its column, which is
// what the TPU kernel's column match selects. The TPU kernel's 2048-wide
// vocabulary blocks, its 128-lane label broadcast and its tail masking
// have no counterpart: the walk stops at V.
//
// Bound. The pass reads every logit once (at the main path's shape,
// 8184 x 50257 bf16 = 823 MB) and does a few operations per element, so
// it is bound by memory bytes: about 0.25 ms at 3.35 TB/s. Rows are not
// 16-byte aligned (V is odd), so loads are per element; consecutive
// threads read consecutive columns, which coalesces them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Merge (m2, l2) into (m, l): both are a max and a sum of exp(x - max).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    label_logprob_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                         float* __restrict__ out, float* __restrict__ lse_out, int vocab) {
  __shared__ float wm[THREADS / 32], wl[THREADS / 32];
  const size_t row = blockIdx.x;
  const T* x = logits + row * (size_t)vocab;
  float m = NEG_INF, l = 0.f;
  for (int c0 = threadIdx.x; c0 < vocab; c0 += THREADS * UNROLL) {
    float v[UNROLL];
    float cm = NEG_INF;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * THREADS;
      v[u] = c < vocab ? to_f32(__ldg(x + c)) : NEG_INF;
      cm = fmaxf(cm, v[u]);
    }
    const float mn = fmaxf(m, cm);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) s += v[u] <= NEG_INF / 2 ? 0.f : expf(v[u] - mn);
    l = l * expf(m - mn) + s;
    m = mn;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < THREADS / 32 ? wm[lane] : NEG_INF;
    l = lane < THREADS / 32 ? wl[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
      merge(m, l, m2, l2);
    }
    if (lane == 0) {
      const float lse = m + logf(l);
      lse_out[row] = lse;
      out[row] = to_f32(x[labels[row]]) - lse;
    }
  }
}

template <typename T>
int launch(const void* logits, const int32_t* labels, float* out, float* lse, int n, int vocab,
           cudaStream_t s) {
  label_logprob_kernel<T><<<n, THREADS, 0, s>>>(static_cast<const T*>(logits), labels, out, lse,
                                                vocab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 logits [n, vocab]; labels int32 [n] in [0, vocab).
// Returns the CUDA error of the launch (0 = success).
int trlx_label_logprobs(const void* logits, const void* labels, void* out, void* lse, int n,
                        int vocab, int dtype, void* stream) {
  if (n <= 0 || vocab <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return launch<float>(logits, lab, o, l, n, vocab, s);
    case 1: return launch<__nv_bfloat16>(logits, lab, o, l, n, vocab, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
