// Paged-attention decode for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels `_paged_decode_kernel` and
// `_paged_decode_kernel_quant` (trlx_tpu/ops/paged_attention.py, reached
// through `paged_attention_decode`): single-query decode attention over a
// paged KV arena. One template covers both: the KV type is f32, bf16, or
// int8 with f32 per-token-per-head scale planes (dequantized as each tile
// is staged, the ops/quant.py dequantize_kv math), and the query/output
// type is f32 or bf16.
//
// Layouts (the JAX package's, unchanged):
//   q        [b, nh, hd]                 T
//   k/v      [n_blocks, blk, nkv, hd]    KV
//   k/v_scale[n_blocks, blk, nkv]        f32 (int8 only)
//   table    [b, n_tbl]                  int32 physical block ids
//   key_mask [b, n_tbl*blk]              int32 key validity (1 = attend)
//   out      [b, nh, hd]                 T
//
// Design. One thread block per (kv head, slot) reads its own row of the
// block table (the TPU kernel took it by scalar prefetch), loads the
// q-head group [group, hd] once, and walks the table: for each entry it
// stages the physical block's K and V tiles [blk, hd] in shared memory,
// scores all `group` q rows against the tile, and folds the tile into an
// online softmax whose running max, denominator and numerator stay in
// f32. Masked columns get exactly zero weight and a row with no valid
// column writes exactly 0.0 (NEG_INF = -1e30 with clamped shifts, as on
// the TPU). A table entry whose columns are all masked (past the row's
// length) is skipped before its tile is loaded, so the walk stops
// reading KV at the row's last valid block; the result is the same as
// walking all of n_tbl. Table entries outside [0, n_blocks) count as
// masked. GQA: q head h reads kv head h / group, so each K/V tile is
// read once per group instead of once per q head.
//
// Bound. Decode attention is bound by memory bytes: it must read K and V
// for every valid column once per kv head (plus q, the mask and the
// table) and does about 4 flops per KV element read. At gpt2-small with
// 8 slots, 320 columns and bf16 KV that is about 7.9 MB per layer-step
// if the whole table is valid, about 2.3 us at 3.35 TB/s. What the design
// does about it: KV is read once per group and only for blocks that hold
// a valid column, and nothing is materialised in device memory besides
// the output. Tiles are staged with 16-byte vector loads, several in
// flight per thread. It stays simple otherwise: one block per (slot, kv
// head) (96 blocks on 132 SMs at gpt2-small/8 slots) walking its tiles
// one after another; TMA, a split over table entries and tensor-core
// products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LOAD_UNROLL = 4;  // chunk loads in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Eight consecutive elements of one K/V row, loaded with one vector
// access per 16 bytes (hd is a multiple of 8, so every chunk is aligned).
template <typename KV> struct Chunk;
template <> struct Chunk<float> { float4 a, b; };
template <> struct Chunk<__nv_bfloat16> { uint4 a; };
template <> struct Chunk<int8_t> { int2 a; };

__device__ __forceinline__ Chunk<float> load_chunk(const float* p) {
  const float4* v = reinterpret_cast<const float4*>(p);
  return Chunk<float>{__ldg(v), __ldg(v + 1)};
}
__device__ __forceinline__ Chunk<__nv_bfloat16> load_chunk(const __nv_bfloat16* p) {
  return Chunk<__nv_bfloat16>{__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Chunk<int8_t> load_chunk(const int8_t* p) {
  return Chunk<int8_t>{__ldg(reinterpret_cast<const int2*>(p))};
}

__device__ __forceinline__ void unpack(const Chunk<float>& c, float* o) {
  o[0] = c.a.x; o[1] = c.a.y; o[2] = c.a.z; o[3] = c.a.w;
  o[4] = c.b.x; o[5] = c.b.y; o[6] = c.b.z; o[7] = c.b.w;
}
__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Chunk<int8_t>& c, float* o) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&c.a);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory in floats; must match the carve-up at the top of the kernel.
__host__ __device__ inline size_t smem_floats(int group, int hd, int blk) {
  const size_t hdp = (size_t)hd + 1;  // padded tile row: no bank conflicts across columns
  return (size_t)group * hd          // q group
       + 2 * (size_t)blk * hdp       // K and V tiles
       + (size_t)group * blk         // scores, then softmax weights
       + (size_t)group * hd          // numerator
       + 3 * (size_t)group           // running max, denominator, correction
       + (size_t)blk;                // column validity (int)
}

template <typename T, typename KV, bool QUANT>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_arena, const KV* __restrict__ v_arena,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int32_t* __restrict__ table, const int32_t* __restrict__ key_mask,
    T* __restrict__ out, int nh, int nkv, int hd, int n_blocks, int blk, int n_tbl,
    float scale) {
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int group = nh / nkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hdp = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + group * hd;
  float* v_s = k_s + blk * hdp;
  float* p_s = v_s + blk * hdp;
  float* acc_s = p_s + group * blk;
  float* m_s = acc_s + group * hd;
  float* l_s = m_s + group;
  float* corr_s = l_s + group;
  int* valid_s = reinterpret_cast<int*>(corr_s + group);

  // q heads [kvh*group, (kvh+1)*group) of this slot are contiguous
  const T* q_row = q + ((size_t)row * nh + (size_t)kvh * group) * hd;
  for (int i = tid; i < group * hd; i += THREADS) {
    q_s[i] = to_f32(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const size_t col_stride = (size_t)nkv * hd;  // one token column of the arena
  const int32_t* mask_row = key_mask + (size_t)row * n_tbl * blk;
  for (int j = 0; j < n_tbl; ++j) {
    const int phys = table[(size_t)row * n_tbl + j];
    const bool in_range = phys >= 0 && phys < n_blocks;
    int any = 0;
    for (int c = tid; c < blk; c += THREADS) {
      const int v = in_range && mask_row[(size_t)j * blk + c] != 0;
      valid_s[c] = v;
      any |= v;
    }
    // block-uniform: a tile with no valid column changes nothing
    if (!__syncthreads_or(any)) continue;

    // stage the tile: every thread issues LOAD_UNROLL chunk loads before
    // it converts and stores any, so a tile costs about one memory round
    // trip instead of one per chunk
    const size_t base = ((size_t)phys * blk * nkv + kvh) * hd;
    const int chunks_per_col = hd / 8;
    const int n_chunks = blk * chunks_per_col;
    for (int first = tid; first < n_chunks; first += LOAD_UNROLL * THREADS) {
      Chunk<KV> kc[LOAD_UNROLL], vc[LOAD_UNROLL];
      float ksc[LOAD_UNROLL], vsc[LOAD_UNROLL];
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int i = first + u * THREADS;
        if (i < n_chunks) {
          const int c = i / chunks_per_col;
          const size_t off = base + c * col_stride + (size_t)(i - c * chunks_per_col) * 8;
          kc[u] = load_chunk(k_arena + off);
          vc[u] = load_chunk(v_arena + off);
          if (QUANT) {
            const size_t si = ((size_t)phys * blk + c) * nkv + kvh;
            ksc[u] = k_scale[si];
            vsc[u] = v_scale[si];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int i = first + u * THREADS;
        if (i < n_chunks) {
          const int c = i / chunks_per_col;
          const int d = (i - c * chunks_per_col) * 8;
          float kx[8], vx[8];
          unpack(kc[u], kx);
          unpack(vc[u], vx);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            k_s[c * hdp + d + e] = QUANT ? kx[e] * ksc[u] : kx[e];
            v_s[c * hdp + d + e] = QUANT ? vx[e] * vsc[u] : vx[e];
          }
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < group * blk; i += THREADS) {
      const int g = i / blk;
      const int c = i - g * blk;
      float s = NEG_INF;
      if (valid_s[c]) {
        const float* qg = q_s + g * hd;
        const float* kc = k_s + c * hdp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kc[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per q row of the group
    for (int g = warp; g < group; g += WARPS) {
      float* pg = p_s + g * blk;
      float mx = NEG_INF;
      for (int c = lane; c < blk; c += 32) mx = fmaxf(mx, pg[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      // a row masked so far keeps m == NEG_INF: clamp the shift so masked
      // entries cannot turn into exp(0) = 1
      const float shift = (m_new <= NEG_INF / 2) ? 0.f : m_new;
      float sum = 0.f;
      for (int c = lane; c < blk; c += 32) {
        const float s = pg[c];
        const float p = (s <= NEG_INF / 2) ? 0.f : expf(s - shift);
        pg[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_prev <= NEG_INF / 2) ? 0.f : expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * hd; i += THREADS) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* pg = p_s + g * blk;
      float pv = 0.f;
      for (int c = 0; c < blk; ++c) pv = fmaf(pg[c], v_s[c * hdp + d], pv);
      acc_s[i] = acc_s[i] * corr_s[g] + pv;
    }
    __syncthreads();
  }
  __syncthreads();

  T* o_row = out + ((size_t)row * nh + (size_t)kvh * group) * hd;
  for (int i = tid; i < group * hd; i += THREADS) {
    const float l = l_s[i / hd];
    store_out(o_row + i, acc_s[i] / (l > 0.f ? l : 1.f));
  }
}

template <typename T, typename KV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* table, const void* key_mask, void* out, int b, int nh, int nkv, int hd,
           int n_blocks, int blk, int n_tbl, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(nh / nkv, hd, blk) * sizeof(float);
  auto kernel = paged_decode_kernel<T, KV, QUANT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nkv, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(key_mask),
      static_cast<T*>(out), nh, nkv, hd, n_blocks, blk, n_tbl, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* table, const void* key_mask, void* out, int b, int nh,
              int nkv, int hd, int n_blocks, int blk, int n_tbl, float scale,
              cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<T, float, false>(q, k, v, ks, vs, table, key_mask, out, b, nh, nkv, hd,
                                     n_blocks, blk, n_tbl, scale, stream);
    case 1:
      return launch<T, __nv_bfloat16, false>(q, k, v, ks, vs, table, key_mask, out, b, nh, nkv,
                                             hd, n_blocks, blk, n_tbl, scale, stream);
    case 2:
      return launch<T, int8_t, true>(q, k, v, ks, vs, table, key_mask, out, b, nh, nkv, hd,
                                     n_blocks, blk, n_tbl, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes.
size_t trlx_paged_attention_smem_bytes(int group, int hd, int blk) {
  return smem_floats(group, hd, blk) * sizeof(float);
}

// q_dtype: 0 = f32, 1 = bf16 (also the output type).
// kv_dtype: 0 = f32, 1 = bf16, 2 = int8 with f32 scale planes.
// Returns the CUDA error of the launch (0 = success).
int trlx_paged_attention_decode(const void* q, const void* k_arena, const void* v_arena,
                                const void* k_scale, const void* v_scale, const void* table,
                                const void* key_mask, void* out, int b, int nh, int nkv, int hd,
                                int n_blocks, int blk, int n_tbl, float scale, int q_dtype,
                                int kv_dtype, void* stream) {
  if (b <= 0 || nkv <= 0 || nh % nkv != 0 || n_tbl <= 0 || blk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, q, k_arena, v_arena, k_scale, v_scale, table, key_mask,
                              out, b, nh, nkv, hd, n_blocks, blk, n_tbl, scale, s);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k_arena, v_arena, k_scale, v_scale, table,
                                      key_mask, out, b, nh, nkv, hd, n_blocks, blk, n_tbl, scale,
                                      s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
