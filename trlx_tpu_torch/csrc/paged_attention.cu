// Paged-attention decode for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels `_paged_decode_kernel` and
// `_paged_decode_kernel_quant` (trlx_tpu/ops/paged_attention.py, reached
// through `paged_attention_decode`): one query per slot over a paged KV
// arena, online softmax, GQA-grouped. One template covers both: the KV type
// is f32, bf16, or int8 with f32 per-token-per-head scale planes
// (dequantized in registers, the ops/quant.py dequantize_kv math), the
// query/output type is f32 or bf16, and the key mask is int32 or one byte.
//
// Layouts (the JAX package's, unchanged):
//   q        [b, nh, hd]                 T
//   k/v      [n_blocks, blk, nkv, hd]    KV
//   k/v_scale[n_blocks, blk, nkv]        f32 (int8 only)
//   table    [b, n_tbl]                  int32 physical block ids
//   key_mask [b, n_tbl*blk]              int32 or 1 byte (nonzero = attend)
//   out      [b, nh, hd]                 T
//
// Bound. Decode attention reads K and V for every valid column once per kv
// head and does about 4 flops per element read, so its bound is bytes. A
// serving call moves well under a megabyte (gpt2-small, 8 slots of up to
// 320 tokens, bf16: 0.63 us at 3.35 TB/s), so what sets its time on this
// card is latency: the launch, the memory round trips that depend on each
// other, and the longest serial chain of any one block. Only long rows
// (thousands of tokens) come near the bytes bound.
//
// Design (flash-decoding). The TPU kernel walks a row's table in one grid
// cell; here the table is split across blocks. The grid is (split, kv head,
// slot), a split being `pages_per_split` consecutive table entries, chosen
// on the host from the shapes alone (`split_plan` in ops/paged_attention.py:
// one page a split for serving tables, more for long tables so the grid
// stays near a fixed number of blocks). A block
//   1. loads its split's table entries, mask words and q group at once (one
//      round trip) and keeps, in table order, the pages whose entry lies in
//      [0, n_blocks) and that hold a valid column (other entries count as
//      masked and are never dereferenced);
//   2. issues the live pages' K/V tiles (and int8 scales) with cp.async,
//      16-byte chunks (8-byte for int8 rows of 8 * odd bytes), one commit
//      group a page, into a ring of `stages` tiles (two: more cost blocks an
//      SM), so a page's compute waits for its own copy only. Tiles stay in
//      the arena's type in shared memory and are widened to f32 in registers;
//   3. per page: scores with the warps over columns and the lanes over
//      8-element chunks of hd (one chunk a lane for a group of one, four,
//      kept in registers for every q row, for larger groups; bf16 K rows
//      XOR-swizzled against bank conflicts), shuffles reducing each dot, the
//      group's q rows looping over the same tile (K/V is read once per
//      group) R = 1, 2 or 4 at a time, so their chains overlap; an f32
//      online softmax, 8 lanes a row, with NEG_INF = -1e30 and the clamped
//      shift, as on the TPU; p.V with a thread per (R q rows, pair of hd),
//      the weights stored [column][group] so a column's R weights are one
//      vector load, adjacent lanes sharing an item's columns when items are
//      few. The kernel is instantiated per R, so a group of one keeps few
//      registers;
//   4. with one split, writes the output. Otherwise it writes its (m, l,
//      acc) to scratch, and the block that finishes a (slot, kv head) last
//      (a __threadfence and an atomic counter, which that block resets to
//      zero) copies every split's record into its idle ring with one burst
//      of cp.async and merges them in index order, so the result does not
//      depend on the order in which the blocks ran. A split with no valid
//      column writes m = NEG_INF and gets weight exactly 0 (its acc, never
//      written, is not used); a row with no valid column writes exactly 0.0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async8;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 4;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* table;
  const void* key_mask;
  void* out;
  float* partial;  // [b, nkv, n_splits, record(group, hd)]: m, l, acc (n_splits > 1)
  int* counters;   // [b * nkv], zero between launches (n_splits > 1)
  int nh, nkv, hd, n_blocks, blk, n_tbl, pages_per_split, n_splits, stages, mask_bytes;
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Floats of one split's record in the scratch: m [group] and l [group],
// padded to 16 bytes, then acc [group, hd].
__host__ __device__ inline int stats_floats(int group) { return (2 * group + 3) / 4 * 4; }
__host__ __device__ inline size_t record_floats(int group, int hd) {
  return stats_floats(group) + (size_t)group * hd;
}

// The q rows a page's loops take at a time, and the group padded to them:
// the weights are stored [column][padded group], so that p.V reads a
// column's R weights with one vector load.
__host__ __device__ inline int rows_at_once(int group) { return group == 1 ? 1 : group == 2 ? 2 : 4; }
__host__ __device__ inline int padded_group(int group) {
  return (group + rows_at_once(group) - 1) / rows_at_once(group) * rows_at_once(group);
}

// Byte offsets into the dynamic shared memory; the host sizes a launch with
// the same function.
struct Layout {
  size_t q, acc, p, stats, stage, tiles, valid, pages, den, total;
};

__host__ __device__ inline Layout layout(int group, int hd, int blk, int kv_bytes, bool quant,
                                         int pages_per_split, int n_splits, int stages) {
  Layout L;
  size_t o = 0;
  L.q = o;     o += align16((size_t)group * hd * 4);   // q group, f32
  L.acc = o;   o += align16((size_t)group * hd * 4);   // numerator, f32
  L.p = o;     o += align16((size_t)padded_group(group) * blk * 4);  // scores, then weights
  L.stats = o; o += align16((size_t)group * 3 * 4);    // running max, denominator, correction
  L.stage = align16((size_t)2 * blk * hd * kv_bytes) + (quant ? align16((size_t)2 * blk * 4) : 0);
  // K, V (and scales) ring in the arena's type; then, in the merging block,
  // every split's record
  const size_t records = n_splits > 1 ? (size_t)n_splits * record_floats(group, hd) * 4 : 0;
  L.tiles = o; o += (size_t)stages * L.stage > records ? (size_t)stages * L.stage : records;
  L.valid = o; o += align16((size_t)pages_per_split * blk);           // column validity
  L.pages = o; o += align16((size_t)(2 * pages_per_split + 2) * 4);   // entries, live pages, flags
  L.den = o;   o += align16((size_t)group * 4);                       // the merge's denominators
  L.total = o;
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Eight consecutive elements of a staged row, widened to f32.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const int2 a = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&a);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

// Two consecutive elements of a staged row, widened to f32.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// Wait until at most n commit groups are pending (n < MAX_STAGES).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// 8-element chunks of hd a lane takes in the scores: with one q row a K
// chunk is used once, so a lane holds one; with more it holds four, which
// serve every row (fewer lanes a column, fewer shuffles).
template <int R>
__host__ __device__ constexpr int chunks_per_lane() { return R == 1 ? 1 : 4; }

// Lanes that share one K column in the scores (a power of two).
template <int R>
__device__ __forceinline__ int score_lanes(int hd) {
  int lanes = 1;
  while (lanes * chunks_per_lane<R>() < hd / 8) lanes *= 2;
  return lanes;
}

// K row c's chunks (8 elements) lie in a stage at chunk ^ k_swizzle(c): bf16
// rows of a multiple of 128 bytes are XOR-swizzled, so that the columns
// that one load of the scores reads (32 / lanes columns, lanes chunks each)
// fall in different banks. `cols` is 8 / lanes - 1 for those rows, else 0.
template <int R>
__device__ __forceinline__ int k_swizzle_cols(int kv_bytes, int hd) {
  const int lanes = score_lanes<R>(hd);
  return kv_bytes == 2 && hd % 64 == 0 && lanes < 8 ? 8 / lanes - 1 : 0;
}
__device__ __forceinline__ int k_swizzle(int c, int cols, int lanes) { return (c & cols) * lanes; }

// R consecutive weights of one column.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float* o) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
    o[0] = p[0];
  }
}

// Issue the cp.async copies of physical block `phys`'s K and V tiles
// [blk, hd] of kv head `kvh` (and their scales) into stage `st`.
template <typename KV, bool QUANT, int R>
__device__ __forceinline__ void stage_page(const Params& P, int kvh, int phys, char* st) {
  const int blk = P.blk;
  const int row = P.hd * (int)sizeof(KV);        // bytes of one token's head
  const size_t col = (size_t)P.nkv * row;        // bytes between token columns of the arena
  const size_t base = ((size_t)phys * blk * P.nkv + kvh) * row;
  const char* k = static_cast<const char*>(P.k) + base;
  const char* v = static_cast<const char*>(P.v) + base;
  const uint32_t ks = (uint32_t)__cvta_generic_to_shared(st);
  const uint32_t vs = ks + blk * row;
  // copy i is piece j of row c; (c, j) advance without a division
  if (row % 16 == 0) {
    const int per_row = row / 16;
    const int lanes = score_lanes<R>(P.hd), cols = k_swizzle_cols<R>(sizeof(KV), P.hd);
    const int dc = THREADS / per_row, dj = THREADS % per_row;
    for (int i = threadIdx.x, c = i / per_row, j = i % per_row; i < blk * per_row; i += THREADS) {
      const int dst = j ^ k_swizzle(c, cols, lanes);  // a 16-byte copy is one bf16 chunk
      cp_async16(ks + c * row + dst * 16, k + c * col + j * 16, true);
      cp_async16(vs + c * row + j * 16, v + c * col + j * 16, true);
      c += dc;
      j += dj;
      if (j >= per_row) {
        j -= per_row;
        ++c;
      }
    }
  } else {  // int8 rows of 8 * odd bytes
    const int per_row = row / 8;
    const int dc = THREADS / per_row, dj = THREADS % per_row;
    for (int i = threadIdx.x, c = i / per_row, j = i % per_row; i < blk * per_row; i += THREADS) {
      cp_async8(ks + c * row + j * 8, k + c * col + j * 8, true);
      cp_async8(vs + c * row + j * 8, v + c * col + j * 8, true);
      c += dc;
      j += dj;
      if (j >= per_row) {
        j -= per_row;
        ++c;
      }
    }
  }
  if (QUANT) {
    const uint32_t ss = ks + (uint32_t)align16((size_t)2 * blk * row);
    const size_t s0 = (size_t)phys * blk * P.nkv + kvh;
    for (int c = threadIdx.x; c < blk; c += THREADS) {
      cp_async4(ss + 4 * c, P.k_scale + s0 + (size_t)c * P.nkv, true);
      cp_async4(ss + 4 * (blk + c), P.v_scale + s0 + (size_t)c * P.nkv, true);
    }
  }
}

// Fold one staged page into the online softmax of the q group, R q rows at
// a time (independent shuffle and FMA chains).
template <typename KV, bool QUANT, int R>
__device__ __forceinline__ void attend_page(const Params& P, const char* st, const uint8_t* valid,
                                            int group, const float* q_s, float* p_s, float* acc_s,
                                            float* m_s, float* l_s, float* corr_s) {
  const int hd = P.hd, blk = P.blk;
  const int gp = padded_group(group);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const KV* kt = reinterpret_cast<const KV*>(st);
  const KV* vt = kt + (size_t)blk * hd;
  const float* k_sc = reinterpret_cast<const float*>(st + align16((size_t)2 * blk * hd * sizeof(KV)));
  const float* v_sc = k_sc + blk;

  // scores: `lanes` lanes a column, lane ch0 taking chunks ch0 + lanes * j;
  // a warp takes 32 / lanes columns at once
  constexpr int CPL = chunks_per_lane<R>();
  const int chunks = hd / 8;
  const int lanes = score_lanes<R>(hd), cols = k_swizzle_cols<R>(sizeof(KV), hd);
  const int per_pass = 32 / lanes;
  const int sub = lane / lanes, ch0 = lane % lanes;
  for (int c0 = warp * per_pass; c0 < blk; c0 += WARPS * per_pass) {
    const int c = c0 + sub;
    const int swz = k_swizzle(c, cols, lanes);
    float kx[CPL][8];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int ch = ch0 + j * lanes;
      if (c < blk && ch < chunks) {
        load8(kt + (size_t)c * hd + (ch ^ swz) * 8, kx[j]);
        if (QUANT) {
          const float s = k_sc[c];
#pragma unroll
          for (int e = 0; e < 8; ++e) kx[j][e] *= s;
        }
      }
    }
    for (int g0 = 0; g0 < group; g0 += R) {
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int ch = ch0 + j * lanes;
          if (c < blk && ch < chunks && g0 + r < group) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + (g0 + r) * hd + ch * 8);
            const float4 a = qv[0], b = qv[1];
            d = fmaf(a.x, kx[j][0], d); d = fmaf(a.y, kx[j][1], d);
            d = fmaf(a.z, kx[j][2], d); d = fmaf(a.w, kx[j][3], d);
            d = fmaf(b.x, kx[j][4], d); d = fmaf(b.y, kx[j][5], d);
            d = fmaf(b.z, kx[j][6], d); d = fmaf(b.w, kx[j][7], d);
          }
        }
        dot[r] = d;
      }
      for (int o = lanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
      }
      if (ch0 == 0 && c < blk) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (g0 + r < group) p_s[c * gp + g0 + r] = valid[c] ? dot[r] * P.scale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // online softmax, 8 lanes a q row, 4 rows a warp
  for (int g0 = warp * 4; g0 < group; g0 += WARPS * 4) {
    const int g = g0 + lane / 8, l8 = lane % 8;
    const bool on = g < group;
    float mx = NEG_INF;
    if (on)
      for (int c = l8; c < blk; c += 8) mx = fmaxf(mx, p_s[c * gp + g]);
    for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = on ? m_s[g] : NEG_INF;
    const float m_new = fmaxf(m_prev, mx);
    // a row masked so far keeps m == NEG_INF: clamp the shift so masked
    // entries cannot turn into exp(0) = 1
    const float shift = (m_new <= NEG_INF / 2) ? 0.f : m_new;
    float sum = 0.f;
    if (on)
      for (int c = l8; c < blk; c += 8) {
        const float s = p_s[c * gp + g];
        const float p = (s <= NEG_INF / 2) ? 0.f : expf(s - shift);
        p_s[c * gp + g] = p;
        sum += p;
      }
    for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (on && l8 == 0) {
      const float corr = (m_prev <= NEG_INF / 2) ? 0.f : expf(m_prev - m_new);
      corr_s[g] = corr;
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
    }
  }
  __syncthreads();

  // p.V: an item is (R q rows, pair of hd); `share` adjacent lanes split an
  // item's columns when there are fewer items than threads, and shuffles
  // add their sums. Weights of rows past the group are never stored.
  const int pairs = hd / 2;
  const int items = gp / R * pairs;
  int share = 1;
  while (share < 4 && items * share * 2 <= THREADS) share *= 2;
  const int per_warp = 32 / share;
  for (int base = warp * per_warp; base < items; base += WARPS * per_warp) {
    const int item = base + lane / share, part = lane % share;
    const bool on = item < items;
    const int g0 = on ? item / pairs * R : 0;
    const int d = on ? (item % pairs) * 2 : 0;
    float a[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r][0] = a[r][1] = 0.f;
    if (on)
      for (int c = part; c < blk; c += share) {
        float2 v = load2(vt + (size_t)c * hd + d);
        if (QUANT) {
          const float s = v_sc[c];
          v.x *= s;
          v.y *= s;
        }
        float p[R];
        load_rows<R>(p_s + c * gp + g0, p);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r][0] = fmaf(p[r], v.x, a[r][0]);
          a[r][1] = fmaf(p[r], v.y, a[r][1]);
        }
      }
    for (int o = share / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r][0] += __shfl_xor_sync(0xffffffffu, a[r][0], o);
        a[r][1] += __shfl_xor_sync(0xffffffffu, a[r][1], o);
      }
    }
    if (on && part == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (g0 + r < group) {
          float* acc = acc_s + (g0 + r) * hd + d;
          const float corr = corr_s[g0 + r];
          acc[0] = acc[0] * corr + a[r][0];
          acc[1] = acc[1] * corr + a[r][1];
        }
    }
  }
}

// Registers are held so that eight blocks fit an SM with one q row (64 a
// thread: a serving grid, 960 blocks at gpt2-small, runs in one wave) and
// five with more (as many as a long table's two-stage ring leaves room for).
template <typename T, typename KV, bool QUANT, int R>
__global__ void __launch_bounds__(THREADS, R == 1 ? 8 : 5) paged_decode_kernel(const Params P) {
  const int split = blockIdx.x, kvh = blockIdx.y, row = blockIdx.z;
  const int group = P.nh / P.nkv, hd = P.hd, blk = P.blk;
  const int tid = threadIdx.x;
  const Layout L = layout(group, hd, blk, (int)sizeof(KV), QUANT, P.pages_per_split, P.n_splits,
                          P.stages);
  extern __shared__ __align__(16) char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + group;
  float* corr_s = l_s + group;
  char* tiles = smem + L.tiles;
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(smem + L.valid);
  int* entry_s = reinterpret_cast<int*>(smem + L.pages);  // the split's table entries
  int* live_s = entry_s + P.pages_per_split;              // split-local index of each live page
  int* flag_s = live_s + P.pages_per_split;               // live page count; last-block flag

  // 1. the split's table entries, mask words and q group, all in flight together
  const int j0 = split * P.pages_per_split;
  const int n_pages = min(P.pages_per_split, P.n_tbl - j0);
  const size_t tbl0 = (size_t)row * P.n_tbl + j0;
  for (int i = tid; i < n_pages; i += THREADS) entry_s[i] = __ldg(P.table + tbl0 + i);
  for (int i = tid; i < n_pages * blk; i += THREADS) {
    const size_t m = tbl0 * blk + i;
    valid_s[i] = P.mask_bytes == 1 ? static_cast<const uint8_t*>(P.key_mask)[m] != 0
                                   : static_cast<const int32_t*>(P.key_mask)[m] != 0;
  }
  // q heads [kvh*group, (kvh+1)*group) of this slot are contiguous
  const T* q_row = static_cast<const T*>(P.q) + ((size_t)row * P.nh + (size_t)kvh * group) * hd;
  for (int i = tid; i < group * hd; i += THREADS) {
    q_s[i] = to_f32(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  // 2. the live pages in table order: an entry inside the arena with a valid column
  if (tid < 32) {
    int n_live = 0;
    for (int base = 0; base < n_pages; base += 32) {
      const int pg = base + tid;
      bool any = false;
      if (pg < n_pages && entry_s[pg] >= 0 && entry_s[pg] < P.n_blocks)
        for (int c = 0; c < blk && !any; ++c) any = valid_s[pg * blk + c] != 0;
      const unsigned live = __ballot_sync(0xffffffffu, any);
      if (any) live_s[n_live + __popc(live & ((1u << tid) - 1u))] = pg;
      n_live += __popc(live);
    }
    if (tid == 0) flag_s[0] = n_live;
  }
  __syncthreads();
  const int n_live = flag_s[0];

  // 3. the ring: `stages` pages in flight, one commit group each (empty
  // groups past the last page keep the count of pending groups fixed)
  const int S = P.stages;
  for (int t = 0; t < S; ++t) {
    if (t < n_live) stage_page<KV, QUANT, R>(P, kvh, entry_s[live_s[t]], tiles + t * L.stage);
    cp_async_commit();
  }
  for (int i = 0; i < n_live; ++i) {
    cp_async_wait_pending(S - 1);
    __syncthreads();
    char* st = tiles + (i % S) * L.stage;
    attend_page<KV, QUANT, R>(P, st, valid_s + live_s[i] * blk, group, q_s, p_s, acc_s, m_s, l_s, corr_s);
    __syncthreads();
    if (i + S < n_live) stage_page<KV, QUANT, R>(P, kvh, entry_s[live_s[i + S]], st);
    cp_async_commit();
  }

  T* o_row = static_cast<T*>(P.out) + ((size_t)row * P.nh + (size_t)kvh * group) * hd;
  if (P.n_splits == 1) {
    for (int i = tid; i < group * hd; i += THREADS) {
      const float l = l_s[i / hd];
      store_out(o_row + i, acc_s[i] / (l > 0.f ? l : 1.f));
    }
    return;
  }

  // 4. this split's (m, l, acc); the last block of the (slot, kv head) merges
  const size_t pair = (size_t)row * P.nkv + kvh;
  const int sf = stats_floats(group);
  const size_t rec = record_floats(group, hd);
  const float* parts = P.partial + pair * P.n_splits * rec;
  float* part = P.partial + (pair * P.n_splits + split) * rec;
  for (int g = tid; g < group; g += THREADS) {
    part[g] = m_s[g];
    part[group + g] = l_s[g];
  }
  if (n_live > 0)
    for (int i = tid; i < group * hd; i += THREADS) part[sf + i] = acc_s[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) flag_s[1] = atomicAdd(P.counters + pair, 1) == P.n_splits - 1;
  __syncthreads();
  if (!flag_s[1]) return;
  __threadfence();

  // every split's record into shared memory at once (the ring is idle now)
  float* recs = reinterpret_cast<float*>(tiles);
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(recs);
  for (int i = tid; i < (int)(P.n_splits * rec / 4); i += THREADS)
    cp_async16(dst + 16 * i, parts + 4 * i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* den_s = reinterpret_cast<float*>(smem + L.den);
  for (int g = tid; g < group; g += THREADS) {
    float m = NEG_INF;
    for (int s = 0; s < P.n_splits; ++s) m = fmaxf(m, recs[s * rec + g]);
    float den = 0.f;
    for (int s = 0; s < P.n_splits; ++s) {
      const float ms = recs[s * rec + g];
      // an empty split weighs exactly 0, and its acc (never written) is not used
      const float w = (ms <= NEG_INF / 2) ? 0.f : expf(ms - m);
      recs[s * rec + g] = w;
      den += w * recs[s * rec + group + g];
    }
    den_s[g] = den;
  }
  __syncthreads();
  for (int i = tid; i < group * hd; i += THREADS) {
    const int g = i / hd;
    float a = 0.f;
    for (int s = 0; s < P.n_splits; ++s) {
      const float w = recs[s * rec + g];
      if (w != 0.f) a = fmaf(w, recs[s * rec + sf + i], a);
    }
    const float den = den_s[g];
    store_out(o_row + i, a / (den > 0.f ? den : 1.f));
  }
  if (tid == 0) P.counters[pair] = 0;
}

template <typename T, typename KV, bool QUANT>
int launch(const Params& P, int b, cudaStream_t stream) {
  const int group = P.nh / P.nkv;
  const size_t smem = layout(group, P.hd, P.blk, (int)sizeof(KV), QUANT, P.pages_per_split,
                             P.n_splits, P.stages).total;
  // one kernel per rows_at_once(group), so a group of one keeps few registers
  auto kernel = group == 1 ? paged_decode_kernel<T, KV, QUANT, 1>
                : group == 2 ? paged_decode_kernel<T, KV, QUANT, 2>
                             : paged_decode_kernel<T, KV, QUANT, 4>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(P.n_splits, P.nkv, b), THREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kv(int kv_dtype, const Params& P, int b, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch<T, float, false>(P, b, stream);
    case 1: return launch<T, __nv_bfloat16, false>(P, b, stream);
    case 2: return launch<T, int8_t, true>(P, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int kv_bytes(int kv_dtype) { return kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1; }

}  // namespace

extern "C" {

// Floats of one split's record in the merge's scratch.
size_t trlx_paged_attention_record_floats(int group, int hd) { return record_floats(group, hd); }

// Dynamic shared memory one launch needs, in bytes.
size_t trlx_paged_attention_smem_bytes(int group, int hd, int blk, int kv_dtype, int pages_per_split,
                                       int n_splits, int stages) {
  return layout(group, hd, blk, kv_bytes(kv_dtype), kv_dtype == 2, pages_per_split, n_splits, stages)
      .total;
}

// q_dtype: 0 = f32, 1 = bf16 (also the output type).
// kv_dtype: 0 = f32, 1 = bf16, 2 = int8 with f32 scale planes.
// mask_bytes: 4 = int32 key mask, 1 = one byte (bool, uint8, int8).
// n_splits must be ceil(n_tbl / pages_per_split); with n_splits > 1,
// `partial` holds b * nkv * n_splits * trlx_paged_attention_record_floats
// floats (16-byte aligned) and `counters` b * nkv ints that are zero (the
// kernel leaves them zero).
// Returns the CUDA error of the launch (0 = success).
int trlx_paged_attention_decode(const void* q, const void* k_arena, const void* v_arena,
                                const void* k_scale, const void* v_scale, const void* table,
                                const void* key_mask, void* out, void* partial, void* counters,
                                int b, int nh, int nkv, int hd, int n_blocks, int blk, int n_tbl,
                                int pages_per_split, int n_splits, int stages, float scale,
                                int q_dtype, int kv_dtype, int mask_bytes, void* stream) {
  if (b <= 0 || b > 65535 || nkv <= 0 || nkv > 65535 || nh % nkv != 0 || n_tbl <= 0 || blk <= 0 ||
      hd <= 0 || hd % 8 != 0 || pages_per_split <= 0 ||
      n_splits != (n_tbl + pages_per_split - 1) / pages_per_split || stages < 1 ||
      stages > MAX_STAGES || (mask_bytes != 1 && mask_bytes != 4) ||
      (n_splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params P;
  P.q = q;
  P.k = k_arena;
  P.v = v_arena;
  P.k_scale = static_cast<const float*>(k_scale);
  P.v_scale = static_cast<const float*>(v_scale);
  P.table = static_cast<const int32_t*>(table);
  P.key_mask = key_mask;
  P.out = out;
  P.partial = static_cast<float*>(partial);
  P.counters = static_cast<int*>(counters);
  P.nh = nh;
  P.nkv = nkv;
  P.hd = hd;
  P.n_blocks = n_blocks;
  P.blk = blk;
  P.n_tbl = n_tbl;
  P.pages_per_split = pages_per_split;
  P.n_splits = n_splits;
  P.stages = stages;
  P.mask_bytes = mask_bytes;
  P.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return launch_kv<float>(kv_dtype, P, b, s);
    case 1: return launch_kv<__nv_bfloat16>(kv_dtype, P, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
