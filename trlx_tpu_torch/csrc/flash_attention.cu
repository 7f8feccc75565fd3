// Causal flash attention, forward and backward, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the four TPU kernels of trlx_tpu/ops/attention.py:
//   K3 `_flash_fwd_kernel`       -> flash_fwd_wgmma_kernel<HD, false> (bf16),
//                                   flash_fwd_kernel<HD, false> (f32)
//   K4 `_flash_fwd_kernel_lse`   -> flash_fwd_wgmma_kernel<HD, true> (bf16),
//                                   flash_fwd_kernel<HD, true> (f32)
//   K5 `_flash_bwd_dq_kernel`    -> flash_bwd_dq_wgmma_kernel<HD> (bf16),
//                                   flash_bwd_dq_kernel<HD> (f32)
//   K6 `_flash_bwd_dkv_kernel`   -> flash_bwd_dkv_wgmma_kernel<HD> (bf16),
//                                   flash_bwd_dkv_kernel<HD> (f32)
// The bf16 kernels run on the tensor cores at every head dim, with two
// warpgroups a block at 256; the f32 kernels on the CUDA cores.
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
// Semantics (both forward routes, and the backward): a key is allowed
// when its mask is set and, if causal, its index is <= the query's index.
// Scores of disallowed keys are NEG_INF = -1e30 and get exactly zero
// weight; the online-softmax shift is clamped as on the TPU, so a query
// with no allowed key (left padding, an empty row) writes exactly 0 and,
// in the LSE variant, lse = DEAD_LSE = 1e9. The backward relies on that:
// exp(s - 1e9) underflows to 0, so dead rows add nothing to dq/dk/dv.
//
// Forward, bf16: flash_fwd_wgmma_kernel<HD, LSE>, on the tensor cores.
// The TPU kernels cast bf16 q/k/v to f32 and compute two products:
// - q.k^T: a product of two bf16 values is exact in f32, so one bf16
//   wgmma with f32 accumulation forms the same products; only the order
//   of the f32 sums differs. The scale multiplies the f32 scores
//   afterwards, as on the TPU (for hd 32 it is not a power of two, so
//   folding it into a bf16 q would round differently).
// - p.V with p in f32: p is split as p_hi = bf16(p), p_lo = bf16(p - p_hi)
//   and O += p_hi.V + p_lo.V with two bf16 wgmmas. V is exact in bf16 and
//   p_hi + p_lo carries p to about 2^-17 relative error, far inside the
//   one-bf16-ulp agreement with the f32 plain version; dropping p_lo would
//   leave 2^-9. The row sum l is taken over the f32 p, not the split.
// - exp(s - shift) is ex2.approx(s * log2(e) - shift * log2(e)): s and the
//   running max stay in the TPU kernel's scaled domain, so lse = m + log(l)
//   keeps its form. A tile whose keys are all valid and at or below the
//   diagonal skips the per-element mask.
// One block is one warpgroup (128 threads) owning 64 query rows: S =
// Q.K^T is wgmma m64n64k16 with Q and a 64-key K tile read from shared
// memory (both K-major), and O += P.V is wgmma m64n{hd}k16 with P from
// registers (the S accumulator repacked to bf16 pairs) and V from shared
// memory as a transposed B ([key][hd], tnspB). Tiles are swizzled for
// wgmma (32, 64, 128, 2 x 128 and 4 x 128 bytes for hd 16, 32, 64, 128,
// 256; see wgmma.cuh). At hd 256 a block is two warpgroups (256 threads)
// owning the same 64 rows, each one 128-column half of O: a 64 x 128 f32
// accumulator, 64 registers a thread, as at hd 128 (one warpgroup's
// 64 x 256 would be 128). Each warpgroup forms all of S (16 m64n64k16 over
// the 256 columns) and runs the same online softmax, so the two hold the
// same m and l bitwise and need no exchange; that costs a third more
// tensor work on a forward bound by bytes (splitting the reduction instead
// would add 16 KB of shared memory, a barrier between the warpgroups and
// another order of the f32 sums). Its half then takes p_hi.V_h + p_lo.V_h
// with m64n128k16 from column block 2h of the V tile. Q (32 KB) and two
// K/V stages (128 KB) take about 161 KB of shared memory: one block an
// SM. K/V tiles come into a two-stage ring with 16-byte cp.async
// copies, so tile k + 1 loads while tile k computes; the ragged tail reads
// zeros. At the start the block reads its batch row's mask once into a
// bitmask of valid keys and skips every 64-key tile with no valid key, as
// well as the tiles above the causal diagonal. Both skips are exact: a
// tile with no allowed key leaves m, l and O unchanged under the clamped
// shift. A q tile with no valid key at all writes 0 (and DEAD_LSE)
// without entering the loop.
//
// Backward, bf16: flash_bwd_dq_wgmma_kernel<HD> (K5) and
// flash_bwd_dkv_wgmma_kernel<HD> (K6), on the tensor cores, two kernels as
// on the TPU (deterministic: no atomics on dq). The TPU kernels form five
// products from f32 casts of the bf16 inputs: s = q.k^T and dp = dO.v^T
// are products of two bf16 operands, exact in f32, so each is one bf16
// wgmma with f32 accumulation; dv = p^T.dO, dq = ds.k and dk = ds^T.q have
// the f32 p or ds as one operand, which is split into bf16 hi and lo
// halves as p is in the forward (two wgmmas, about 2^-17 relative error).
// p = exp(s * scale - lse) is ex2.approx(s * scale * log2(e) - lse *
// log2(e)), ds = p * (dp - delta) * scale in f32. K5: one warpgroup owns
// 64 q rows (lse and delta in registers) and loops over the live key tiles
// up to the diagonal from a two-stage cp.async K/V ring; S and dP are SS
// wgmmas (both K-major), dq += ds_hi.K + ds_lo.K reads the same K tile as
// an MN-major B; dq is written once, in bf16. K6: one warpgroup owns 64
// keys of one q head and loops over the q tiles from the diagonal on from
// a two-stage Q/dO ring (each stage with the tile's lse and delta, which
// are per column here); it computes the scores transposed, S^T = K.Q^T
// and dP^T = V.dO^T, so p^T and ds^T land in the accumulator layout that
// packs into A fragments, and dv += p^T_hi.dO + p^T_lo.dO, dk += ds^T_hi.Q
// + ds^T_lo.Q read the same Q and dO tiles as MN-major B. Padding is
// skipped exactly as in the forward: K5 skips key tiles with no valid key
// (a q tile with none writes 0), K6 writes 0 for a key tile with no valid
// key and does nothing else. At hd 256 a block of either kernel is two
// warpgroups (256 threads) owning the same 64 rows (q rows in K5, keys of
// one q head in K6), each one 128-column half of the output: K5's dq half
// is 64 registers a thread, K6's dk and dv halves 64 each, hd 128's
// picture (one warpgroup's 64 x 256 would be 128, two of them in K6). Each
// warpgroup forms all of S and dP (16 m64n64k16 each over the 256
// columns) and the same p and ds, bitwise equal in both since lse and delta
// are per row: no exchange. That is half again K5's tensor work and a
// third more of K6's; splitting the reduction would add about 32 KB of
// shared memory, a barrier between the warpgroups and another order of the
// f32 sums. Warpgroup h then reads column block 2h of the K tile (K5) or
// of the Q and dO tiles (K6) as an hd-128 MN-major B, m64n128k16, as the
// forward reads V. Q, dO and two K/V stages (K5), or K, V and two Q/dO
// stages (K6), take about 193 KB of shared memory: one block an SM. At
// gpt2-small training shapes the backward
// is bound by bytes: 0.019 ms (K5) and 0.030 ms (K6) at 3.35 TB/s, against
// 0.015 and 0.023 ms for its 4 and 6 tile products a pair at the bf16
// peak (chip_smoke.py `flash_bound`).
//
// Forward and backward, f32: flash_fwd_kernel<HD, LSE>,
// flash_bwd_dq_kernel<HD> and flash_bwd_dkv_kernel<HD> compute every
// product on the CUDA cores in f32. One block of 256 threads owns a
// 64-row tile (a q tile in the forward and dq kernels, a k tile in the
// dk/dv kernel) and loops over the other side's 64-row tiles (the TPU's
// sequential grid axis becomes this loop), with causal=1 skipping the
// tiles wholly above the diagonal. Tiles are staged in shared memory as f32 with one padding
// column, so the 16 threads of a half warp read 16 distinct banks. Thread
// (ty, tx) = (tid / 16, tid % 16) owns the 4 rows ty*4..ty*4+3 of the
// 64x64 score tile at columns tx + 16 j, and the same rows of the
// accumulator at columns tx + 16 jj: row statistics reduce over the 16
// lanes of a half warp with shuffles. The f32 forward runs its q tiles in
// reverse order, so the long causal rows start first.
//
// Head dim 256 (GPT-J-6B: d 4096 over 16 heads): the f32 kernels are the
// same CUDA-core kernels with 32-row tiles (2 rows and 2 score columns a
// thread), since 64-row f32 tiles of 256 columns overflow shared memory
// in dq and dk/dv. The bf16 kernels at hd 256 are the wgmma kernels above,
// with two warpgroups.
//
// Bound. At gpt2-small training shapes (b 8, t 1024, 12 heads, hd 64,
// bf16) the forward moves q, k, v and out once, about 50 MB: 0.0150 ms at
// 3.35 TB/s. Its products, 2 * 2 * hd flops per allowed (query, key) pair
// per head, take 0.0077 ms at the 989 TFLOP/s bf16 tensor-core peak for
// the pairs the main path's padding leaves (0.013 ms for full causal
// tiles), so it is bound by bytes (chip_smoke.py `flash_bound`). The bf16
// forward issues three products per pair (q.k^T, p_hi.V, p_lo.V).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float DEAD_LSE = 1e9f;
constexpr int THREADS = 256;
constexpr int TILE = 64;         // rows of a CUDA-core tile (q and k side) up to hd 128

// Rows of a CUDA-core tile (q and k side) for a head dim: 64, or 32 at
// hd 256, where the f32 staging of 64-row tiles would exceed the 227 KB of
// shared memory a block may take (dq 280 KB, dk/dv 297 KB). A thread owns
// rows ty * RI .. ty * RI + RI - 1 (RI = R / 16) of the R x R score tile
// at columns tx + 16 j, j < RI.
__host__ __device__ constexpr int tile_rows(int hd) { return hd > 128 ? 32 : TILE; }

// Sum / max over the 16 lanes of a half warp (lanes differing in bits 0-3).
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Stage rows [row0, row0 + R) of head `head` of a [batch, t, heads, HD]
// f32 tensor into dst[r * stride + d]; rows at or past t read 0.
template <int HD, int R = tile_rows(HD)>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src, int batch, int t,
                                           int heads, int head, int row0) {
  for (int idx = threadIdx.x; idx < R * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < t) x = src[(((size_t)batch * t + row) * heads + head) * HD + d];
    dst[r * stride + d] = x;
  }
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const int32_t* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, int nh, int nkv, int causal,
                     float scale) {
  constexpr int J = HD / 16;  // accumulator columns per thread
  constexpr int R = tile_rows(HD), RI = R / 16, RP = R + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [R][HD + 1]
  float* Ks = Qs + R * (HD + 1);  // [R][HD + 1]
  float* Vs = Ks + R * (HD + 1);  // [R][HD]
  float* Ps = Vs + R * HD;        // [R][RP]
  int* Ms = reinterpret_cast<int*>(Ps + R * RP);  // [R]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);

  stage_rows<HD>(Qs, HD + 1, q, bi, tq, nh, h, q0);

  float m[RI], l[RI], acc[RI][J];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + R) : tk;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<HD>(Ks, HD + 1, k, bi, tk, nkv, kvh, k0);
    stage_rows<HD>(Vs, HD, v, bi, tk, nkv, kvh, k0);
    if (tid < R) Ms[tid] = (k0 + tid < tk) ? mask[(size_t)bi * tk + k0 + tid] : 0;
    __syncthreads();

    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RI], kv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty * RI + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < RI; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty * RI + i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
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
      for (int j = 0; j < RI; ++j) {
        const float p = s[i][j] <= NEG_INF / 2 ? 0.f : expf(s[i][j] - shift);
        Ps[(ty * RI + i) * RP + tx + 16 * j] = p;
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
    for (int kk = 0; kk < R; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty * RI + i) * RP + kk];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float vv = Vs[kk * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    if (row >= tq) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    float* o = out + (((size_t)bi * tq + row) * nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) o[tx + 16 * jj] = acc[i][jj] / denom;
    if (LSE && tx == 0)
      lse[((size_t)bi * nh + h) * tq + row] = l[i] > 0.f ? m[i] + logf(denom) : DEAD_LSE;
  }
}

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_ROWS = 64;      // q rows of a block: wgmma's m64
constexpr int WG_KEYS = 64;      // keys of a K/V tile: S is m64n64
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (about 2 ulp; results below 2^-126
// flush to 0, where exp(s - shift) is negligible beside the row's 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 hi/lo A fragments of a 64 x 64 f32 tile x held in the accumulator
// layout: 16-column slice kk is registers 8 kk .. 8 kk + 7, and fragment
// register r of it packs the pair x[8 kk + 2 r], x[8 kk + 2 r + 1].
__device__ __forceinline__ void split_fragments(const float (&x)[32], uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = hopper::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
    }
}

// Q tile, two K and two V stages, the key-validity bitmask (two words per
// 64-key tile) and 1024 bytes to align the tiles for the swizzle.
size_t wgmma_fwd_smem(int hd, int tk) {
  return 1024 + 5 * (size_t)WG_ROWS * hd * 2 + 8 * (size_t)((tk + WG_KEYS - 1) / WG_KEYS);
}

// Warpgroups of a bf16 (wgmma) kernel's block: one up to hd 128; two at
// hd 256, each owning one 128-column half of the output (O, dq, or dk and
// dv: a 64 x 128 f32 accumulator, 64 registers a thread, as at hd 128).
__host__ __device__ constexpr int warpgroups(int hd) { return hd > 128 ? 2 : 1; }

template <int HD, bool LSE>
__global__ void __launch_bounds__(WG_THREADS * warpgroups(HD))
    flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ mask,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int tq, int tk,
                           int nh, int nkv, int causal, float scale) {
  using namespace hopper;
  constexpr int WGS = warpgroups(HD);
  constexpr int NT = WG_THREADS * WGS;  // threads of the block
  constexpr int OHD = HD / WGS;         // columns of O a warpgroup owns
  constexpr uint32_t TILE_BYTES = WG_ROWS * HD * 2;  // a bf16 tile of 64 rows
  constexpr uint32_t HALF_BYTES = WG_KEYS * OHD * 2;  // a warpgroup's column blocks of a V tile
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks of a row
  constexpr int NO = OHD / 2;     // output accumulator registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + TILE_BYTES, sV = base + 3 * TILE_BYTES;
  uint32_t* valid = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + 5 * TILE_BYTES);

  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup (the half of O at hd 256) and the warp inside it
  const int wg = WGS == 1 ? 0 : tid / WG_THREADS, warp = (WGS == 1 ? tid : tid % WG_THREADS) >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_ROWS;  // long causal rows first
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);
  const int k_end = causal ? min(tk, q0 + WG_ROWS) : tk;
  const int n_tiles = (k_end + WG_KEYS - 1) / WG_KEYS;

  // The batch row's mask, read once: bit i of word w is key 32 w + i.
  const int32_t* mrow = mask + (size_t)bi * tk;
  for (int w = tid >> 5; w < 2 * n_tiles; w += NT / 32) {
    const int key = w * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, key < k_end && mrow[key] > 0);
    if (lane == 0) valid[w] = bits;
  }
  __syncthreads();
  // first tile at or after j with a valid key (n_tiles if none); the same
  // answer in every thread
  auto next_live = [&](int j) {
    while (j < n_tiles && (valid[2 * j] | valid[2 * j + 1]) == 0u) ++j;
    return j;
  };

  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);                // and columns 8 j + col0 + {0, 1}
  int j = next_live(0);
  if (j == n_tiles) {  // no query of the tile has an allowed key
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < WG_ROWS * HD / 2; i += NT) {
      const int r = i / (HD / 2), c = 2 * (i % (HD / 2));
      if (q0 + r < tq)
        *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)bi * tq + q0 + r) * nh + h) * HD + c) = zero;
    }
    if (LSE && tid < WG_ROWS && q0 + tid < tq) lse[((size_t)bi * nh + h) * tq + q0 + tid] = DEAD_LSE;
    return;
  }

  const __nv_bfloat16* qh = q + ((size_t)bi * tq * nh + h) * HD;
  for (int i = tid; i < WG_ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = q0 + r < tq;
    cp_async16(sQ + tile_offset<HD>(WG_ROWS, r, c), qh + (size_t)(ok ? q0 + r : 0) * nh * HD + c * 8, ok);
  }
  cp_async_commit();

  const size_t kv_stride = (size_t)nkv * HD;
  const __nv_bfloat16* kh = k + ((size_t)bi * tk * nkv + kvh) * HD;
  const __nv_bfloat16* vh = v + ((size_t)bi * tk * nkv + kvh) * HD;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * WG_KEYS;
    for (int i = tid; i < WG_KEYS * CHUNKS; i += NT) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = k0 + r < tk;
      const size_t src = (size_t)(ok ? k0 + r : 0) * kv_stride + c * 8;
      const uint32_t dst = stage * TILE_BYTES + tile_offset<HD>(WG_KEYS, r, c);
      cp_async16(sK + dst, kh + src, ok);
      cp_async16(sV + dst, vh + src, ok);
    }
    cp_async_commit();
  };

  // Each warpgroup forms all of S and runs the same online softmax on it,
  // so both hold the same m and l bitwise; then each adds p.V into its own
  // OHD columns of O.
  float o[NO], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  int stage = 0;
  load_kv(j, 0);
  while (j < n_tiles) {
    const int jn = next_live(j + 1);
    if (jn < n_tiles) {
      load_kv(jn, stage ^ 1);  // in flight while this tile computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // tile j (and Q) landed for every thread

    const uint32_t kt = sK + stage * TILE_BYTES, vt = sV + stage * TILE_BYTES;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<HD>(sQ, WG_ROWS, kk), desc_kmajor<HD>(kt, WG_KEYS, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int k0 = j * WG_KEYS;
    const uint64_t bits = ((uint64_t)valid[2 * j + 1] << 32) | valid[2 * j];
    // every key of the tile valid and at or below every row's diagonal:
    // nothing to mask (the same branch in every thread)
    const bool whole = bits == ~0ull && (!causal || k0 + WG_KEYS - 1 <= q0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      float mc = NEG_INF;
      if (whole) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * jj + 2 * hh + e];
            x *= scale;
            mc = fmaxf(mc, x);
          }
      } else {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * jj + col0 + e;
            const bool ok = ((bits >> c) & 1u) && (!causal || k0 + c <= row);
            float& x = s[4 * jj + 2 * hh + e];
            x = ok ? x * scale : NEG_INF;
            mc = fmaxf(mc, x);
          }
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_new = fmaxf(m[hh], mc);
      const float shift = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float neg_shift2 = -shift * LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * jj + 2 * hh + e];
          x = x <= NEG_INF / 2 ? 0.f : fast_exp2(fmaf(x, LOG2E, neg_shift2));
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = m[hh] <= NEG_INF / 2 ? 0.f : fast_exp2((m[hh] - m_new) * LOG2E);
      l[hh] = l[hh] * corr + rs;
      m[hh] = m_new;
#pragma unroll
      for (int jj = 0; jj < OHD / 8; ++jj) {
        o[4 * jj + 2 * hh] *= corr;
        o[4 * jj + 2 * hh + 1] *= corr;
      }
    }

    uint32_t a_hi[4][4], a_lo[4][4];  // p as bf16 hi/lo A fragments
    split_fragments(s, a_hi, a_lo);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mnmajor<HD>(vt + wg * HALF_BYTES, WG_KEYS, kk);
      wgmma_rs<OHD>(o, a_hi[kk], dv);
      wgmma_rs<OHD>(o, a_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // every thread is done with this stage before it is refilled
    stage ^= 1;
    j = jn;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= tq) continue;
    const float denom = l[hh] > 0.f ? l[hh] : 1.f;
    __nv_bfloat16* orow = out + (((size_t)bi * tq + row) * nh + h) * HD + wg * OHD;
#pragma unroll
    for (int jj = 0; jj < OHD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(orow + 8 * jj + col0) =
          pack_bf16(o[4 * jj + 2 * hh] / denom, o[4 * jj + 2 * hh + 1] / denom);
    if (LSE && wg == 0 && (lane & 3) == 0)
      lse[((size_t)bi * nh + h) * tq + row] = l[hh] > 0.f ? m[hh] + logf(denom) : DEAD_LSE;
  }
}

// dq = sum over allowed keys of ds * k, with p = exp(s * scale - lse) and
// ds = p * (dp - delta) * scale, dp = dout . v (FlashAttention-2).
template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int32_t* __restrict__ mask,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int tq, int tk,
                        int nh, int nkv, int causal, float scale) {
  constexpr int J = HD / 16;
  constexpr int R = tile_rows(HD), RI = R / 16, RP = R + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [R][HD + 1]
  float* Os = Qs + R * (HD + 1);    // dout tile
  float* Ks = Os + R * (HD + 1);
  float* Vs = Ks + R * (HD + 1);
  float* Ds = Vs + R * (HD + 1);    // ds tile [R][RP]
  int* Ms = reinterpret_cast<int*>(Ds + R * RP);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);

  stage_rows<HD>(Qs, HD + 1, q, bi, tq, nh, h, q0);
  stage_rows<HD>(Os, HD + 1, dout, bi, tq, nh, h, q0);
  float lse_r[RI], delta_r[RI], acc[RI][J];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    const size_t at = ((size_t)bi * nh + h) * tq + row;
    lse_r[i] = row < tq ? lse[at] : DEAD_LSE;
    delta_r[i] = row < tq ? delta[at] : 0.f;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
  }

  const int k_end = causal ? min(tk, q0 + R) : tk;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();
    stage_rows<HD>(Ks, HD + 1, k, bi, tk, nkv, kvh, k0);
    stage_rows<HD>(Vs, HD + 1, v, bi, tk, nkv, kvh, k0);
    if (tid < R) Ms[tid] = (k0 + tid < tk) ? mask[(size_t)bi * tk + k0 + tid] : 0;
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RI], ov[RI], kv[RI], vv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty * RI + i) * (HD + 1) + d];
        ov[i] = Os[(ty * RI + i) * (HD + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty * RI + i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool ok = Ms[c] > 0 && (!causal || k0 + c <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        Ds[(ty * RI + i) * RP + c] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = Ds[(ty * RI + i) * RP + kk];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float kv = Ks[kk * (HD + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][jj] = fmaf(dsv[i], kv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    if (row >= tq) continue;
    float* o = dq + (((size_t)bi * tq + row) * nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) o[tx + 16 * jj] = acc[i][jj];
  }
}

// Per q head h and k tile: dv = sum over queries of p * dout and
// dk = sum of ds * q, in f32, written to the head's own slice.
template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int32_t* __restrict__ mask,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int tq, int tk, int nh, int nkv, int causal,
                         float scale) {
  constexpr int J = HD / 16;
  constexpr int R = tile_rows(HD), RI = R / 16, RP = R + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [R][HD + 1]
  float* Vs = Ks + R * (HD + 1);
  float* Qs = Vs + R * (HD + 1);
  float* Os = Qs + R * (HD + 1);    // dout tile
  float* Pt = Os + R * (HD + 1);    // p^T  [key][query], [R][RP]
  float* Dt = Pt + R * RP;          // ds^T
  float* Ls = Dt + R * RP;          // lse of the q tile [R]
  float* Es = Ls + R;               // delta of the q tile [R]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * R;
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);

  stage_rows<HD>(Ks, HD + 1, k, bi, tk, nkv, kvh, k0);
  stage_rows<HD>(Vs, HD + 1, v, bi, tk, nkv, kvh, k0);
  bool key_ok[RI];
  float dk_acc[RI][J], dv_acc[RI][J];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty * RI + i;
    key_ok[i] = key < tk && mask[(size_t)bi * tk + key] > 0;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;
  }

  // causal: only q tiles holding a row >= k0 can reach this k tile
  const int q_begin = causal ? (k0 / R) * R : 0;
  for (int q0 = q_begin; q0 < tq; q0 += R) {
    __syncthreads();
    stage_rows<HD>(Qs, HD + 1, q, bi, tq, nh, h, q0);
    stage_rows<HD>(Os, HD + 1, dout, bi, tq, nh, h, q0);
    if (tid < R) {
      const int row = q0 + tid;
      const size_t at = ((size_t)bi * nh + h) * tq + row;
      Ls[tid] = row < tq ? lse[at] : DEAD_LSE;
      Es[tid] = row < tq ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[RI], vv[RI], qv[RI], ov[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kv[i] = Ks[(ty * RI + i) * (HD + 1) + d];
        vv[i] = Vs[(ty * RI + i) * (HD + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        qv[j] = Qs[(tx + 16 * j) * (HD + 1) + d];
        ov[j] = Os[(tx + 16 * j) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int key = k0 + ty * RI + i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        const bool ok = key_ok[i] && row < tq && (!causal || key <= row);
        const float p = ok ? expf(s[i][j] * scale - Ls[c]) : 0.f;
        Pt[(ty * RI + i) * RP + c] = p;
        Dt[(ty * RI + i) * RP + c] = p * (dp[i][j] - Es[c]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < R; ++qq) {
      float pv[RI], dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pv[i] = Pt[(ty * RI + i) * RP + qq];
        dsv[i] = Dt[(ty * RI + i) * RP + qq];
      }
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float ov = Os[qq * (HD + 1) + tx + 16 * jj];
        const float qv = Qs[qq * (HD + 1) + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          dv_acc[i][jj] = fmaf(pv[i], ov, dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(dsv[i], qv, dk_acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty * RI + i;
    if (key >= tk) continue;
    const size_t base = (((size_t)bi * tk + key) * nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      dk[base + tx + 16 * jj] = dk_acc[i][jj];
      dv[base + tx + 16 * jj] = dv_acc[i][jj];
    }
  }
}

// Q and dO tiles, two K and two V stages, the key bitmask, alignment.
size_t wgmma_dq_smem(int hd, int tk) {
  return 1024 + 6 * (size_t)WG_ROWS * hd * 2 + 8 * (size_t)((tk + WG_KEYS - 1) / WG_KEYS);
}
// K and V tiles, two Q and two dO stages, two stages of the q tile's lse
// and delta (2 x 2 x 64 f32), the key tile's bitmask, alignment.
size_t wgmma_dkv_smem(int hd) { return 1024 + 6 * (size_t)WG_KEYS * hd * 2 + 4 * WG_ROWS * 4 + 8; }

// K5 at bf16: one warpgroup owns 64 q rows and loops over the live key
// tiles up to the diagonal: S = Q.K^T and dP = dO.V^T (SS, both K-major),
// then dq += ds_hi.K + ds_lo.K with the same K tile read as an MN-major B.
// lse and delta are per row: two registers each. At hd 256 two warpgroups
// own the same rows: each forms all of S, dP and ds (bitwise equal in
// both) and adds ds.K_h into its 128-column half of dq, K_h being column
// blocks 2h and 2h + 1 of the K tile.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS * warpgroups(HD))
    flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ mask,
                              const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int tq,
                              int tk, int nh, int nkv, int causal, float scale) {
  using namespace hopper;
  constexpr int WGS = warpgroups(HD);
  constexpr int NT = WG_THREADS * WGS;  // threads of the block
  constexpr int OHD = HD / WGS;         // columns of dq a warpgroup owns
  constexpr uint32_t TILE_BYTES = WG_ROWS * HD * 2;
  constexpr uint32_t HALF_BYTES = WG_KEYS * OHD * 2;  // a warpgroup's column blocks of a K tile
  constexpr int CHUNKS = HD / 8;
  constexpr int NA = OHD / 2;  // dq accumulator registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + TILE_BYTES, sK = base + 2 * TILE_BYTES,
                 sV = base + 4 * TILE_BYTES;
  uint32_t* valid = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + 6 * TILE_BYTES);

  // the warp inside its warpgroup, and the warpgroup (the half of dq at hd 256)
  const int tid = threadIdx.x, warp = (WGS == 1 ? tid : tid % WG_THREADS) >> 5, lane = tid & 31;
  const int wg = WGS == 1 ? 0 : tid / WG_THREADS;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_ROWS;  // long causal rows first
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);
  const int k_end = causal ? min(tk, q0 + WG_ROWS) : tk;
  const int n_tiles = (k_end + WG_KEYS - 1) / WG_KEYS;

  const int32_t* mrow = mask + (size_t)bi * tk;
  for (int w = tid >> 5; w < 2 * n_tiles; w += NT / 32) {
    const int key = w * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, key < k_end && mrow[key] > 0);
    if (lane == 0) valid[w] = bits;
  }
  __syncthreads();
  auto next_live = [&](int j) {
    while (j < n_tiles && (valid[2 * j] | valid[2 * j + 1]) == 0u) ++j;
    return j;
  };

  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);                // and key columns 8 j + col0 + {0, 1}
  int j = next_live(0);
  if (j == n_tiles) {  // no row of the tile has an allowed key: dq is 0
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < WG_ROWS * HD / 2; i += NT) {
      const int r = i / (HD / 2), c = 2 * (i % (HD / 2));
      if (q0 + r < tq)
        *reinterpret_cast<__nv_bfloat162*>(dq + (((size_t)bi * tq + q0 + r) * nh + h) * HD + c) = zero;
    }
    return;
  }

  const size_t q_stride = (size_t)nh * HD;
  const __nv_bfloat16* qh = q + ((size_t)bi * tq * nh + h) * HD;
  const __nv_bfloat16* oh = dout + ((size_t)bi * tq * nh + h) * HD;
  for (int i = tid; i < WG_ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = q0 + r < tq;
    const size_t src = (size_t)(ok ? q0 + r : 0) * q_stride + c * 8;
    cp_async16(sQ + tile_offset<HD>(WG_ROWS, r, c), qh + src, ok);
    cp_async16(sO + tile_offset<HD>(WG_ROWS, r, c), oh + src, ok);
  }
  cp_async_commit();

  const size_t kv_stride = (size_t)nkv * HD;
  const __nv_bfloat16* kh = k + ((size_t)bi * tk * nkv + kvh) * HD;
  const __nv_bfloat16* vh = v + ((size_t)bi * tk * nkv + kvh) * HD;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * WG_KEYS;
    for (int i = tid; i < WG_KEYS * CHUNKS; i += NT) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = k0 + r < tk;
      const size_t src = (size_t)(ok ? k0 + r : 0) * kv_stride + c * 8;
      const uint32_t dst = stage * TILE_BYTES + tile_offset<HD>(WG_KEYS, r, c);
      cp_async16(sK + dst, kh + src, ok);
      cp_async16(sV + dst, vh + src, ok);
    }
    cp_async_commit();
  };

  // rows past tq: lse = DEAD_LSE makes p = 0 (their q and dO rows read 0)
  float nl2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const size_t at = ((size_t)bi * nh + h) * tq + row;
    nl2[hh] = -(row < tq ? lse[at] : DEAD_LSE) * LOG2E;
    dl[hh] = row < tq ? delta[at] : 0.f;
  }
  const float sl2 = scale * LOG2E;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  int stage = 0;
  load_kv(j, 0);
  while (j < n_tiles) {
    const int jn = next_live(j + 1);
    if (jn < n_tiles) {
      load_kv(jn, stage ^ 1);  // in flight while this tile computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // tile j (and Q, dO) landed for every thread

    const uint32_t kt = sK + stage * TILE_BYTES, vt = sV + stage * TILE_BYTES;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<HD>(sQ, WG_ROWS, kk), desc_kmajor<HD>(kt, WG_KEYS, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<HD>(sO, WG_ROWS, kk), desc_kmajor<HD>(vt, WG_KEYS, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // s is ready; dp may still be in flight
    fence_regs(s);

    const int k0 = j * WG_KEYS;
    const uint64_t bits = ((uint64_t)valid[2 * j + 1] << 32) | valid[2 * j];
    // every key valid and at or below every row's diagonal: no mask
    const bool whole = bits == ~0ull && (!causal || k0 + WG_KEYS - 1 <= q0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jj + col0 + e;
          const bool ok = whole || (((bits >> c) & 1u) && (!causal || k0 + c <= row0 + 8 * hh));
          float& x = s[4 * jj + 2 * hh + e];
          x = ok ? fast_exp2(fmaf(x, sl2, nl2[hh])) : 0.f;  // p
        }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * hh + e;
          dp[i] = s[i] * (dp[i] - dl[hh]) * scale;  // ds
        }

    uint32_t d_hi[4][4], d_lo[4][4];
    split_fragments(dp, d_hi, d_lo);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bk = desc_mnmajor<HD>(kt + wg * HALF_BYTES, WG_KEYS, kk);
      wgmma_rs<OHD>(acc, d_hi[kk], bk);
      wgmma_rs<OHD>(acc, d_lo[kk], bk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every thread is done with this stage before it is refilled
    stage ^= 1;
    j = jn;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= tq) continue;
    __nv_bfloat16* drow = dq + (((size_t)bi * tq + row) * nh + h) * HD + wg * OHD;
#pragma unroll
    for (int jj = 0; jj < OHD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(drow + 8 * jj + col0) =
          pack_bf16(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
  }
}

// K6 at bf16: one warpgroup owns 64 keys of one q head and loops over the
// q tiles from the diagonal on, with the scores transposed: S^T = K.Q^T
// and dP^T = V.dO^T (SS, both K-major), so p^T and ds^T come out in the
// accumulator layout, which is an A operand after packing; then
// dv += p^T_hi.dO + p^T_lo.dO and dk += ds^T_hi.Q + ds^T_lo.Q read the
// same Q and dO tiles as MN-major B. lse and delta are per column: each q
// tile's 64 values come into shared memory beside the tile. At hd 256 two
// warpgroups own the same keys: each forms all of S^T, dP^T, p^T and ds^T
// (bitwise equal in both) and adds p^T.dO_h and ds^T.Q_h into its
// 128-column halves of dv and dk, dO_h and Q_h being column blocks 2h and
// 2h + 1 of the dO and Q tiles.
template <int HD>
__global__ void __launch_bounds__(WG_THREADS * warpgroups(HD))
    flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ mask,
                               const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, float* __restrict__ dk,
                               float* __restrict__ dv, int tq, int tk, int nh, int nkv, int causal,
                               float scale) {
  using namespace hopper;
  constexpr int WGS = warpgroups(HD);
  constexpr int NT = WG_THREADS * WGS;  // threads of the block
  constexpr int OHD = HD / WGS;         // columns of dk and dv a warpgroup owns
  constexpr uint32_t TILE_BYTES = WG_KEYS * HD * 2;
  constexpr uint32_t HALF_BYTES = WG_ROWS * OHD * 2;  // a warpgroup's column blocks of a Q or dO tile
  constexpr int CHUNKS = HD / 8;
  constexpr int NA = OHD / 2;  // registers of each of the dk and dv accumulators
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + TILE_BYTES, sQ = base + 2 * TILE_BYTES,
                 sO = base + 4 * TILE_BYTES, sRows = base + 6 * TILE_BYTES;
  // per stage: lse [64], then delta [64]
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + (sRows - raw));
  uint32_t* valid = reinterpret_cast<uint32_t*>(smem_raw + (sRows - raw) + 4 * WG_ROWS * 4);

  // the warp inside its warpgroup, and the warpgroup (the half of dk and dv at hd 256)
  const int tid = threadIdx.x, warp = (WGS == 1 ? tid : tid % WG_THREADS) >> 5, lane = tid & 31;
  const int wg = WGS == 1 ? 0 : tid / WG_THREADS;
  const int k0 = blockIdx.x * WG_KEYS;  // key tile 0 has the most q tiles: it starts first
  const int bi = blockIdx.y / nh, h = blockIdx.y % nh;
  const int kvh = h / (nh / nkv);
  if (const int w = tid >> 5; w < 2) {  // warps 0 and 1: the tile's two words
    const int key = k0 + w * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, key < tk && mask[(size_t)bi * tk + key] > 0);
    if (lane == 0) valid[w] = bits;
  }
  __syncthreads();
  const uint64_t bits = ((uint64_t)valid[1] << 32) | valid[0];
  const int n_q = (tq + WG_ROWS - 1) / WG_ROWS;
  const int i_begin = causal ? k0 / WG_ROWS : 0;  // the first q tile holding a row >= k0

  if (bits == 0ull || i_begin >= n_q) {  // no allowed pair: dk and dv are 0
    for (int i = tid; i < WG_KEYS * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      if (k0 + r < tk) {
        const size_t at = (((size_t)bi * tk + k0 + r) * nh + h) * HD + c;
        dk[at] = 0.f;
        dv[at] = 0.f;
      }
    }
    return;
  }

  const size_t kv_stride = (size_t)nkv * HD;
  const __nv_bfloat16* kh = k + ((size_t)bi * tk * nkv + kvh) * HD;
  const __nv_bfloat16* vh = v + ((size_t)bi * tk * nkv + kvh) * HD;
  for (int i = tid; i < WG_KEYS * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = k0 + r < tk;
    const size_t src = (size_t)(ok ? k0 + r : 0) * kv_stride + c * 8;
    cp_async16(sK + tile_offset<HD>(WG_KEYS, r, c), kh + src, ok);
    cp_async16(sV + tile_offset<HD>(WG_KEYS, r, c), vh + src, ok);
  }
  cp_async_commit();

  const size_t q_stride = (size_t)nh * HD;
  const __nv_bfloat16* qh = q + ((size_t)bi * tq * nh + h) * HD;
  const __nv_bfloat16* oh = dout + ((size_t)bi * tq * nh + h) * HD;
  const float* lrow = lse + ((size_t)bi * nh + h) * tq;
  const float* erow = delta + ((size_t)bi * nh + h) * tq;
  // rows past tq read zeros (q, dO, lse and delta) and are masked below;
  // threads 0-63 copy the tile's lse, threads 64-127 its delta
  auto load_q = [&](int tile, int stage) {
    const int q0 = tile * WG_ROWS;
    for (int i = tid; i < WG_ROWS * CHUNKS; i += NT) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool ok = q0 + r < tq;
      const size_t src = (size_t)(ok ? q0 + r : 0) * q_stride + c * 8;
      const uint32_t dst = stage * TILE_BYTES + tile_offset<HD>(WG_ROWS, r, c);
      cp_async16(sQ + dst, qh + src, ok);
      cp_async16(sO + dst, oh + src, ok);
    }
    if (WGS == 1 || tid < 2 * WG_ROWS) {
      const int r = tid % WG_ROWS;
      const bool ok = q0 + r < tq;
      cp_async4(sRows + (uint32_t)(stage * 2 * WG_ROWS + tid) * 4,
                (tid < WG_ROWS ? lrow : erow) + (ok ? q0 + r : 0), ok);
    }
    cp_async_commit();
  };

  const int kr0 = warp * 16 + (lane >> 2);  // this thread's keys: k0 + kr0, k0 + kr0 + 8
  const int col0 = 2 * (lane & 3);          // and q columns 8 j + col0 + {0, 1}
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) key_ok[hh] = (bits >> (kr0 + 8 * hh)) & 1u;
  const float sl2 = scale * LOG2E;

  float acc_k[NA], acc_v[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc_k[i] = acc_v[i] = 0.f;

  int stage = 0;
  load_q(i_begin, 0);
  for (int it = i_begin; it < n_q; ++it) {
    if (it + 1 < n_q) {
      load_q(it + 1, stage ^ 1);  // in flight while this tile computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // q tile `it` (and K, V) landed for every thread

    const uint32_t qt = sQ + stage * TILE_BYTES, ot = sO + stage * TILE_BYTES;
    const float* ls = rows_f + stage * 2 * WG_ROWS;
    const float* es = ls + WG_ROWS;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<HD>(sK, WG_KEYS, kk), desc_kmajor<HD>(qt, WG_ROWS, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<HD>(sV, WG_KEYS, kk), desc_kmajor<HD>(ot, WG_ROWS, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // s^T is ready; dp^T may still be in flight
    fence_regs(s);

    const int q0 = it * WG_ROWS;
    // every key valid, every row real and at or past every key: no mask
    const bool whole = bits == ~0ull && q0 + WG_ROWS <= tq && (!causal || k0 + WG_KEYS - 1 <= q0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + col0;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = q0 + c + e, key = k0 + kr0 + 8 * hh;
          const bool ok = whole || (key_ok[hh] && row < tq && (!causal || key <= row));
          float& x = s[4 * jj + 2 * hh + e];
          x = ok ? fast_exp2(fmaf(x, sl2, -(e ? l2.y : l2.x) * LOG2E)) : 0.f;  // p^T
        }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 d2 = *reinterpret_cast<const float2*>(es + 8 * jj + col0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * hh + e;
          dp[i] = s[i] * (dp[i] - (e ? d2.y : d2.x)) * scale;  // ds^T
        }
    }

    uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
    split_fragments(s, p_hi, p_lo);
    split_fragments(dp, d_hi, d_lo);
    fence_regs(acc_k);
    fence_regs(acc_v);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = desc_mnmajor<HD>(ot + wg * HALF_BYTES, WG_ROWS, kk),
                     bq = desc_mnmajor<HD>(qt + wg * HALF_BYTES, WG_ROWS, kk);
      wgmma_rs<OHD>(acc_v, p_hi[kk], bo);
      wgmma_rs<OHD>(acc_v, p_lo[kk], bo);
      wgmma_rs<OHD>(acc_k, d_hi[kk], bq);
      wgmma_rs<OHD>(acc_k, d_lo[kk], bq);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);
    __syncthreads();  // every thread is done with this stage before it is refilled
    stage ^= 1;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kr0 + 8 * hh;
    if (key >= tk) continue;
    const size_t at = (((size_t)bi * tk + key) * nh + h) * HD + wg * OHD + col0;
#pragma unroll
    for (int jj = 0; jj < OHD / 8; ++jj) {
      *reinterpret_cast<float2*>(dk + at + 8 * jj) = make_float2(acc_k[4 * jj + 2 * hh], acc_k[4 * jj + 2 * hh + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * jj) = make_float2(acc_v[4 * jj + 2 * hh], acc_v[4 * jj + 2 * hh + 1]);
    }
  }
}

size_t fwd_smem(int hd) {
  const size_t r = tile_rows(hd);
  return (2 * r * (hd + 1) + r * hd + r * (r + 1)) * sizeof(float) + r * sizeof(int);
}
size_t dq_smem(int hd) {
  const size_t r = tile_rows(hd);
  return (4 * r * (hd + 1) + r * (r + 1)) * sizeof(float) + r * sizeof(int);
}
size_t dkv_smem(int hd) {
  const size_t r = tile_rows(hd);
  return (4 * r * (hd + 1) + 2 * r * (r + 1) + 2 * r) * sizeof(float);
}

// The route: every bf16 kernel runs on the tensor cores (wgmma) at every
// head dim, with two warpgroups at 256; every f32 kernel on the CUDA cores.
template <typename T>
constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// cp.async moves 16-byte chunks: every row of the bf16 operands starts
// 16-byte aligned when the base pointers do (a row is hd * 2 >= 32 bytes)
bool misaligned(const void* a, const void* b, const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15u) != 0;
}

template <int HD, bool LSE>
int fwd_wgmma(const void* q, const void* k, const void* v, const int32_t* mask, void* out,
              float* lse, int b, int tq, int tk, int nh, int nkv, int causal, float scale,
              cudaStream_t s) {
  if (misaligned(q, k, v, out)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = wgmma_fwd_smem(HD, tk);
  auto kernel = flash_fwd_wgmma_kernel<HD, LSE>;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((tq + WG_ROWS - 1) / WG_ROWS, b * nh);
  kernel<<<grid, WG_THREADS * warpgroups(HD), smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), lse, tq, tk,
      nh, nkv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, const int32_t* mask, void* out, float* lse,
        int b, int tq, int tk, int nh, int nkv, int causal, float scale, cudaStream_t s) {
  if constexpr (is_bf16<T>()) {
    if (lse != nullptr)
      return fwd_wgmma<HD, true>(q, k, v, mask, out, lse, b, tq, tk, nh, nkv, causal, scale, s);
    return fwd_wgmma<HD, false>(q, k, v, mask, out, nullptr, b, tq, tk, nh, nkv, causal, scale, s);
  } else {  // CUDA cores, f32
    const size_t smem = fwd_smem(HD);
    const dim3 grid((tq + tile_rows(HD) - 1) / tile_rows(HD), b * nh);
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    if (lse != nullptr) {
      auto kernel = flash_fwd_kernel<HD, true>;
      if (int err = prepare(kernel, smem)) return err;
      kernel<<<grid, THREADS, smem, s>>>(qf, kf, vf, mask, static_cast<float*>(out), lse, tq, tk, nh, nkv,
                                         causal, scale);
    } else {
      auto kernel = flash_fwd_kernel<HD, false>;
      if (int err = prepare(kernel, smem)) return err;
      kernel<<<grid, THREADS, smem, s>>>(qf, kf, vf, mask, static_cast<float*>(out), nullptr, tq, tk, nh,
                                         nkv, causal, scale);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T, int HD>
int bwd_dq(const void* q, const void* k, const void* v, const int32_t* mask, const void* dout,
           const float* lse, const float* delta, void* dq, int b, int tq, int tk, int nh, int nkv,
           int causal, float scale, cudaStream_t s) {
  if constexpr (is_bf16<T>()) {
    if (misaligned(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
    const size_t smem = wgmma_dq_smem(HD, tk);
    auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
    if (int err = prepare(kernel, smem)) return err;
    const dim3 grid((tq + WG_ROWS - 1) / WG_ROWS, b * nh);
    kernel<<<grid, WG_THREADS * warpgroups(HD), smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<const __nv_bfloat16*>(dout), lse,
        delta, static_cast<__nv_bfloat16*>(dq), tq, tk, nh, nkv, causal, scale);
    return (int)cudaGetLastError();
  } else {  // CUDA cores, f32
    const size_t smem = dq_smem(HD);
    auto kernel = flash_bwd_dq_kernel<HD>;
    if (int err = prepare(kernel, smem)) return err;
    const dim3 grid((tq + tile_rows(HD) - 1) / tile_rows(HD), b * nh);
    kernel<<<grid, THREADS, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), mask, static_cast<const float*>(dout),
                                       lse, delta, static_cast<float*>(dq), tq, tk, nh, nkv, causal,
                                       scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, int HD>
int bwd_dkv(const void* q, const void* k, const void* v, const int32_t* mask, const void* dout,
            const float* lse, const float* delta, float* dk, float* dv, int b, int tq, int tk,
            int nh, int nkv, int causal, float scale, cudaStream_t s) {
  if constexpr (is_bf16<T>()) {
    if (misaligned(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
    const size_t smem = wgmma_dkv_smem(HD);
    auto kernel = flash_bwd_dkv_wgmma_kernel<HD>;
    if (int err = prepare(kernel, smem)) return err;
    const dim3 grid((tk + WG_KEYS - 1) / WG_KEYS, b * nh);
    kernel<<<grid, WG_THREADS * warpgroups(HD), smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<const __nv_bfloat16*>(dout), lse,
        delta, dk, dv, tq, tk, nh, nkv, causal, scale);
    return (int)cudaGetLastError();
  } else {  // CUDA cores, f32
    const size_t smem = dkv_smem(HD);
    auto kernel = flash_bwd_dkv_kernel<HD>;
    if (int err = prepare(kernel, smem)) return err;
    const dim3 grid((tk + tile_rows(HD) - 1) / tile_rows(HD), b * nh);
    kernel<<<grid, THREADS, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), mask, static_cast<const float*>(dout),
                                       lse, delta, dk, dv, tq, tk, nh, nkv, causal, scale);
    return (int)cudaGetLastError();
  }
}

// Dispatch on (dtype code, head_dim): 0 = f32, 1 = bf16; hd in {16, 32,
// 64, 128, 256} (the route by is_bf16).
#define TRLX_FLASH_DISPATCH(FN, ...)                                         \
  switch (dtype * 1000 + hd) {                                               \
    case 16: return FN<float, 16>(__VA_ARGS__);                              \
    case 32: return FN<float, 32>(__VA_ARGS__);                              \
    case 64: return FN<float, 64>(__VA_ARGS__);                              \
    case 128: return FN<float, 128>(__VA_ARGS__);                            \
    case 256: return FN<float, 256>(__VA_ARGS__);                            \
    case 1016: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                    \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                    \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                    \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                   \
    case 1256: return FN<__nv_bfloat16, 256>(__VA_ARGS__);                   \
    default: return (int)cudaErrorInvalidValue;                              \
  }

bool bad_shape(int b, int tq, int tk, int nh, int nkv) {
  return b <= 0 || tq <= 0 || tk <= 0 || nkv <= 0 || nh % nkv != 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the CUDA-core kernels, in bytes:
// which = 0 forward (f32), 1 dq, 2 dk/dv.
size_t trlx_flash_smem_bytes(int which, int hd) {
  return which == 0 ? fwd_smem(hd) : which == 1 ? dq_smem(hd) : dkv_smem(hd);
}

// 1 when kernel `which` (0 forward, 1 dq, 2 dk/dv) runs on the tensor
// cores at this dtype code and head dim, 0 when on the CUDA cores: every
// bf16 kernel takes the tensor cores at every head dim, every f32 kernel
// the CUDA cores.
int trlx_flash_on_tensor_cores(int which, int dtype, int hd) { return dtype == 1 ? 1 : 0; }

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
