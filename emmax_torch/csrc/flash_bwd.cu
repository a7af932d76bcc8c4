// Flash-attention backward for Hopper (sm_90a), bound with ctypes.
//
// Replaces: the Pallas TPU kernels of `_flash_bwd`
// (emmax_tpu/ops/flash_attention.py:346-464): `_dq_kernel` (:228-275,
// pallas_call at :395) and `_dkv_kernel` (:278-343, pallas_call at :445)
// with its `fused_bwd` variant, which also writes per-kv-tile fp32 dQ
// partials that the caller sums (:461-463).
//
// What it computes, per (batch, head), from the forward's saved log-sum-exp
// `lse` and `di = rowsum(o * do)` (both fp32 [B, Lq, H]):
//   p  = exp(s - lse) with s = q k^T * sm_scale, exactly 0 where masked
//   dp = do v^T                       (fp32)
//   ds = p * (dp - di) * sm_scale, rounded to the inputs' dtype
//   dq = ds k,  dk = ds^T q,  dv = p^T do   (fp32 sums)
// with the forward's masking: causal at a scalar `q_offset`, an optional
// [B, S] slot mask, keys past S and queries past Lq. The layout is the
// model's [B, L, H, D] with any row/head/batch strides (unit stride on D).
// No atomics: every output element has one writer, so a gradient is the
// same bits from run to run.
//
// What bounds it on the H100: per valid (query, key) pair dQ does 6*D and
// dK/dV 8*D operations (s and dp are recomputed by both), against
// (4*Lq + 4*S)*D*2 bytes per head at bf16: at the training shape (fused
// length 448, D 128) ~300 operations per byte, at the tensor cores'
// ridge, so bf16 is bound by the 989 TFLOP/s tensor-core rate.
//
// bf16: tensor-core kernels (namespace `tc`), FlashAttention-2's backward
// in JAX's two-kernel form, on mma.sync m16n8k16 (csrc/mma.cuh). Blocks of
// 4 warps; Q/dO/K/V tiles are held in bf16 in XOR-swizzled shared memory,
// loaded with 16-byte cp.async where rows allow it (D % 8 == 0, strides
// and bases 16-byte aligned; element loads otherwise) and double-buffered
// so the next tile's loads overlap this tile's products. D is zero-padded
// on-chip to a multiple of 16 (DP = 64, 80, 112 or 128) for the products'
// K dimension.
// - `flash_bwd_dq`: one block per (64 query rows, head, batch) walks the
//   64-key tiles up to the causal diagonal; each warp owns 16 query rows:
//   S = Q K^T, P, dP = dO V^T, dS, then dQ += dS K with dS's accumulator
//   fragments reused as A fragments and K read through ldmatrix.trans.
// - `flash_bwd_dkv`: one block per (64 keys, head, batch) walks the
//   32-query tiles that can see it; each warp owns 16 keys:
//   S^T = K Q^T, P^T, dV += P^T dO (P^T's fragments rounded to bf16 in
//   registers), dP^T = V dO^T, dS^T, dK += dS^T Q. FUSED also puts dS^T
//   in shared memory and writes this kv tile's dQ partial dS K (dS and K
//   through ldmatrix.trans) into fp32 [n_kv_tiles, B, Lq, H, D], zeros for
//   the q tiles it skips.
// Both launch their heaviest causal tiles first (the tile index is the
// grid's slowest axis): the last q tile sees every key, kv tile 0 every
// query.
// One rounding more than JAX: the tensor cores take P in bf16 for
// dV = P^T dO, where JAX keeps it in fp32, a relative rounding of at most
// 2^-9 per term. Every other product has bf16-exact operands and fp32
// sums, as JAX's dot_general on the same values.
//
// fp32: tensor-core kernels (namespace `tf32`), the same two-kernel
// FlashAttention-2 backward on mma.sync m16n8k8 with tf32 operands, in
// 3xTF32 as the fp32 forward (csrc/flash_fwd.cu): every operand x is split
// as big = rna(x), small = rna(x - big) (csrc/mma.cuh's split_tf32) and
// each of the five products (S, dP, dQ, dV, dK) is taken as small*big +
// big*small + big*big into fp32 accumulators, which keeps fp32's accuracy
// (one TF32 product alone is ~5e-4 off). P and dS are computed in fp32 in
// registers and split there. A C fragment of m16n8 gives a lane columns
// 2t, 2t + 1 where a tf32 A fragment wants k t, t + 4, so P's / dS's C
// fragments feed the next product as A fragments unmoved and the other
// operand's k rows are read in that permuted order (k t <-> row 2t,
// k t + 4 <-> row 2t + 1). fp32 rows sit in shared memory padded to DP + 4
// floats (DP = 64, 72 or 128), so the 32-bit fragment reads (rows g,
// columns t; or rows 2t, columns g) hit 32 banks; tiles are loaded with
// 16-byte cp.async where rows allow it (D % 4 == 0, strides and bases
// 16-byte aligned; 4-byte cp.async otherwise) and double-buffered. A tile
// that several warps read for B fragments (each K/V stage of dQ, each
// Q/dO tile of dK/dV) is split once when it lands, big in place and small
// beside it; a tile that one warp reads as A fragments is split as it is
// read. At the towers' shapes these kernels measured latency-bound (time
// in waves of blocks, not in MMAs), so the layouts aim at warps per SM.
// Blocks of 4 warps:
// - `flash_bwd_dq`: one block per (32 query rows, head, batch), as the
//   fp32 forward: warps 0 and 1 (16 rows each) take the first 16 keys of
//   each 32-key stage, warps 2 and 3 the other 16, and the second half's
//   dQ is added to the first's at the end; 3 blocks an SM at DP <= 72.
// - `flash_bwd_dkv`: at DP <= 72 one block per (32 keys, head, batch),
//   two warps to each 16 keys, which split each 32-row query tile's 8-row
//   n-tiles and add their dK/dV at the end (3 blocks an SM); at DP 128,
//   and when FUSED, one block per 64 keys, one warp to each 16. FUSED puts
//   dS^T in fp32 shared memory and writes the dQ partial of each q tile,
//   as the bf16 kernel does.
// The masking, the exact zeros, the tile order and the fused partials'
// layout are the bf16 kernels'. Bound: per valid (query, key) pair dQ does
// 6*D and dK/dV 8*D fp32 operations, three TF32 products each on the
// tensor cores (at the towers' shapes ~0.005 and ~0.007 ms at 495 TFLOP/s
// against ~0.013 and ~0.017 ms for one product at the 67 TFLOP/s of fp32
// FMAs).

#include "common.cuh"
#include "mma.cuh"
#include "tc_tile.cuh"
#include "tf32_tile.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // [B, Lq, H]
  const float* di;    // [B, Lq, H]
  const uint8_t* mask;
  void* dq;
  void* dk;
  void* dv;
  float* dq_part;     // FUSED: [n_kv_tiles, B, Lq, H, D]
  int B, H, Lq, S, D;
  // strides in elements: (batch, row, head) of q, k, v, do, dq, dk, dv;
  // then the mask's batch stride
  long long st[22];
  int causal, q_offset;
  float sm_scale;
  int vec;            // rows allow 16-byte loads (bf16 kernels)
};

__device__ __forceinline__ bool visible(const Args& a, const uint8_t* mb,
                                        int qi, int kj) {
  if (qi >= a.Lq || kj >= a.S) return false;
  if (mb && mb[kj] == 0) return false;
  return !a.causal || kj <= a.q_offset + qi;
}

// ---------------------------------------------------- 3xTF32 (fp32) ---

namespace tf32 {

using emmax::mma::cp_async_commit;
using emmax::mma::cp_async_wait;
using emmax::mma::mma_1688_tf32;
using emmax::mma::split_tf32;
using emmax::tc::key_ok;
using emmax::tf32::bits;
using emmax::tf32::load_a;
using emmax::tf32::load_tile;
using emmax::tf32::row_len;
using emmax::tf32::split_tile;

constexpr int NW = 4;            // warps per block
constexpr int NTH = 32 * NW;     // threads per block
constexpr int DQ_BQ = 32;        // dQ: query rows per block, 16 per warp
constexpr int DQ_KW = 16;        // dQ: keys per warp and stage
constexpr int DQ_BK = 2 * DQ_KW; // dQ: keys per K/V stage
constexpr int KV_BQ = 32;        // dK/dV: query rows per stage
constexpr int BWD_KV_TILE = 64;  // keys per fused dQ partial
constexpr int DS_LD = KV_BQ + 4; // FUSED dS^T rows in shared: the A-fragment
                                 // reads (rows 2t, 2t + 1, columns g) hit
                                 // 32 banks
constexpr float LOG2E = 1.4426950408889634f;

// dK/dV: keys per block. 32 at DP <= 72, two warps to each 16 keys, so
// the towers' shapes put 3 blocks (12 warps) on an SM; 64 at DP 128 (a
// 32-key block would split every Q/dO tile for half the keys) and when
// FUSED (the dQ partials are per 64 keys)
template <int DP, bool FUSED>
__host__ __device__ constexpr int kv_bk() {
  return FUSED || DP > 72 ? BWD_KV_TILE : 32;
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (2 * DQ_BQ + 6 * DQ_BK) * row_len<DP>() * 4 + 2 * DQ_BK;
}

template <int DP, bool FUSED>
constexpr int dkv_smem_bytes() {
  constexpr int KB = kv_bk<DP, FUSED>();
  return (2 * KB + 6 * KV_BQ) * row_len<DP>() * 4 +
         (FUSED ? KB * DS_LD * 4 : 0) + 4 * KV_BQ * 4 + KB;
}

// a C fragment {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)} as
// the split A fragment {a0 (g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4)}: k t <-> column 2t, k t + 4 <-> column 2t + 1, so the B
// operand is read at rows 2t and 2t + 1 of each 8
__device__ __forceinline__ void c_as_a(const float (&c)[4],
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// Every product below is d += a * b in 3xTF32: small*big, big*small,
// big*big, in that order. They are issued in three rounds over all the
// independent accumulators at hand (every small*big, then every big*small,
// then every big*big): the MMAs are `asm volatile` and keep their order,
// so three products in a row on one accumulator would each wait for the
// one before.

// One block per (32 query rows, head, batch); warps 0 and 1 (16 rows
// each) take the first DQ_KW keys of every stage, warps 2 and 3 the other
// DQ_KW; the two halves' dQ are summed at the end (pair 0's plus pair
// 1's, through shared memory). Each K/V stage is split once when it
// lands, into its (double-buffered) raw tile (big) and one small-part
// tile; Q and dO, which each warp reads alone, are split as they are
// read, which keeps shared memory to 3 blocks an SM.
template <int DP>
__global__ void __launch_bounds__(NTH, 1) dq_kernel(Args a) {
  constexpr int ROW = row_len<DP>();
  constexpr int KS = DP / 8;          // k-steps over D = dQ n-tiles
  constexpr int NK = DQ_KW / 8;       // key n-tiles per warp and stage
  constexpr int NDC = KS <= 9 ? KS : 8;   // dQ n-tiles per MMA round
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* Qb = reinterpret_cast<float*>(smem_f32);  // [DQ_BQ][ROW], raw
  float* Ob = Qb + DQ_BQ * ROW;                    // [DQ_BQ][ROW], raw
  float* Kb = Ob + DQ_BQ * ROW;        // [2][DQ_BK][ROW]: raw, then big
  float* Vb = Kb + 2 * DQ_BK * ROW;    // [2][DQ_BK][ROW]
  float* Ksm = Vb + 2 * DQ_BK * ROW;   // [DQ_BK][ROW]: the stage's smalls
  float* Vsm = Ksm + DQ_BK * ROW;      // [DQ_BK][ROW]
  uint8_t* ms = reinterpret_cast<uint8_t*>(Vsm + DQ_BK * ROW);  // [2][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 1;         // the warp's 16 query rows of the tile
  const int kh = warp >> 1;        // the warp's DQ_KW keys of each stage
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (a.Lq + DQ_BQ - 1) / DQ_BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * DQ_BQ;  // last tile first
  const long long* st = a.st;
  const bool vec = a.vec != 0;

  const float* qb = static_cast<const float*>(a.q) + b * st[0] + h * st[2];
  const float* kb = static_cast<const float*>(a.k) + b * st[3] + h * st[5];
  const float* vb = static_cast<const float*>(a.v) + b * st[6] + h * st[8];
  const float* ob =
      static_cast<const float*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  // causal: keys past the tile's last query are never loaded
  int kv_end = a.S;
  if (a.causal) kv_end = min(a.S, a.q_offset + min(q0 + DQ_BQ, a.Lq));
  const int n_kt = (kv_end + DQ_BK - 1) / DQ_BK;

  load_tile<DQ_BQ, DP, NTH>(Qb, qb, st[1], q0, a.Lq, a.D, vec);
  load_tile<DQ_BQ, DP, NTH>(Ob, ob, st[10], q0, a.Lq, a.D, vec);
  if (n_kt > 0) {
    load_tile<DQ_BK, DP, NTH>(Kb, kb, st[4], 0, a.S, a.D, vec);
    load_tile<DQ_BK, DP, NTH>(Vb, vb, st[7], 0, a.S, a.D, vec);
    if (tid < DQ_BK) ms[tid] = key_ok(a.S, mb, tid);
  }
  cp_async_commit();

  // this lane's query rows qr[0] and qr[0] + 8 (of the warp's 16)
  int qr[2];
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = q0 + rw * 16 + g + 8 * i;
    const bool in = qr[i] < a.Lq;
    const long long at = ((long long)b * a.Lq + qr[i]) * a.H + h;
    lse2[i] = in ? a.lse[at] * LOG2E : 0.f;
    di[i] = in ? a.di[at] : 0.f;
  }
  const float scale2 = a.sm_scale * LOG2E;
  const float* Qw = Qb + rw * 16 * ROW;
  const float* Ow = Ob + rw * 16 * ROW;

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage `it` landed; every warp is done with it - 1
    if (it + 1 < n_kt) {
      const int nb = (buf ^ 1) * DQ_BK * ROW, k1 = (it + 1) * DQ_BK;
      load_tile<DQ_BK, DP, NTH>(Kb + nb, kb, st[4], k1, a.S, a.D, vec);
      load_tile<DQ_BK, DP, NTH>(Vb + nb, vb, st[7], k1, a.S, a.D, vec);
      if (tid < DQ_BK) ms[(buf ^ 1) * DQ_BK + tid] = key_ok(a.S, mb, k1 + tid);
    }
    cp_async_commit();
    split_tile<DQ_BK, DP, NTH>(Kb + buf * DQ_BK * ROW, Ksm);
    split_tile<DQ_BK, DP, NTH>(Vb + buf * DQ_BK * ROW, Vsm);
    __syncthreads();  // split
    // this warp's keys k0 .. k0 + DQ_KW - 1 of the stage
    const int k0 = it * DQ_BK + kh * DQ_KW;
    const float* Kt = Kb + (buf * DQ_BK + kh * DQ_KW) * ROW;
    const float* Kts = Ksm + kh * DQ_KW * ROW;
    const float* Vt = Vb + (buf * DQ_BK + kh * DQ_KW) * ROW;
    const float* Vts = Vsm + kh * DQ_KW * ROW;
    const uint8_t* mt = ms + buf * DQ_BK + kh * DQ_KW;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x DQ_KW keys; K's
    // and V's B fragments are their rows (keys) 8n + g, dims 8kk + t, + 4
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], qs[4], oa[4], os[4];
      load_a<ROW>(qa, qs, Qw, 0, kk, g, t);
      load_a<ROW>(oa, os, Ow, 0, kk, g, t);
      uint32_t kb[NK][2], ks[NK][2], vb[NK][2], vs[NK][2];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int at = (8 * n + g) * ROW + 8 * kk + t + 4 * x;
          kb[n][x] = bits(Kt[at]);
          ks[n][x] = bits(Kts[at]);
          vb[n][x] = bits(Vt[at]);
          vs[n][x] = bits(Vts[at]);
        }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mma_1688_tf32(s[n], qs, kb[n][0], kb[n][1]);
        mma_1688_tf32(dp[n], os, vb[n][0], vb[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mma_1688_tf32(s[n], qa, ks[n][0], ks[n][1]);
        mma_1688_tf32(dp[n], oa, vs[n][0], vs[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mma_1688_tf32(s[n], qa, kb[n][0], kb[n][1]);
        mma_1688_tf32(dp[n], oa, vb[n][0], vb[n][1]);
      }
    }

    // dS = P (dP - di) scale, P = exp2(s * scale2 - lse2), exactly 0
    // where masked (in place of s)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kc = 8 * n + 2 * t + (e & 1);
        const bool vis = mt[kc] && qr[i] < a.Lq &&
                         (!a.causal || k0 + kc <= a.q_offset + qr[i]);
        const float p = vis ? exp2f(fmaf(s[n][e], scale2, -lse2[i])) : 0.f;
        s[n][e] = p * (dp[n][e] - di[i]) * a.sm_scale;
      }

    // dQ += dS K per 8 keys: dS's C fragment is the A fragment with K's
    // rows read in the permuted order (key rows 8n + 2t and 8n + 2t + 1,
    // column 8j + g)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t ab[4], as[4];
      c_as_a(s[n], ab, as);
      const int at = (8 * n + 2 * t) * ROW + g;
#pragma unroll
      for (int j0 = 0; j0 < KS; j0 += NDC) {
        uint32_t bb[NDC][2], bs[NDC][2];
#pragma unroll
        for (int j = 0; j < NDC; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            if (j0 + j < KS) {
              bb[j][x] = bits(Kt[at + x * ROW + 8 * (j0 + j)]);
              bs[j][x] = bits(Kts[at + x * ROW + 8 * (j0 + j)]);
            }
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (j0 + j < KS) mma_1688_tf32(acc[j0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (j0 + j < KS) mma_1688_tf32(acc[j0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (j0 + j < KS) mma_1688_tf32(acc[j0 + j], ab, bb[j][0], bb[j][1]);
      }
    }
  }

  // the second key half's dQ added to the first's, through the K buffers:
  // entry j of lane (row warp rw) at j * 64 + rw * 32 + lane
  static_assert(4 * KS * 64 <= 2 * DQ_BK * ROW, "the sum fits in K");
  __syncthreads();                 // every warp is done with the tiles
  float* xs = Kb + rw * 32 + lane;
  if (kh > 0) {
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * n + e) * 64] = acc[n][e];
  }
  __syncthreads();
  if (kh > 0) return;

  float* dqb = static_cast<float*>(a.dq) + b * st[12] + h * st[14];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qr[e >> 1], d = 8 * n + 2 * t + (e & 1);
      const float v = acc[n][e] + xs[(4 * n + e) * 64];
      if (row < a.Lq && d < a.D) dqb[row * st[13] + d] = v;
    }
}

// One block per (KB keys, head, batch), walking the KV_BQ-row query
// tiles that can see them (KB: kv_bk). The block's KB / 16 key groups of
// 16 keys each have NW / (KB / 16) warps (2 at KB 32, 1 at KB 64), which
// share the group's keys and split each query
// tile's 8-row n-tiles between them; their dK/dV are summed at the end
// (the first warp's plus the second's, through shared memory). Per warp:
// S^T = K Q^T and dP^T = V dO^T with K and V split as their A fragments
// are read, P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q
// with P^T's and dS^T's C fragments as A fragments (dO's and Q's rows read
// in the permuted order). Each Q/dO tile is split once when it lands.
// FUSED also puts dS^T in shared memory and writes this kv tile's dQ
// partial dS K into fp32 [n_kv_tiles, B, Lq, H, D], zeros for the q tiles
// it skips.
// (NTH, 3) at KB 32: at most 168 registers (16 bytes of spills at DP 72),
// so 3 blocks fit an SM
template <int DP, bool FUSED>
__global__ void __launch_bounds__(NTH, kv_bk<DP, FUSED>() == 32 ? 3 : 1)
    dkv_kernel(Args a) {
  constexpr int ROW = row_len<DP>();
  constexpr int KS = DP / 8;          // k-steps over D = dK / dV n-tiles
  constexpr int KB = kv_bk<DP, FUSED>();  // keys per block
  constexpr int KG = KB / 16;         // key groups of 16
  constexpr int QS = NW / KG;         // warps per key group
  constexpr int NQ = KV_BQ / 8 / QS;  // query n-tiles per warp and stage
  constexpr int NDC = KS == 9 ? 3 : 4;    // dK / dV n-tiles per MMA round
  static_assert(QS == 1 || QS == 2, "one or two warps per key group");
  static_assert(!FUSED || KB == BWD_KV_TILE, "fused partials per 64 keys");
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* Ks = reinterpret_cast<float*>(smem_f32);  // [KB][ROW], raw
  float* Vs = Ks + KB * ROW;                       // [KB][ROW], raw
  float* Qb = Vs + KB * ROW;          // [2][KV_BQ][ROW]: raw, then big
  float* Ob = Qb + 2 * KV_BQ * ROW;   // [2][KV_BQ][ROW]
  float* Qsm = Ob + 2 * KV_BQ * ROW;  // [KV_BQ][ROW]: the tile's smalls
  float* Osm = Qsm + KV_BQ * ROW;     // [KV_BQ][ROW]
  float* dsT = Osm + KV_BQ * ROW;     // FUSED: [KB][DS_LD]
  float* lse_s = dsT + (FUSED ? KB * DS_LD : 0);   // [2][KV_BQ]
  float* di_s = lse_s + 2 * KV_BQ;                 // [2][KV_BQ]
  uint8_t* km = reinterpret_cast<uint8_t*>(di_s + 2 * KV_BQ);  // [KB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * KB;      // kv tile 0, which sees every query, first
  const int kr0 = (warp % KG) * 16;   // this warp's keys in the tile
  const int qh = warp / KG;           // and its share of each query tile
  const long long* st = a.st;
  const bool vec = a.vec != 0;

  const float* qb = static_cast<const float*>(a.q) + b * st[0] + h * st[2];
  const float* kb = static_cast<const float*>(a.k) + b * st[3] + h * st[5];
  const float* vb = static_cast<const float*>(a.v) + b * st[6] + h * st[8];
  const float* ob =
      static_cast<const float*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  // causal: query qi sees key k0 only from qi = k0 - q_offset on
  const int n_qt = (a.Lq + KV_BQ - 1) / KV_BQ;
  const int qt_start =
      a.causal ? min(n_qt, max(0, k0 - a.q_offset) / KV_BQ) : 0;
  // dQ partial of this kv tile, [B, Lq, H, D] slab of the fp32 buffer
  float* part = nullptr;
  if (FUSED) {
    part = a.dq_part + (long long)kt * a.B * a.Lq * a.H * a.D +
           ((long long)b * a.Lq * a.H + h) * a.D;
    // skipped q tiles still own their partial rows: zero them
    const int rows = min(qt_start * KV_BQ, a.Lq);
    for (int i = tid; i < rows * a.D; i += NTH) {
      const int r = i / a.D, d = i - (i / a.D) * a.D;
      part[(long long)r * a.H * a.D + d] = 0.f;
    }
  }

  auto load_q_tile = [&](int qt, int buf) {
    const int q1 = qt * KV_BQ;
    load_tile<KV_BQ, DP, NTH>(Qb + buf * KV_BQ * ROW, qb, st[1], q1, a.Lq,
                              a.D, vec);
    load_tile<KV_BQ, DP, NTH>(Ob + buf * KV_BQ * ROW, ob, st[10], q1, a.Lq,
                              a.D, vec);
    if (tid < KV_BQ) {
      const bool in = q1 + tid < a.Lq;
      const long long at = ((long long)b * a.Lq + q1 + tid) * a.H + h;
      lse_s[buf * KV_BQ + tid] = in ? a.lse[at] * LOG2E : 0.f;
      di_s[buf * KV_BQ + tid] = in ? a.di[at] : 0.f;
    }
  };

  load_tile<KB, DP, NTH>(Ks, kb, st[4], k0, a.S, a.D, vec);
  load_tile<KB, DP, NTH>(Vs, vb, st[7], k0, a.S, a.D, vec);
  if (tid < KB) km[tid] = key_ok(a.S, mb, k0 + tid);
  if (qt_start < n_qt) load_q_tile(qt_start, 0);
  cp_async_commit();
  const float scale2 = a.sm_scale * LOG2E;

  float dk[KS][4], dv[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt_start; qt < n_qt; ++qt) {
    const int buf = (qt - qt_start) & 1, q0 = qt * KV_BQ;
    cp_async_wait<0>();
    __syncthreads();  // tile `qt` landed; every warp is done with qt - 1
    if (qt + 1 < n_qt) load_q_tile(qt + 1, buf ^ 1);
    cp_async_commit();
    const float* Qt = Qb + buf * KV_BQ * ROW;
    const float* Ot = Ob + buf * KV_BQ * ROW;
    split_tile<KV_BQ, DP, NTH>(Qb + buf * KV_BQ * ROW, Qsm);
    split_tile<KV_BQ, DP, NTH>(Ob + buf * KV_BQ * ROW, Osm);
    __syncthreads();  // split
    const float* lt = lse_s + buf * KV_BQ;
    const float* dt = di_s + buf * KV_BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x its NQ query
    // n-tiles (8 (qh + QS i) .. + 7); Q's and dO's B fragments are their
    // rows (queries) 8n + g, dims 8kk + t and + 4
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], ks[4], va[4], vs[4];
      load_a<ROW>(ka, ks, Ks, kr0, kk, g, t);
      load_a<ROW>(va, vs, Vs, kr0, kk, g, t);
      uint32_t qb_[NQ][2], qs[NQ][2], ob_[NQ][2], os[NQ][2];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int at = (8 * (qh + QS * i) + g) * ROW + 8 * kk + t + 4 * x;
          qb_[i][x] = bits(Qt[at]);
          qs[i][x] = bits(Qsm[at]);
          ob_[i][x] = bits(Ot[at]);
          os[i][x] = bits(Osm[at]);
        }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        mma_1688_tf32(s[i], ks, qb_[i][0], qb_[i][1]);
        mma_1688_tf32(dp[i], vs, ob_[i][0], ob_[i][1]);
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        mma_1688_tf32(s[i], ka, qs[i][0], qs[i][1]);
        mma_1688_tf32(dp[i], va, os[i][0], os[i][1]);
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        mma_1688_tf32(s[i], ka, qb_[i][0], qb_[i][1]);
        mma_1688_tf32(dp[i], va, ob_[i][0], ob_[i][1]);
      }
    }

    // P^T (in place of s) and dS^T (in place of dp), exactly 0 where
    // masked
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = kr0 + g + 8 * (e >> 1);
        const int qc = 8 * (qh + QS * i) + 2 * t + (e & 1);
        const int qi = q0 + qc;
        const bool vis = km[kr] && qi < a.Lq &&
                         (!a.causal || k0 + kr <= a.q_offset + qi);
        const float p = vis ? exp2f(fmaf(s[i][e], scale2, -lt[qc])) : 0.f;
        s[i][e] = p;
        dp[i][e] = p * (dp[i][e] - dt[qc]) * a.sm_scale;
        if (FUSED) dsT[kr * DS_LD + qc] = dp[i][e];
      }

    // dV += P^T dO and dK += dS^T Q per 8 queries, dO's and Q's rows read
    // in the permuted order (query rows 8n + 2t and 8n + 2t + 1, column
    // 8j + g)
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      uint32_t pb[4], ps[4], db[4], ds[4];
      c_as_a(s[i], pb, ps);
      c_as_a(dp[i], db, ds);
      const int at = (8 * (qh + QS * i) + 2 * t) * ROW + g;
#pragma unroll
      for (int j0 = 0; j0 < KS; j0 += NDC) {
        uint32_t ob_[NDC][2], os[NDC][2], qb_[NDC][2], qs[NDC][2];
#pragma unroll
        for (int j = 0; j < NDC; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            if (j0 + j < KS) {
              const int y = at + x * ROW + 8 * (j0 + j);
              ob_[j][x] = bits(Ot[y]);
              os[j][x] = bits(Osm[y]);
              qb_[j][x] = bits(Qt[y]);
              qs[j][x] = bits(Qsm[y]);
            }
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (j0 + j < KS) {
            mma_1688_tf32(dv[j0 + j], ps, ob_[j][0], ob_[j][1]);
            mma_1688_tf32(dk[j0 + j], ds, qb_[j][0], qb_[j][1]);
          }
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (j0 + j < KS) {
            mma_1688_tf32(dv[j0 + j], pb, os[j][0], os[j][1]);
            mma_1688_tf32(dk[j0 + j], db, qs[j][0], qs[j][1]);
          }
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (j0 + j < KS) {
            mma_1688_tf32(dv[j0 + j], pb, ob_[j][0], ob_[j][1]);
            mma_1688_tf32(dk[j0 + j], db, qb_[j][0], qb_[j][1]);
          }
      }
    }

    if constexpr (FUSED) {
      // this q tile's dQ partial dS K over the block's 64 keys: the warp's
      // 16-row tile rt of the KV_BQ rows, every (NW / RT)-th d n-tile; dS's
      // A fragment from dS^T (key rows 8kk + 2t, + 1: the permuted order)
      // and K's B fragment (rows 8kk + 2t, + 1, column 8j + g)
      constexpr int RT = KV_BQ / 16;
      constexpr int JS = NW / RT;               // warps per row tile
      constexpr int NJ = (KS + JS - 1) / JS;    // n-tiles per warp
      __syncthreads();  // dS^T complete
      const int rt = warp % RT, j0 = warp / RT;
      float pq[NJ][4];
#pragma unroll
      for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pq[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KB / 8; ++kk) {
        const float* d0 = dsT + (8 * kk + 2 * t) * DS_LD + 16 * rt + g;
        const float c[4] = {d0[0], d0[DS_LD], d0[8], d0[DS_LD + 8]};
        uint32_t ab[4], as[4];
        c_as_a(c, ab, as);
        const float* k1 = Ks + (8 * kk + 2 * t) * ROW + g;
        uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
        for (int i = 0; i < NJ; ++i)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            if (j0 + JS * i < KS)
              split_tf32(k1[x * ROW + 8 * (j0 + JS * i)], bb[i][x], bs[i][x]);
#pragma unroll
        for (int i = 0; i < NJ; ++i)
          if (j0 + JS * i < KS) mma_1688_tf32(pq[i], as, bb[i][0], bb[i][1]);
#pragma unroll
        for (int i = 0; i < NJ; ++i)
          if (j0 + JS * i < KS) mma_1688_tf32(pq[i], ab, bs[i][0], bs[i][1]);
#pragma unroll
        for (int i = 0; i < NJ; ++i)
          if (j0 + JS * i < KS) mma_1688_tf32(pq[i], ab, bb[i][0], bb[i][1]);
      }
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = j0 + JS * i;
        if (j >= KS) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + 16 * rt + g + 8 * (e >> 1);
          const int d = 8 * j + 2 * t + (e & 1);
          if (row < a.Lq && d < a.D)
            part[(long long)row * a.H * a.D + d] = pq[i][e];
        }
      }
    }
  }

  if constexpr (QS > 1) {
    // the second warp of each key group adds its dK/dV to the first's,
    // through the Q/dO buffers: entry j of lane (key group kg) at
    // (j * KG + kg) * 32 + lane
    static_assert(8 * KS * KG * 32 <= 4 * KV_BQ * ROW, "the sum fits in Q");
    __syncthreads();               // every warp is done with the tiles
    float* xs = Qb + (warp % KG) * 32 + lane;
    if (qh > 0) {
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xs[(2 * (4 * n + e)) * KG * 32] = dk[n][e];
          xs[(2 * (4 * n + e) + 1) * KG * 32] = dv[n][e];
        }
    }
    __syncthreads();
    if (qh > 0) return;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[n][e] += xs[(2 * (4 * n + e)) * KG * 32];
        dv[n][e] += xs[(2 * (4 * n + e) + 1) * KG * 32];
      }
  }

  float* dkb = static_cast<float*>(a.dk) + b * st[15] + h * st[17];
  float* dvb = static_cast<float*>(a.dv) + b * st[18] + h * st[20];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + kr0 + g + 8 * (e >> 1);
      const int d = 8 * n + 2 * t + (e & 1);
      if (row < a.S && d < a.D) {
        dkb[row * st[16] + d] = dk[n][e];
        dvb[row * st[19] + d] = dv[n][e];
      }
    }
}

template <int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.B, (a.Lq + DQ_BQ - 1) / DQ_BQ);
  dq_kernel<DP><<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, bool FUSED>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DP, FUSED>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<DP, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  constexpr int KB = kv_bk<DP, FUSED>();
  dim3 grid(a.H, a.B, (a.S + KB - 1) / KB);
  dkv_kernel<DP, FUSED><<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const Args& a, bool dkv, bool fused, cudaStream_t s) {
  if (!dkv) return launch_dq<DP>(a, s);
  return fused ? launch_dkv<DP, true>(a, s) : launch_dkv<DP, false>(a, s);
}

template <int DP>
int smem_of(bool dkv, bool fused) {
  if (!dkv) return dq_smem_bytes<DP>();
  return fused ? dkv_smem_bytes<DP, true>() : dkv_smem_bytes<DP, false>();
}

int smem_bytes(bool dkv, bool fused, int D) {
  if (D <= 64) return smem_of<64>(dkv, fused);
  if (D <= 72) return smem_of<72>(dkv, fused);
  if (D <= 128) return smem_of<128>(dkv, fused);
  return -1;
}

cudaError_t dispatch(const Args& a, bool dkv, bool fused, cudaStream_t s) {
  if (a.D <= 64) return launch<64>(a, dkv, fused, s);
  if (a.D <= 72) return launch<72>(a, dkv, fused, s);
  if (a.D <= 128) return launch<128>(a, dkv, fused, s);
  return cudaErrorInvalidValue;
}

}  // namespace tf32

// --------------------------------------------------- tensor core (bf16) ---

namespace tc {

using bf16 = __nv_bfloat16;
using emmax::mma::cp_async_commit;
using emmax::mma::cp_async_wait;
using emmax::mma::ldmatrix_x4_trans;
using emmax::mma::mma_16816;
using emmax::mma::pack_bf16;
using emmax::tc::key_ok;
using emmax::tc::load_a;
using emmax::tc::load_b;
using emmax::tc::load_bt;
using emmax::tc::load_tile;
using emmax::tc::row_len;

constexpr int NW = 4;            // warps per block
constexpr int NTH = 32 * NW;     // threads per block
constexpr int DQ_BQ = 16 * NW;   // dQ: query rows per block, 16 per warp
constexpr int DQ_BK = 64;        // dQ: keys per stage
constexpr int KV_BK = 16 * NW;   // dK/dV: keys per block, 16 per warp
constexpr int KV_BQ = 32;        // dK/dV: query rows per stage
constexpr int DS_LD = KV_BQ + 8; // dS^T rows in shared: 80 bytes, so the
                                 // 8 rows of an ldmatrix hit 8 bank groups
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
constexpr int dq_smem_bytes() {
  return (2 * DQ_BQ + 4 * DQ_BK) * row_len<DP>() * 2 + 2 * DQ_BK;
}

template <int DP, bool FUSED>
constexpr int dkv_smem_bytes() {
  return (2 * KV_BK + 4 * KV_BQ) * row_len<DP>() * 2 +
         (FUSED ? KV_BK * DS_LD * 2 : 0) + 4 * KV_BQ * 4 + KV_BK;
}

template <int DP>
__global__ void __launch_bounds__(NTH) dq_kernel(Args a) {
  constexpr int ROW = row_len<DP>();
  constexpr int NT = DP / 8;     // dQ n-tiles
  constexpr int KS = DP / 16;    // k-steps over D
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);     // [DQ_BQ][ROW]
  bf16* dOs = Qs + DQ_BQ * ROW;                 // [DQ_BQ][ROW]
  bf16* Ks = dOs + DQ_BQ * ROW;                 // [2][DQ_BK][ROW]
  bf16* Vs = Ks + 2 * DQ_BK * ROW;              // [2][DQ_BK][ROW]
  uint8_t* ms = reinterpret_cast<uint8_t*>(Vs + 2 * DQ_BK * ROW);  // [2][DQ_BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (a.Lq + DQ_BQ - 1) / DQ_BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * DQ_BQ;  // last tile first
  const long long* st = a.st;
  const bool vec = a.vec != 0;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * st[0] + h * st[2];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * st[3] + h * st[5];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * st[6] + h * st[8];
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  int kv_end = a.S;
  if (a.causal) kv_end = min(a.S, a.q_offset + min(q0 + DQ_BQ, a.Lq));
  const int n_kt = (kv_end + DQ_BK - 1) / DQ_BK;

  load_tile<DQ_BQ, DP, NTH>(Qs, qb, st[1], q0, a.Lq, a.D, vec);
  load_tile<DQ_BQ, DP, NTH>(dOs, ob, st[10], q0, a.Lq, a.D, vec);
  if (n_kt > 0) {
    load_tile<DQ_BK, DP, NTH>(Ks, kb, st[4], 0, a.S, a.D, vec);
    load_tile<DQ_BK, DP, NTH>(Vs, vb, st[7], 0, a.S, a.D, vec);
    if (tid < DQ_BK) ms[tid] = key_ok(a.S, mb, tid);
  }
  cp_async_commit();

  // this lane's query rows qr[0] and qr[0] + 8 (of the warp's 16)
  int qr[2];
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = q0 + warp * 16 + g + 8 * i;
    const bool in = qr[i] < a.Lq;
    const long long at = ((long long)b * a.Lq + qr[i]) * a.H + h;
    lse2[i] = in ? a.lse[at] * LOG2E : 0.f;
    di[i] = in ? a.di[at] : 0.f;
  }
  const float scale2 = a.sm_scale * LOG2E;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1, k0 = it * DQ_BK;
    cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    uint8_t m_next = 0;
    if (it + 1 < n_kt) {
      const int nb = (buf ^ 1) * DQ_BK * ROW;
      load_tile<DQ_BK, DP, NTH>(Ks + nb, kb, st[4], k0 + DQ_BK, a.S, a.D,
                                vec);
      load_tile<DQ_BK, DP, NTH>(Vs + nb, vb, st[7], k0 + DQ_BK, a.S, a.D,
                                vec);
      if (tid < DQ_BK) m_next = key_ok(a.S, mb, k0 + DQ_BK + tid);
    }
    cp_async_commit();
    const bf16* Kt = Ks + buf * DQ_BK * ROW;
    const bf16* Vt = Vs + buf * DQ_BK * ROW;
    const uint8_t* mt = ms + buf * DQ_BK;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      load_a<ROW>(aq, Qs, warp * 16, kk, lane);
      load_a<ROW>(ao, dOs, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        load_b<ROW>(bk, Kt, 16 * np, kk, lane);
        load_b<ROW>(bv, Vt, 16 * np, kk, lane);
        mma_16816(s[2 * np], aq, bk[0], bk[1]);
        mma_16816(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_16816(dp[2 * np], ao, bv[0], bv[1]);
        mma_16816(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }

    // P and dS (bf16), packed as the A fragments of dQ += dS K
    uint32_t ads[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kc = 8 * n + 2 * t + (e & 1);
        const int kj = k0 + kc;
        const bool vis = mt[kc] && qr[i] < a.Lq &&
                         (!a.causal || kj <= a.q_offset + qr[i]);
        const float p = vis ? exp2f(s[n][e] * scale2 - lse2[i]) : 0.f;
        ds[e] = p * (dp[n][e] - di[i]) * a.sm_scale;
      }
      ads[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
      ads[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        load_bt<ROW>(bk, Kt, 16 * kk, np, lane);
        mma_16816(acc[2 * np], ads[kk], bk[0], bk[1]);
        mma_16816(acc[2 * np + 1], ads[kk], bk[2], bk[3]);
      }
    if (it + 1 < n_kt && tid < DQ_BK) ms[(buf ^ 1) * DQ_BK + tid] = m_next;
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + b * st[12] + h * st[14];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qr[e >> 1], d = 8 * n + 2 * t + (e & 1);
      if (row < a.Lq && d < a.D)
        dqb[row * st[13] + d] = __float2bfloat16(acc[n][e]);
    }
}

template <int DP, bool FUSED>
__global__ void __launch_bounds__(NTH) dkv_kernel(Args a) {
  constexpr int ROW = row_len<DP>();
  constexpr int NT = DP / 8;     // dK / dV n-tiles
  constexpr int KS = DP / 16;    // k-steps over D
  constexpr int NP = DP / 16;    // pairs of n-tiles
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);     // [KV_BK][ROW]
  bf16* Vs = Ks + KV_BK * ROW;                  // [KV_BK][ROW]
  bf16* Qs = Vs + KV_BK * ROW;                  // [2][KV_BQ][ROW]
  bf16* dOs = Qs + 2 * KV_BQ * ROW;             // [2][KV_BQ][ROW]
  bf16* dsT = dOs + 2 * KV_BQ * ROW;            // FUSED: [KV_BK][DS_LD]
  float* lse_s = reinterpret_cast<float*>(dsT + (FUSED ? KV_BK * DS_LD : 0));
  float* di_s = lse_s + 2 * KV_BQ;              // [2][KV_BQ] each
  uint8_t* km = reinterpret_cast<uint8_t*>(di_s + 2 * KV_BQ);   // [KV_BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * KV_BK;   // kv tile 0, which sees every query, first
  const long long* st = a.st;
  const bool vec = a.vec != 0;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * st[0] + h * st[2];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * st[3] + h * st[5];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * st[6] + h * st[8];
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  // causal: query qi sees key k0 only from qi = k0 - q_offset on
  const int n_qt = (a.Lq + KV_BQ - 1) / KV_BQ;
  const int qt_start =
      a.causal ? min(n_qt, max(0, k0 - a.q_offset) / KV_BQ) : 0;
  // dQ partial of this kv tile, [B, Lq, H, D] slab of the fp32 buffer
  float* part = nullptr;
  if (FUSED) {
    part = a.dq_part + (long long)kt * a.B * a.Lq * a.H * a.D +
           ((long long)b * a.Lq * a.H + h) * a.D;
    // skipped q tiles still own their partial rows: zero them
    const int rows = min(qt_start * KV_BQ, a.Lq);
    for (int i = tid; i < rows * a.D; i += NTH) {
      const int r = i / a.D, d = i - (i / a.D) * a.D;
      part[(long long)r * a.H * a.D + d] = 0.f;
    }
  }

  load_tile<KV_BK, DP, NTH>(Ks, kb, st[4], k0, a.S, a.D, vec);
  load_tile<KV_BK, DP, NTH>(Vs, vb, st[7], k0, a.S, a.D, vec);
  if (tid < KV_BK) km[tid] = key_ok(a.S, mb, k0 + tid);
  if (qt_start < n_qt) {
    const int q0 = qt_start * KV_BQ;
    load_tile<KV_BQ, DP, NTH>(Qs, qb, st[1], q0, a.Lq, a.D, vec);
    load_tile<KV_BQ, DP, NTH>(dOs, ob, st[10], q0, a.Lq, a.D, vec);
    if (tid < KV_BQ) {
      const bool in = q0 + tid < a.Lq;
      const long long at = ((long long)b * a.Lq + q0 + tid) * a.H + h;
      lse_s[tid] = in ? a.lse[at] * LOG2E : 0.f;
      di_s[tid] = in ? a.di[at] : 0.f;
    }
  }
  cp_async_commit();
  const float scale2 = a.sm_scale * LOG2E;
  const int kr0 = warp * 16;   // this warp's keys in the tile

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt_start; qt < n_qt; ++qt) {
    const int buf = (qt - qt_start) & 1, q0 = qt * KV_BQ;
    cp_async_wait<0>();
    __syncthreads();  // tile `qt` landed; every warp is done with qt - 1
    float lse_next = 0.f, di_next = 0.f;
    if (qt + 1 < n_qt) {
      const int nb = (buf ^ 1) * KV_BQ * ROW, q1 = q0 + KV_BQ;
      load_tile<KV_BQ, DP, NTH>(Qs + nb, qb, st[1], q1, a.Lq, a.D, vec);
      load_tile<KV_BQ, DP, NTH>(dOs + nb, ob, st[10], q1, a.Lq, a.D, vec);
      if (tid < KV_BQ && q1 + tid < a.Lq) {
        const long long at = ((long long)b * a.Lq + q1 + tid) * a.H + h;
        lse_next = a.lse[at] * LOG2E;
        di_next = a.di[at];
      }
    }
    cp_async_commit();
    const bf16* Qt = Qs + buf * KV_BQ * ROW;
    const bf16* dOt = dOs + buf * KV_BQ * ROW;
    const float* lt = lse_s + buf * KV_BQ;
    const float* dt = di_s + buf * KV_BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      load_a<ROW>(ak, Ks, kr0, kk, lane);
      load_a<ROW>(av, Vs, kr0, kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bo[4];
        load_b<ROW>(bq, Qt, 16 * np, kk, lane);
        load_b<ROW>(bo, dOt, 16 * np, kk, lane);
        mma_16816(s[2 * np], ak, bq[0], bq[1]);
        mma_16816(s[2 * np + 1], ak, bq[2], bq[3]);
        mma_16816(dp[2 * np], av, bo[0], bo[1]);
        mma_16816(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }

    // P^T and dS^T, packed as the A fragments of dV += P^T dO and
    // dK += dS^T Q (k = the tile's 32 queries)
    uint32_t ap[2][4], ads[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = kr0 + g + 8 * (e >> 1);
        const int qc = 8 * n + 2 * t + (e & 1);
        const int qi = q0 + qc;
        const bool vis = km[kr] && qi < a.Lq &&
                         (!a.causal || k0 + kr <= a.q_offset + qi);
        p[e] = vis ? exp2f(s[n][e] * scale2 - lt[qc]) : 0.f;
        ds[e] = p[e] * (dp[n][e] - dt[qc]) * a.sm_scale;
      }
      ap[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
      ap[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
      ads[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
      ads[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      if (FUSED) {
        uint32_t* row0 = reinterpret_cast<uint32_t*>(
            dsT + (kr0 + g) * DS_LD + 8 * n + 2 * t);
        row0[0] = ads[n >> 1][2 * (n & 1)];
        row0[4 * DS_LD] = ads[n >> 1][2 * (n & 1) + 1];   // key row + 8
      }
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q through ldmatrix.trans
#pragma unroll
    for (int kq = 0; kq < 2; ++kq)
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t bo[4], bq[4];
        load_bt<ROW>(bo, dOt, 16 * kq, np, lane);
        load_bt<ROW>(bq, Qt, 16 * kq, np, lane);
        mma_16816(dv[2 * np], ap[kq], bo[0], bo[1]);
        mma_16816(dv[2 * np + 1], ap[kq], bo[2], bo[3]);
        mma_16816(dk[2 * np], ads[kq], bq[0], bq[1]);
        mma_16816(dk[2 * np + 1], ads[kq], bq[2], bq[3]);
      }

    if (FUSED) {
      // this q tile's dQ partial dS K: warp rows qw.. qw + 15 of the 32,
      // every other pair of d n-tiles
      __syncthreads();  // dS^T complete
      constexpr int NJ = (NP + 1) / 2;
      const int qw = 16 * (warp & 1);
      float pq[NJ][2][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pq[j][0][e] = pq[j][1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // dS = (dS^T)^T: A fragment through ldmatrix.trans
        uint32_t as[4];
        ldmatrix_x4_trans(as, dsT + (16 * kk + (lane >> 4) * 8 + (lane & 7)) *
                                        DS_LD +
                                    qw + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int np = (warp >> 1) + 2 * j;
          if (np < NP) {
            uint32_t bk[4];
            load_bt<ROW>(bk, Ks, 16 * kk, np, lane);
            mma_16816(pq[j][0], as, bk[0], bk[1]);
            mma_16816(pq[j][1], as, bk[2], bk[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int np = (warp >> 1) + 2 * j;
        if (np >= NP) continue;
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + qw + g + 8 * (e >> 1);
            const int d = 8 * (2 * np + x) + 2 * t + (e & 1);
            if (row < a.Lq && d < a.D)
              part[(long long)row * a.H * a.D + d] = pq[j][x][e];
          }
      }
    }
    if (qt + 1 < n_qt && tid < KV_BQ) {
      lse_s[(buf ^ 1) * KV_BQ + tid] = lse_next;
      di_s[(buf ^ 1) * KV_BQ + tid] = di_next;
    }
  }

  bf16* dkb = static_cast<bf16*>(a.dk) + b * st[15] + h * st[17];
  bf16* dvb = static_cast<bf16*>(a.dv) + b * st[18] + h * st[20];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + kr0 + g + 8 * (e >> 1);
      const int d = 8 * n + 2 * t + (e & 1);
      if (row < a.S && d < a.D) {
        dkb[row * st[16] + d] = __float2bfloat16(dk[n][e]);
        dvb[row * st[19] + d] = __float2bfloat16(dv[n][e]);
      }
    }
}

template <int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.B, (a.Lq + DQ_BQ - 1) / DQ_BQ);
  dq_kernel<DP><<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, bool FUSED>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DP, FUSED>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<DP, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, a.B, (a.S + KV_BK - 1) / KV_BK);
  dkv_kernel<DP, FUSED><<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const Args& a, bool dkv, bool fused, cudaStream_t s) {
  if (!dkv) return launch_dq<DP>(a, s);
  return fused ? launch_dkv<DP, true>(a, s) : launch_dkv<DP, false>(a, s);
}

template <int DP>
int smem_of(bool dkv, bool fused) {
  if (!dkv) return dq_smem_bytes<DP>();
  return fused ? dkv_smem_bytes<DP, true>() : dkv_smem_bytes<DP, false>();
}

int smem_bytes(bool dkv, bool fused, int D) {
  if (D <= 64) return smem_of<64>(dkv, fused);
  if (D <= 80) return smem_of<80>(dkv, fused);
  if (D <= 112) return smem_of<112>(dkv, fused);
  if (D <= 128) return smem_of<128>(dkv, fused);
  return -1;
}

cudaError_t dispatch(const Args& a, bool dkv, bool fused, cudaStream_t s) {
  if (a.D <= 64) return launch<64>(a, dkv, fused, s);
  if (a.D <= 80) return launch<80>(a, dkv, fused, s);
  if (a.D <= 112) return launch<112>(a, dkv, fused, s);
  if (a.D <= 128) return launch<128>(a, dkv, fused, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

int entry(bool dkv, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* di,
          const void* kv_mask, void* dq, void* dk, void* dv, void* dq_part,
          int B, int H, int Lq, int S, int D, const long long* strides,
          int causal, int q_offset, float sm_scale, int dtype, int fused,
          void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.mask = static_cast<const uint8_t*>(kv_mask);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_part = static_cast<float*>(dq_part);
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.S = S;
  a.D = D;
  for (int i = 0; i < 22; ++i) a.st[i] = strides[i];
  a.causal = causal;
  a.q_offset = q_offset;
  a.sm_scale = sm_scale;
  a.vec = dtype == emmax::kFloat32
              ? emmax::tc::rows_16b<4>(D, strides, {q, k, v, dout})
              : emmax::tc::rows_16b<8>(D, strides, {q, k, v, dout});
  if (dkv && fused && dq_part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == emmax::kBFloat16)
    err = tc::dispatch(a, dkv, fused != 0, s);
  else if (dtype == emmax::kFloat32)
    err = tf32::dispatch(a, dkv, fused != 0, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// strides[22], in elements: (batch, row, head) of q, k, v, do, dq, dk, dv,
// then the mask's batch stride. lse and di are fp32 [B, Lq, H] contiguous.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int emmax_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* di,
                                  const void* kv_mask, void* dq, void* dk,
                                  void* dv, void* dq_part, int B, int H,
                                  int Lq, int S, int D,
                                  const long long* strides, int causal,
                                  int q_offset, float sm_scale, int dtype,
                                  int fused, void* stream) {
  return entry(false, q, k, v, dout, lse, di, kv_mask, dq, dk, dv, dq_part,
               B, H, Lq, S, D, strides, causal, q_offset, sm_scale, dtype,
               fused, stream);
}

// dK and dV; with fused != 0 also the fp32 dQ partials
// [ceil(S / 64), B, Lq, H, D] into dq_part (64 keys per tile in both
// dtypes).
extern "C" int emmax_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* di,
                                   const void* kv_mask, void* dq, void* dk,
                                   void* dv, void* dq_part, int B, int H,
                                   int Lq, int S, int D,
                                   const long long* strides, int causal,
                                   int q_offset, float sm_scale, int dtype,
                                   int fused, void* stream) {
  return entry(true, q, k, v, dout, lse, di, kv_mask, dq, dk, dv, dq_part,
               B, H, Lq, S, D, strides, causal, q_offset, sm_scale, dtype,
               fused, stream);
}

// Dynamic shared memory (bytes) of the kernel that `emmax_flash_bwd_dq`
// (dkv == 0) or `emmax_flash_bwd_dkv` launches for `dtype` at head dim D;
// -1 past 128.
extern "C" int emmax_flash_bwd_smem_bytes(int dkv, int fused, int D,
                                          int dtype) {
  return dtype == emmax::kFloat32 ? tf32::smem_bytes(dkv, fused, D)
                                  : tc::smem_bytes(dkv, fused, D);
}
