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
// fp32: scalar kernels (namespace `scalar`): every product a fp32
// FMA from shared memory on the CUDA cores (TF32 would not hold the fp32
// tolerance), one 256-thread block per 64-row tile, 2 x 8 micro-tiles per
// thread, D padded to 64, 72 or 128, rows padded by one float.

#include "common.cuh"
#include "mma.cuh"

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

// ------------------------------------------------------ scalar (fp32) ---

namespace scalar {

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // threads per block: 32 row groups x 8 columns
constexpr int RPT = 2;      // rows per thread (BQ == BK == RPT * NT / 8)

// rows [r0, r0 + 64) of a [rows, D] slice -> shared [64][DP + 1] fp32,
// zero past `rows` and past D
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int rows, int D) {
  constexpr int QS = DP + 1;
  for (int i = threadIdx.x; i < 64 * DP; i += NT) {
    const int r = i / DP, d = i - (i / DP) * DP;
    float val = 0.f;
    if (r0 + r < rows && d < D) val = src[(r0 + r) * row_stride + d];
    dst[r * QS + d] = val;
  }
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (4 * 64 * (DP + 1) + BQ * (BK + 1)) * (int)sizeof(float);
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return (4 * 64 * (DP + 1) + 2 * BK * (BQ + 1)) * (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(NT) dq_kernel(Args a) {
  constexpr int QS = DP + 1;
  constexpr int PS = BK + 1;
  constexpr int NC = DP / 8;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QS]
  float* dOs = Qs + BQ * QS;    // [BQ][QS]
  float* Ks = dOs + BQ * QS;    // [BK][QS]
  float* Vs = Ks + BK * QS;     // [BK][QS]
  float* dSs = Vs + BK * QS;    // [BQ][PS]
  __shared__ float lse_s[BQ], di_s[BQ];

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long* st = a.st;

  const float* qb = static_cast<const float*>(a.q) + b * st[0] + h * st[2];
  const float* kb = static_cast<const float*>(a.k) + b * st[3] + h * st[5];
  const float* vb = static_cast<const float*>(a.v) + b * st[6] + h * st[8];
  const float* ob =
      static_cast<const float*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  load_tile<DP>(Qs, qb, st[1], q0, a.Lq, a.D);
  load_tile<DP>(dOs, ob, st[10], q0, a.Lq, a.D);
  for (int r = tid; r < BQ; r += NT) {
    const bool in = q0 + r < a.Lq;
    const long long at = ((long long)b * a.Lq + q0 + r) * a.H + h;
    lse_s[r] = in ? a.lse[at] : 0.f;
    di_s[r] = in ? a.di[at] : 0.f;
  }

  float acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  int kv_end = a.S;
  if (a.causal) kv_end = min(a.S, a.q_offset + q0 + BQ);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile's K/V/dS consumed; Q/dO/lse loaded
    load_tile<DP>(Ks, kb, st[4], k0, a.S, a.D);
    load_tile<DP>(Vs, vb, st[7], k0, a.S, a.D);
    __syncthreads();

    float s[RPT][8], dp[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qa[RPT], oa[RPT], ka[8], va[8];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qa[i] = Qs[(rg * RPT + i) * QS + d];
        oa[i] = dOs[(rg * RPT + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ka[j] = Ks[(cg + 8 * j) * QS + d];
        va[j] = Vs[(cg + 8 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        const float p = visible(a, mb, q0 + r, k0 + c)
                            ? expf(s[i][j] * a.sm_scale - lse_s[r])
                            : 0.f;
        dSs[r * PS + c] = p * (dp[i][j] - di_s[r]) * a.sm_scale;
      }
    }
    __syncthreads();  // dS tile complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sa[RPT], ka[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sa[i] = dSs[(rg * RPT + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) ka[c] = Ks[kk * QS + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sa[i], ka[c], acc[i][c]);
    }
  }

  float* dqb = static_cast<float*>(a.dq) + b * st[12] + h * st[14];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = cg + 8 * c;
      if (d < a.D) dqb[row * st[13] + d] = acc[i][c];
    }
  }
}

template <int DP, bool FUSED>
__global__ void __launch_bounds__(NT) dkv_kernel(Args a) {
  constexpr int QS = DP + 1;
  constexpr int PQ = BQ + 1;
  constexpr int NC = DP / 8;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][QS]
  float* Vs = Ks + BK * QS;     // [BK][QS]
  float* Qs = Vs + BK * QS;     // [BQ][QS]
  float* dOs = Qs + BQ * QS;    // [BQ][QS]
  float* Ps = dOs + BQ * QS;    // [BK][PQ], key-major
  float* dSs = Ps + BK * PQ;    // [BK][PQ], key-major
  __shared__ float lse_s[BQ], di_s[BQ];

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long* st = a.st;

  const float* qb = static_cast<const float*>(a.q) + b * st[0] + h * st[2];
  const float* kb = static_cast<const float*>(a.k) + b * st[3] + h * st[5];
  const float* vb = static_cast<const float*>(a.v) + b * st[6] + h * st[8];
  const float* ob =
      static_cast<const float*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  load_tile<DP>(Ks, kb, st[4], k0, a.S, a.D);
  load_tile<DP>(Vs, vb, st[7], k0, a.S, a.D);

  float dk[RPT][NC], dv[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: query qi sees key k0 only from qi = k0 - q_offset on
  const int n_qt = (a.Lq + BQ - 1) / BQ;
  const int qt_start = a.causal ? min(n_qt, max(0, k0 - a.q_offset) / BQ) : 0;
  // dQ partial of this kv tile, [B, Lq, H, D] slab of the fp32 buffer
  float* part = FUSED ? a.dq_part + (long long)blockIdx.x * a.B * a.Lq *
                                        a.H * a.D +
                            ((long long)b * a.Lq * a.H + h) * a.D
                      : nullptr;
  if (FUSED) {
    // skipped tiles still own their partial rows: zero them
    for (int i = tid; i < qt_start * BQ * a.D; i += NT) {
      const int r = i / a.D, d = i - (i / a.D) * a.D;
      if (r < a.Lq) part[(long long)r * a.H * a.D + d] = 0.f;
    }
  }

  for (int qt = qt_start; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // previous q tile consumed; K/V loaded
    load_tile<DP>(Qs, qb, st[1], q0, a.Lq, a.D);
    load_tile<DP>(dOs, ob, st[10], q0, a.Lq, a.D);
    for (int r = tid; r < BQ; r += NT) {
      const bool in = q0 + r < a.Lq;
      const long long at = ((long long)b * a.Lq + q0 + r) * a.H + h;
      lse_s[r] = in ? a.lse[at] : 0.f;
      di_s[r] = in ? a.di[at] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are keys 2*rg.., columns queries cg + 8*j
    float s[RPT][8], dp[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float ka[RPT], va[RPT], qa[8], oa[8];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        ka[i] = Ks[(rg * RPT + i) * QS + d];
        va[i] = Vs[(rg * RPT + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qa[j] = Qs[(cg + 8 * j) * QS + d];
        oa[j] = dOs[(cg + 8 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
          dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;  // key row in the tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;  // query column in the tile
        const float p = visible(a, mb, q0 + c, k0 + r)
                            ? expf(s[i][j] * a.sm_scale - lse_s[c])
                            : 0.f;
        Ps[r * PQ + c] = p;
        dSs[r * PQ + c] = p * (dp[i][j] - di_s[c]) * a.sm_scale;
      }
    }
    __syncthreads();  // P and dS tiles complete

    // dV += P^T dO and dK += dS^T Q: rows keys 2*rg.., columns cg + 8*c
#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float pa[RPT], sa[RPT], oa[NC], qa[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pa[i] = Ps[(rg * RPT + i) * PQ + qq];
        sa[i] = dSs[(rg * RPT + i) * PQ + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        oa[c] = dOs[qq * QS + cg + 8 * c];
        qa[c] = Qs[qq * QS + cg + 8 * c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[i][c] = fmaf(pa[i], oa[c], dv[i][c]);
          dk[i][c] = fmaf(sa[i], qa[c], dk[i][c]);
        }
    }

    if (FUSED) {
      // this tile's dQ partial dS K: rows queries 2*rg.., columns cg + 8*c
      float pq[RPT][NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) pq[i][c] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float sa[RPT], ka[NC];
#pragma unroll
        for (int i = 0; i < RPT; ++i) sa[i] = dSs[kk * PQ + rg * RPT + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) ka[c] = Ks[kk * QS + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) pq[i][c] = fmaf(sa[i], ka[c], pq[i][c]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + rg * RPT + i;
        if (row >= a.Lq) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = cg + 8 * c;
          if (d < a.D) part[(long long)row * a.H * a.D + d] = pq[i][c];
        }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk) + b * st[15] + h * st[17];
  float* dvb = static_cast<float*>(a.dv) + b * st[18] + h * st[20];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + rg * RPT + i;
    if (row >= a.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = cg + 8 * c;
      if (d < a.D) {
        dkb[row * st[16] + d] = dk[i][c];
        dvb[row * st[19] + d] = dv[i][c];
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  dq_kernel<DP><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, bool FUSED>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<DP, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BK - 1) / BK, a.H, a.B);
  dkv_kernel<DP, FUSED><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const Args& a, bool dkv, bool fused, cudaStream_t s) {
  if (!dkv) return launch_dq<DP>(a, s);
  return fused ? launch_dkv<DP, true>(a, s) : launch_dkv<DP, false>(a, s);
}

cudaError_t dispatch(const Args& a, bool dkv, bool fused, cudaStream_t s) {
  if (a.D <= 64) return launch<64>(a, dkv, fused, s);
  if (a.D <= 72) return launch<72>(a, dkv, fused, s);
  if (a.D <= 128) return launch<128>(a, dkv, fused, s);
  return cudaErrorInvalidValue;
}

}  // namespace scalar

// --------------------------------------------------- tensor core (bf16) ---

namespace tc {

using bf16 = __nv_bfloat16;
using emmax::mma::cp_async_16;
using emmax::mma::cp_async_commit;
using emmax::mma::cp_async_wait;
using emmax::mma::ldmatrix_x4;
using emmax::mma::ldmatrix_x4_trans;
using emmax::mma::mma_16816;
using emmax::mma::pack_bf16;
using emmax::mma::swizzle;

constexpr int NW = 4;            // warps per block
constexpr int NTH = 32 * NW;     // threads per block
constexpr int DQ_BQ = 16 * NW;   // dQ: query rows per block, 16 per warp
constexpr int DQ_BK = 64;        // dQ: keys per stage
constexpr int KV_BK = 16 * NW;   // dK/dV: keys per block, 16 per warp
constexpr int KV_BQ = 32;        // dK/dV: query rows per stage
constexpr int DS_LD = KV_BQ + 8; // dS^T rows in shared: 80 bytes, so the
                                 // 8 rows of an ldmatrix hit 8 bank groups
constexpr float LOG2E = 1.4426950408889634f;

// shared row length (elements) of a tile padded to DP: whole 128-byte
// groups, the unit of the swizzle
template <int DP>
__host__ __device__ constexpr int row_len() {
  return (DP + 63) / 64 * 64;
}

// rows [r0, r0 + R) of a [rows, D] bf16 slice -> swizzled shared
// [R][row_len<DP>()], zero past `rows` and in columns D..DP. With `vec`
// (D % 8 == 0, 16-byte aligned rows) one cp.async per 16 bytes; otherwise
// element loads.
template <int R, int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int rows, int D, bool vec) {
  constexpr int ROW = row_len<DP>();
  constexpr int CH = DP / 8;
  if (vec) {
    for (int i = threadIdx.x; i < R * CH; i += NTH) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool in = r0 + r < rows && c * 8 < D;
      cp_async_16(dst + swizzle<ROW>(r, c),
                  in ? src + (r0 + r) * row_stride + c * 8 : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += NTH) {
      const int r = i / DP, d = i - (i / DP) * DP;
      bf16 val = __float2bfloat16(0.f);
      if (r0 + r < rows && d < D) val = src[(r0 + r) * row_stride + d];
      dst[swizzle<ROW>(r, d >> 3) + (d & 7)] = val;
    }
  }
}

__device__ __forceinline__ uint8_t key_ok(const Args& a, const uint8_t* mb,
                                          int kj) {
  return kj < a.S && (!mb || mb[kj] != 0);
}

// the [16 x 16] A fragment of rows r0.. of a swizzled tile, k-step kk
template <int ROW>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile,
                                       int r0, int kk, int lane) {
  ldmatrix_x4(r, tile + swizzle<ROW>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                     2 * kk + (lane >> 4)));
}

// B fragments of two neighbouring n-tiles (rows n0.., n0 + 8..) of a
// swizzled row-major [n][k] tile, k-step kk: r[0..1] n-tile n0, r[2..3]
// n-tile n0 + 8
template <int ROW>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile,
                                       int n0, int kk, int lane) {
  ldmatrix_x4(r, tile + swizzle<ROW>(n0 + (lane & 7) + (lane >> 4) * 8,
                                     2 * kk + ((lane >> 3) & 1)));
}

// B fragments of d-chunks 2*np and 2*np + 1 from a swizzled row-major
// [k][d] tile (k rows k0..k0 + 15) through ldmatrix.trans
template <int ROW>
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const bf16* tile,
                                        int k0, int np, int lane) {
  ldmatrix_x4_trans(r, tile + swizzle<ROW>(
                           k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                           2 * np + (lane >> 4)));
}

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

  load_tile<DQ_BQ, DP>(Qs, qb, st[1], q0, a.Lq, a.D, vec);
  load_tile<DQ_BQ, DP>(dOs, ob, st[10], q0, a.Lq, a.D, vec);
  if (n_kt > 0) {
    load_tile<DQ_BK, DP>(Ks, kb, st[4], 0, a.S, a.D, vec);
    load_tile<DQ_BK, DP>(Vs, vb, st[7], 0, a.S, a.D, vec);
    if (tid < DQ_BK) ms[tid] = key_ok(a, mb, tid);
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
      load_tile<DQ_BK, DP>(Ks + nb, kb, st[4], k0 + DQ_BK, a.S, a.D, vec);
      load_tile<DQ_BK, DP>(Vs + nb, vb, st[7], k0 + DQ_BK, a.S, a.D, vec);
      if (tid < DQ_BK) m_next = key_ok(a, mb, k0 + DQ_BK + tid);
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

  load_tile<KV_BK, DP>(Ks, kb, st[4], k0, a.S, a.D, vec);
  load_tile<KV_BK, DP>(Vs, vb, st[7], k0, a.S, a.D, vec);
  if (tid < KV_BK) km[tid] = key_ok(a, mb, k0 + tid);
  if (qt_start < n_qt) {
    const int q0 = qt_start * KV_BQ;
    load_tile<KV_BQ, DP>(Qs, qb, st[1], q0, a.Lq, a.D, vec);
    load_tile<KV_BQ, DP>(dOs, ob, st[10], q0, a.Lq, a.D, vec);
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
      load_tile<KV_BQ, DP>(Qs + nb, qb, st[1], q1, a.Lq, a.D, vec);
      load_tile<KV_BQ, DP>(dOs + nb, ob, st[10], q1, a.Lq, a.D, vec);
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

// 16-byte loads need D % 8 == 0 and every row of q, k, v and do to start
// on a 16-byte boundary
bool rows_16b(const Args& a) {
  if (a.D % 8) return false;
  for (int i = 0; i < 12; ++i)
    if (a.st[i] % 8) return false;
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  for (const void* p : base)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

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
  a.vec = rows_16b(a);
  if (dkv && fused && dq_part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == emmax::kBFloat16)
    err = tc::dispatch(a, dkv, fused != 0, s);
  else if (dtype == emmax::kFloat32)
    err = scalar::dispatch(a, dkv, fused != 0, s);
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

// Dynamic shared memory (bytes) of the bf16 kernel that
// `emmax_flash_bwd_dq` (dkv == 0) or `emmax_flash_bwd_dkv` launches at
// head dim D; -1 past 128.
extern "C" int emmax_flash_bwd_smem_bytes(int dkv, int fused, int D) {
  return tc::smem_bytes(dkv, fused, D);
}
