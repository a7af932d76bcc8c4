// Flash-attention forward for Hopper (sm_90a), bound with ctypes.
//
// Replaces: the Pallas TPU kernel `_flash_fwd` / `_fwd_kernel`
// (emmax_tpu/ops/flash_attention.py:81-223, pallas_call at :202), reached
// through `flash_attention` (:495).
//
// What it computes: o = softmax(mask(q k^T * sm_scale)) v per (batch, head),
// in the JAX layout [B, L, H, D] (any row/head/batch strides, unit stride
// on D). Causal masking is at a scalar `q_offset` (query i sits at cache
// slot q_offset + i, so a rectangular cached prefill with Lq < S works), an
// optional [B, S] slot mask (uint8/bool) is ANDed in. K/V carry as many
// heads as Q (a grouped-query caller repeats them first, as for the TPU
// kernel). Query rows that see no valid key (the pad rows of a left-padded
// prompt) store exact zeros, as the TPU kernel's `l == 0` guard does.
// With an `lse` pointer (the training forward, `_flash_vjp_fwd`) it also
// stores each row's log-sum-exp m + log(l) as fp32 [B, Lq, H]; a row with
// no valid key stores m (the masking sentinel), as the TPU kernel's
// `save_lse` does, so the backward's exp(s - lse) is then masked to 0.
// Serving passes a null pointer and stores no LSE.
//
// What bounds it on the H100: at the main path's shapes (ViT L=256/261,
// Llama prefill Lq~450 into S=cache_len~512, training L=448) the work is
// ~4*Lq*S*D operations against (2*Lq + 2*S)*D*2 bytes per head, ~60-130
// operations per byte: under the tensor cores' ~295 ridge, so a
// tensor-core kernel is bound by bytes (a few microseconds).
//
// bf16: tensor-core kernel (namespace `tc`), FlashAttention-2's forward
// on mma.sync m16n8k16 (csrc/mma.cuh, tiles through csrc/tc_tile.cuh).
// One block of 4 warps per (64 query rows, head, batch), 16 rows per warp;
// the tile index is the grid's slowest axis and runs backwards, so the
// heaviest causal tiles start first. Q is loaded once and its A fragments
// stay in registers; K/V tiles of 64 keys are double-buffered in
// XOR-swizzled shared memory, loaded with 16-byte cp.async where rows
// allow it (D % 8 == 0, strides and bases 16-byte aligned; element loads
// otherwise), with each key's valid flag beside its tile. Causal tiles
// above the diagonal are never loaded. S = Q K^T (K via ldmatrix); the
// online softmax runs on the C fragments (row max and sum over the 4
// lanes of a quad, exp2 with log2(e) folded into the scale, masked p
// exactly 0 through exp2(-inf)); P's fragments are rounded to bf16 and
// packed as the A fragments of O += P V (V via ldmatrix.trans). That is
// JAX's rounding (`p.astype(v.dtype)`, flash_attention.py:142); the sum
// l is taken over the fp32 p, as in JAX. D is zero-padded on-chip to 64,
// 80, 112 or 128. The stored LSE is in natural-log units; a row with no
// valid key stores the NEG_INF sentinel bit for bit (log2 units never
// reach memory: NEG_INF * log2(e) overflows fp32). No atomics: a rerun
// gives the same bits.
//
// fp32: the scalar kernel (namespace `scalar`; TF32 would not hold the
// fp32 tolerance): one block of 128 threads per (q tile of 64 rows, head,
// batch), both products as fp32 FMAs from shared memory on the CUDA cores
// (bound by the 67 TFLOP/s fp32 rate). Each thread owns a 4x8 micro-tile
// of the score tile (rows 4*rg.., cols cg+8j) and the same 4 rows x D/8
// columns of the output; D is padded to 64, 72 or 128; shared rows are
// padded by one float. It keeps P in fp32 for P V.

#include "common.cuh"
#include "mma.cuh"
#include "tc_tile.cuh"

namespace {

constexpr float NEG_INF = -2.3819763e38f;  // the JAX package's sentinel

// ------------------------------------------------------ scalar (fp32) ---

namespace scalar {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per KV tile
constexpr int NT = 128;     // threads per block

template <int DP>
constexpr int smem_bytes() {
  return (BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1)) *
         (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    float* __restrict__ o,
    float* __restrict__ lse, int H, int Lq, int S, int D, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh, long long m_sb,
    int causal, int q_offset, float sm_scale) {
  constexpr int QS = DP + 1;  // padded row stride of the Q and K tiles
  constexpr int PS = BK + 1;  // padded row stride of the P tile
  constexpr int NC = DP / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QS]
  float* Ks = Qs + BQ * QS;    // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][DP]
  float* Ps = Vs + BK * DP;    // [BQ][PS]

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows 4*rg .. 4*rg+3 of the tile
  const int cg = tid & 7;   // columns cg + 8*j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = kv_mask ? kv_mask + b * m_sb : nullptr;

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, d = i - (i / DP) * DP;
    float val = 0.f;
    if (q0 + r < Lq && d < D) val = qb[(q0 + r) * q_sl + d];
    Qs[r * QS + d] = val;
  }

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = __int_as_float(0xff800000);  // -inf
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys above the last query of this tile are never needed
  int kv_end = S;
  if (causal) kv_end = min(S, q_offset + q0 + BQ);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile's K/V/P fully consumed
    for (int i = tid; i < BK * DP; i += NT) {
      const int r = i / DP, d = i - (i / DP) * DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < S && d < D) {
        kv = kb[(k0 + r) * k_sl + d];
        vv = vb[(k0 + r) * v_sl + d];
      }
      Ks[r * QS + d] = kv;
      Vs[r * DP + d] = vv;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qa[4], ka[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(rg * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) ka[j] = Ks[(cg + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    bool ok[4][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kj = k0 + cg + 8 * j;
      bool col_ok = kj < S;
      if (col_ok && mb) col_ok = mb[kj] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + rg * 4 + i;
        ok[i][j] = col_ok && (!causal || kj <= q_offset + qi);
        s[i][j] = ok[i][j] ? s[i][j] * sm_scale : NEG_INF;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      // the 8 threads of a row group are adjacent lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // masked p is exactly 0, so a row with no valid key keeps l == 0
        const float p = ok[i][j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(rg * 4 + i) * PS + cg + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P tile complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], va[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(rg * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) va[c] = Vs[kk * DP + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
  }

  float* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Lq) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;  // zeros if no key
    if (lse && cg == 0)
      lse[((long long)b * Lq + row) * H + h] =
          m_i[i] + logf(l_i[i] > 0.f ? l_i[i] : 1.f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = cg + 8 * c;
      if (d < D) ob[row * o_sl + d] = acc[i][c] * inv;
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* lse, int B, int H,
                   int Lq, int S, int D, const long long* st, int causal,
                   int q_offset, float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), lse, H, Lq,
      S, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], causal, q_offset, sm_scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* o, float* lse, int B, int H,
                     int Lq, int S, int D, const long long* st, int causal,
                     int q_offset, float sm_scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, mask, o, lse, B, H, Lq, S, D, st, causal,
                      q_offset, sm_scale, stream);
  if (D <= 72)
    return launch<72>(q, k, v, mask, o, lse, B, H, Lq, S, D, st, causal,
                      q_offset, sm_scale, stream);
  if (D <= 128)
    return launch<128>(q, k, v, mask, o, lse, B, H, Lq, S, D, st, causal,
                       q_offset, sm_scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace scalar

// --------------------------------------------------- tensor core (bf16) ---

namespace tc {

using bf16 = __nv_bfloat16;
using emmax::mma::cp_async_commit;
using emmax::mma::cp_async_wait;
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
constexpr int TBQ = 16 * NW;     // query rows per block, 16 per warp
constexpr int TBK = 64;          // keys per K/V stage
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;
  bf16* o;
  float* lse;         // null or [B, Lq, H]
  int H, Lq, S, D;
  // strides in elements: (batch, row, head) of q, k, v, o; the mask's
  // batch stride
  long long st[13];
  int causal, q_offset;
  float sm_scale;
  int vec;            // rows allow 16-byte loads
};

template <int DP>
constexpr int smem_bytes() {
  return (TBQ + 4 * TBK) * row_len<DP>() * 2 + 2 * TBK;
}

template <int DP>
__global__ void __launch_bounds__(NTH) fwd_kernel(Args a) {
  constexpr int ROW = row_len<DP>();
  constexpr int NT = DP / 8;     // output n-tiles
  constexpr int KS = DP / 16;    // k-steps over D
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // [TBQ][ROW]
  bf16* Ks = Qs + TBQ * ROW;                    // [2][TBK][ROW]
  bf16* Vs = Ks + 2 * TBK * ROW;                // [2][TBK][ROW]
  uint8_t* ms = reinterpret_cast<uint8_t*>(Vs + 2 * TBK * ROW);  // [2][TBK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (a.Lq + TBQ - 1) / TBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * TBQ;  // last tile first
  const long long* st = a.st;
  const bool vec = a.vec != 0;

  const bf16* qb = a.q + b * st[0] + h * st[2];
  const bf16* kb = a.k + b * st[3] + h * st[5];
  const bf16* vb = a.v + b * st[6] + h * st[8];
  const uint8_t* mb = a.mask ? a.mask + b * st[12] : nullptr;

  // causal: keys past the tile's last query are never loaded
  int kv_end = a.S;
  if (a.causal) kv_end = min(a.S, a.q_offset + min(q0 + TBQ, a.Lq));
  const int n_kt = (kv_end + TBK - 1) / TBK;

  load_tile<TBQ, DP, NTH>(Qs, qb, st[1], q0, a.Lq, a.D, vec);
  if (n_kt > 0) {
    load_tile<TBK, DP, NTH>(Ks, kb, st[4], 0, a.S, a.D, vec);
    load_tile<TBK, DP, NTH>(Vs, vb, st[7], 0, a.S, a.D, vec);
    if (tid < TBK) ms[tid] = key_ok(a.S, mb, tid);
  }
  cp_async_commit();

  // this lane's query rows qr[0] and qr[0] + 8 (of the warp's 16)
  const int qr0 = q0 + warp * 16 + g;
  const float scale2 = a.sm_scale * LOG2E;
  const float NEG = __int_as_float(0xff800000);  // -inf

  uint32_t qf[KS][4];  // this warp's Q rows as A fragments
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // raw-score max, sum of p

  cp_async_wait<0>();
  __syncthreads();  // Q and tile 0 landed
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a<ROW>(qf[kk], Qs, warp * 16, kk, lane);

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1, k0 = it * TBK;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile `it` landed; every warp is done with it - 1
    }
    uint8_t m_next = 0;
    if (it + 1 < n_kt) {
      const int nb = (buf ^ 1) * TBK * ROW;
      load_tile<TBK, DP, NTH>(Ks + nb, kb, st[4], k0 + TBK, a.S, a.D, vec);
      load_tile<TBK, DP, NTH>(Vs + nb, vb, st[7], k0 + TBK, a.S, a.D, vec);
      if (tid < TBK) m_next = key_ok(a.S, mb, k0 + TBK + tid);
    }
    cp_async_commit();
    const bf16* Kt = Ks + buf * TBK * ROW;
    const bf16* Vt = Vs + buf * TBK * ROW;
    const uint8_t* mt = ms + buf * TBK;

    // S = Q K^T: this warp's 16 rows x 64 keys, raw (unscaled) fp32
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b<ROW>(bk, Kt, 16 * np, kk, lane);
        mma_16816(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // masked scores -> -inf; the row max over the quad's 4 lanes
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kc = 8 * n + 2 * t + (e & 1);
        const bool vis =
            mt[kc] && (!a.causal || k0 + kc <= a.q_offset + qr0 + 8 * i);
        s[n][e] = vis ? s[n][e] : NEG;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no valid key yet keeps m = -inf: subtract 0, not -inf
      mu[i] = m_new == NEG ? 0.f : m_new * scale2;
      alpha[i] = m_new == NEG ? 0.f : exp2f((m[i] - m_new) * scale2);
      m[i] = m_new;
    }

    // P = exp2(s * scale2 - m * scale2) (masked: exp2(-inf) = 0), its
    // fp32 row sums, and its bf16 A fragments for O += P V
    uint32_t ap[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[n][e], scale2, -mu[e >> 1]));
        rs[e >> 1] += p[e];
      }
      ap[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
      ap[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = alpha[i] * l[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        load_bt<ROW>(bv, Vt, 16 * kk, np, lane);
        mma_16816(acc[2 * np], ap[kk], bv[0], bv[1]);
        mma_16816(acc[2 * np + 1], ap[kk], bv[2], bv[3]);
      }
    if (it + 1 < n_kt && tid < TBK) ms[(buf ^ 1) * TBK + tid] = m_next;
  }

  bf16* ob = a.o + b * st[9] + h * st[11];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qr0 + 8 * i;
    if (row >= a.Lq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // zeros if no key
    if (a.lse && t == 0)
      a.lse[((long long)b * a.Lq + row) * a.H + h] =
          l[i] > 0.f ? m[i] * a.sm_scale + logf(l[i]) : NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int d = 8 * n + 2 * t + x;
        if (d < a.D)
          ob[row * st[10] + d] = __float2bfloat16(acc[n][2 * i + x] * inv);
      }
  }
}

template <int DP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, B, (a.Lq + TBQ - 1) / TBQ);
  fwd_kernel<DP><<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

int smem_of(int D) {
  if (D <= 64) return smem_bytes<64>();
  if (D <= 80) return smem_bytes<80>();
  if (D <= 112) return smem_bytes<112>();
  if (D <= 128) return smem_bytes<128>();
  return -1;
}

cudaError_t dispatch(const Args& a, int B, cudaStream_t s) {
  if (a.D <= 64) return launch<64>(a, B, s);
  if (a.D <= 80) return launch<80>(a, B, s);
  if (a.D <= 112) return launch<112>(a, B, s);
  if (a.D <= 128) return launch<128>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace

// strides[13]: q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h), mask (b);
// all in elements. `lse` is null (serving) or fp32 [B, Lq, H] contiguous.
// bf16 runs the tensor-core kernel, fp32 the scalar one.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int emmax_flash_fwd(const void* q, const void* k, const void* v,
                               const void* kv_mask, void* o, void* lse,
                               int B, int H, int Lq, int S, int D,
                               const long long* strides, int causal,
                               int q_offset, float sm_scale, int dtype,
                               void* stream) {
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == emmax::kBFloat16) {
    tc::Args a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.mask = mask;
    a.o = static_cast<__nv_bfloat16*>(o);
    a.lse = static_cast<float*>(lse);
    a.H = H;
    a.Lq = Lq;
    a.S = S;
    a.D = D;
    for (int i = 0; i < 13; ++i) a.st[i] = strides[i];
    a.causal = causal;
    a.q_offset = q_offset;
    a.sm_scale = sm_scale;
    a.vec = emmax::tc::rows_16b(D, strides, {q, k, v});
    err = tc::dispatch(a, B, s);
  } else if (dtype == emmax::kFloat32) {
    err = scalar::dispatch(q, k, v, mask, o, static_cast<float*>(lse), B,
                           H, Lq, S, D, strides, causal, q_offset, sm_scale,
                           s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of the bf16 kernel at head dim D; -1 past
// 128.
extern "C" int emmax_flash_fwd_smem_bytes(int D) { return tc::smem_of(D); }
