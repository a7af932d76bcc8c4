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
// Llama prefill Lq~450 into S=cache_len~512) the work is ~4*Lq*S*D
// operations against (2*Lq + 2*S)*D*2 bytes per head, ~60-130 operations
// per byte: under the tensor cores' ~295 ridge, so a tensor-core kernel
// would be bound by bytes (a few microseconds). This first version runs
// the two products on the CUDA cores in fp32 (scalar FMAs from shared
// memory), where the 67 TFLOP/s fp32 rate makes it bound by operations
// and ~50x off the byte bound; an mma/wgmma + TMA version is later work.
//
// Design: one block of 128 threads per (q tile of 64 rows, head, batch).
// The TPU kernel's sequential KV grid axis becomes a loop over 64-key tiles
// inside the block, carrying the online-softmax state (running max m, sum
// l, fp32 accumulator) in registers; normalisation is deferred to the
// store. Causal tiles entirely above the diagonal are never loaded. Each
// thread owns a 4x8 micro-tile of the score tile (rows 4*rg.., cols cg+8j)
// and the same 4 rows x D/8 columns of the output. D is padded on-chip to
// 64, 72 or 128 (zero-filled, so SigLIP's head dim 72 needs no host-side
// pad). Shared-memory rows are padded by one float to keep the strided
// reads conflict-free.

#include "common.cuh"

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per KV tile
constexpr int NT = 128;     // threads per block
constexpr float NEG_INF = -2.3819763e38f;  // the JAX package's sentinel

template <int DP>
constexpr int smem_bytes() {
  return (BQ * (DP + 1) + BK * (DP + 1) + BK * DP + BQ * (BK + 1)) *
         (int)sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, T* __restrict__ o,
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const uint8_t* mb = kv_mask ? kv_mask + b * m_sb : nullptr;

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, d = i - (i / DP) * DP;
    float val = 0.f;
    if (q0 + r < Lq && d < D) val = emmax::to_f32(qb[(q0 + r) * q_sl + d]);
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
        kv = emmax::to_f32(kb[(k0 + r) * k_sl + d]);
        vv = emmax::to_f32(vb[(k0 + r) * v_sl + d]);
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

  T* ob = o + b * o_sb + h * o_sh;
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
      if (d < D) ob[row * o_sl + d] = emmax::from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* lse, int B, int H,
                   int Lq, int S, int D, const long long* st, int causal,
                   int q_offset, float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, Lq, S, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], causal, q_offset, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const uint8_t* mask, void* o, float* lse, int B,
                       int H, int Lq, int S, int D, const long long* st,
                       int causal,
                       int q_offset, float sm_scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, mask, o, lse, B, H, Lq, S, D, st, causal,
                         q_offset, sm_scale, stream);
  if (D <= 72)
    return launch<T, 72>(q, k, v, mask, o, lse, B, H, Lq, S, D, st, causal,
                         q_offset, sm_scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, mask, o, lse, B, H, Lq, S, D, st, causal,
                          q_offset, sm_scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// strides[13]: q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h), mask (b);
// all in elements. `lse` is null (serving) or fp32 [B, Lq, H] contiguous.
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
  if (dtype == emmax::kBFloat16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, mask, o,
                                    static_cast<float*>(lse), B, H, Lq, S, D,
                                    strides, causal, q_offset, sm_scale, s);
  else if (dtype == emmax::kFloat32)
    err = dispatch_d<float>(q, k, v, mask, o, static_cast<float*>(lse), B, H,
                            Lq, S, D, strides, causal, q_offset, sm_scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
