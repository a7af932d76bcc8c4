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
// fp32: tensor-core kernel (namespace `tf32`), the same FlashAttention-2
// forward on mma.sync m16n8k8 with tf32 operands, in 3xTF32: every operand
// x is split as big = rna(x), small = rna(x - big) (csrc/mma.cuh's
// split_tf32) and each product is taken as small*big + big*small +
// big*big into fp32 accumulators, which keeps fp32's accuracy (one TF32
// product alone is ~1e-3 off). P stays fp32, as JAX's fp32 kernel keeps
// it. One block of 4 warps per (32 query rows, head, batch), so the towers
// at batch 1 (L 256 / 261, 16 heads) launch 128 / 144 blocks for 132 SMs
// and each block has a warp on each of the SM's 4 schedulers: warps 0 and
// 1 (16 rows each) take the first 32 keys of every 64-key stage, warps 2
// and 3 the other 32, each pair with its own online-softmax state, and the
// second pair's state is merged into the first's at the end (in that
// order, through shared memory). K/V stages are double-buffered with
// 16-byte cp.async where rows allow it (D % 4 == 0, strides and bases
// 16-byte aligned; 4-byte cp.async otherwise); fp32 rows are padded to DP
// + 4 floats (DP + 4 = 4 mod 8), so
// the 32-bit fragment reads of Q, K (rows g, columns t) and V (rows 2t,
// columns g) hit 32 different banks. Q's split A fragments stay in
// registers for DP <= 72 and are re-read and split from shared memory per
// k-step at DP 128. P's C fragment feeds O += P V as the A fragment
// without moving data: a lane holds keys 2t, 2t + 1 where the A fragment
// wants k indices t, t + 4, so V's B fragment reads key rows in that
// permuted order (k t <-> key 2t, k t + 4 <-> key 2t + 1). Masking, the
// exact zeros, the LSE (natural-log units, NEG_INF sentinel), causal tile
// skipping and the tile order are the bf16 kernel's. D is zero-padded
// on-chip to 64, 72 or 128. Bound: at the towers' shapes the function is
// ~64 operations per byte (SigLIP B1: 0.30 GFLOP over 4.7 MB), which the
// 67 TFLOP/s of fp32 FMAs would make operation-bound (4.5 us); three TF32
// products at 495 TFLOP/s take 1.8 us, near the 1.4 us of its bytes.

#include "common.cuh"
#include "mma.cuh"
#include "tc_tile.cuh"
#include "tf32_tile.cuh"

namespace {

constexpr float NEG_INF = -2.3819763e38f;  // the JAX package's sentinel
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const uint8_t* mask;
  T* o;
  float* lse;         // null or [B, Lq, H]
  int H, Lq, S, D;
  // strides in elements: (batch, row, head) of q, k, v, o; the mask's
  // batch stride
  long long st[13];
  int causal, q_offset;
  float sm_scale;
  int vec;            // rows allow 16-byte loads
};

// ---------------------------------------------------- 3xTF32 (fp32) ---

namespace tf32 {

using emmax::mma::cp_async_commit;
using emmax::mma::cp_async_wait;
using emmax::mma::mma_1688_tf32;
using emmax::mma::split_tf32;
using emmax::tc::key_ok;
using emmax::tf32::load_a;
using emmax::tf32::load_tile;
using emmax::tf32::row_len;

constexpr int KH = 2;            // warp pairs: key halves of a stage
constexpr int NW = 2 * KH;       // warps per block
constexpr int NTH = 32 * NW;     // threads per block
constexpr int TBQ = 32;          // query rows per block, 16 per warp
constexpr int KW = 32;           // keys per warp per stage
constexpr int TBK = KW * KH;     // keys per K/V stage
constexpr int NK = KW / 8;       // key n-tiles per warp and stage

template <int DP>
constexpr int smem_bytes() {
  return (TBQ + 4 * TBK) * row_len<DP>() * 4 + 2 * TBK;
}

// (NTH, 1): without the block count ptxas held DP 64 to 168 registers
// (three blocks an SM) and spilled; with it, 180 and no spills
template <int DP>
__global__ void __launch_bounds__(NTH, 1) fwd_kernel(Args<float> a) {
  constexpr int ROW = row_len<DP>();
  constexpr int KS = DP / 8;            // k-steps over D = output n-tiles
  constexpr bool QREG = DP <= 72;       // Q's split fragments in registers
  constexpr int NDC = KS <= 9 ? KS : 8; // output n-tiles per MMA round
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);  // [TBQ][ROW]
  float* Ks = Qs + TBQ * ROW;                      // [2][TBK][ROW]
  float* Vs = Ks + 2 * TBK * ROW;                  // [2][TBK][ROW]
  uint8_t* ms = reinterpret_cast<uint8_t*>(Vs + 2 * TBK * ROW);  // [2][TBK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 1;         // the warp's 16 query rows of the tile
  const int kh = warp >> 1;        // the warp's 32 keys of each stage
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (a.Lq + TBQ - 1) / TBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * TBQ;  // last tile first
  const long long* st = a.st;
  const bool vec = a.vec != 0;

  const float* qb = a.q + b * st[0] + h * st[2];
  const float* kb = a.k + b * st[3] + h * st[5];
  const float* vb = a.v + b * st[6] + h * st[8];
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

  // this lane's query rows qr0 and qr0 + 8 (of the warp's 16)
  const int qr0 = q0 + rw * 16 + g;
  const float scale2 = a.sm_scale * LOG2E;
  const float NEG = __int_as_float(0xff800000);  // -inf
  const float* Qw = Qs + rw * 16 * ROW;

  uint32_t qbig[QREG ? KS : 1][4], qsmall[QREG ? KS : 1][4];
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // raw-score max, sum of p

  cp_async_wait<0>();
  __syncthreads();  // Q and tile 0 landed
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      load_a<ROW>(qbig[kk], qsmall[kk], Qw, 0, kk, g, t);
  }

  for (int it = 0; it < n_kt; ++it) {
    const int buf = it & 1;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile `it` landed; every warp is done with it - 1
    }
    uint8_t m_next = 0;
    if (it + 1 < n_kt) {
      const int nb = (buf ^ 1) * TBK * ROW, k1 = (it + 1) * TBK;
      load_tile<TBK, DP, NTH>(Ks + nb, kb, st[4], k1, a.S, a.D, vec);
      load_tile<TBK, DP, NTH>(Vs + nb, vb, st[7], k1, a.S, a.D, vec);
      if (tid < TBK) m_next = key_ok(a.S, mb, k1 + tid);
    }
    cp_async_commit();
    // this warp's keys k0 .. k0 + 31 of the stage
    const int k0 = it * TBK + kh * KW;
    const float* Kt = Ks + (buf * TBK + kh * KW) * ROW;
    const float* Vt = Vs + (buf * TBK + kh * KW) * ROW;
    const uint8_t* mt = ms + buf * TBK + kh * KW;

    // S = Q K^T: this warp's 16 rows x 32 keys, raw (unscaled) fp32; K's B
    // fragment is its row (key) 8n + g, dims 8kk + t and + 4
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qbig[kk][e];
          as[e] = qsmall[kk][e];
        }
      } else {
        load_a<ROW>(ab, as, Qw, 0, kk, g, t);
      }
      uint32_t bb[NK][2], bs[NK][2];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          split_tf32(Kt[(8 * n + g) * ROW + 8 * kk + t + 4 * x], bb[n][x],
                     bs[n][x]);
#pragma unroll
      for (int n = 0; n < NK; ++n) mma_1688_tf32(s[n], as, bb[n][0], bb[n][1]);
#pragma unroll
      for (int n = 0; n < NK; ++n) mma_1688_tf32(s[n], ab, bs[n][0], bs[n][1]);
#pragma unroll
      for (int n = 0; n < NK; ++n) mma_1688_tf32(s[n], ab, bb[n][0], bb[n][1]);
    }

    // masked scores -> -inf; the row max over the quad's 4 lanes
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NK; ++n)
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

    // P = exp2(s * scale2 - m * scale2) in fp32 (masked: exp2(-inf) = 0)
    // and its row sums
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(fmaf(s[n][e], scale2, -mu[e >> 1]));
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = alpha[i] * l[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V per 8 keys: P's C fragment {(g, 2t), (g, 2t+1), (g+8, 2t),
    // (g+8, 2t+1)} is the A fragment {a0 (g, k t), a1 (g+8, t), a2 (g,
    // t+4), a3 (g+8, t+4)} with k t <-> key 2t, k t + 4 <-> key 2t + 1;
    // V's B fragment reads key rows 8n + 2t and 8n + 2t + 1, column 8d + g
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t pb[4], ps[4];
      split_tf32(s[n][0], pb[0], ps[0]);
      split_tf32(s[n][2], pb[1], ps[1]);
      split_tf32(s[n][1], pb[2], ps[2]);
      split_tf32(s[n][3], pb[3], ps[3]);
      const float* v0 = Vt + (8 * n + 2 * t) * ROW + g;
#pragma unroll
      for (int d0 = 0; d0 < KS; d0 += NDC) {
        uint32_t vbb[NDC][2], vbs[NDC][2];
#pragma unroll
        for (int j = 0; j < NDC; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            if (d0 + j < KS)
              split_tf32(v0[x * ROW + 8 * (d0 + j)], vbb[j][x], vbs[j][x]);
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (d0 + j < KS)
            mma_1688_tf32(acc[d0 + j], ps, vbb[j][0], vbb[j][1]);
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (d0 + j < KS)
            mma_1688_tf32(acc[d0 + j], pb, vbs[j][0], vbs[j][1]);
#pragma unroll
        for (int j = 0; j < NDC; ++j)
          if (d0 + j < KS)
            mma_1688_tf32(acc[d0 + j], pb, vbb[j][0], vbb[j][1]);
      }
    }
    if (it + 1 < n_kt && tid < TBK) ms[(buf ^ 1) * TBK + tid] = m_next;
  }

  // merge the key halves' states into warp pair 0, in key-half order,
  // through the K buffers: entry j of lane (pair kh, row warp rw) at
  // ((kh - 1) * XS + j) * 64 + rw * 32 + lane
  constexpr int XS = 4 + 4 * KS;   // m[2], l[2], acc[KS][4]
  static_assert((KH - 1) * XS * 64 <= 2 * TBK * ROW, "merge fits in K");
  __syncthreads();                 // every warp is done with the tiles
  float* xs = Ks + rw * 32 + lane;
  if (kh > 0) {
    float* x = xs + (kh - 1) * XS * 64;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      x[i * 64] = m[i];
      x[(2 + i) * 64] = l[i];
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(4 + 4 * n + e) * 64] = acc[n][e];
  }
  __syncthreads();
  if (kh > 0) return;
  for (int p = 1; p < KH; ++p) {
    const float* x = xs + (p - 1) * XS * 64;
    float c1[2], c2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m2 = x[i * 64], l2 = x[(2 + i) * 64];
      const float mn = fmaxf(m[i], m2);
      // a half that saw no valid key has m = -inf: weight 0, not NaN
      c1[i] = m[i] == NEG ? 0.f : exp2f((m[i] - mn) * scale2);
      c2[i] = m2 == NEG ? 0.f : exp2f((m2 - mn) * scale2);
      l[i] = l[i] * c1[i] + l2 * c2[i];
      m[i] = mn;
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * c1[e >> 1] +
                    x[(4 + 4 * n + e) * 64] * c2[e >> 1];
  }

  float* ob = a.o + b * st[9] + h * st[11];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qr0 + 8 * i;
    if (row >= a.Lq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // zeros if no key
    if (a.lse && t == 0)
      a.lse[((long long)b * a.Lq + row) * a.H + h] =
          l[i] > 0.f ? m[i] * a.sm_scale + logf(l[i]) : NEG_INF;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int d = 8 * n + 2 * t + x;
        if (d < a.D) ob[row * st[10] + d] = acc[n][2 * i + x] * inv;
      }
  }
}

template <int DP>
cudaError_t launch(const Args<float>& a, int B, cudaStream_t stream) {
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
  if (D <= 72) return smem_bytes<72>();
  if (D <= 128) return smem_bytes<128>();
  return -1;
}

cudaError_t dispatch(const Args<float>& a, int B, cudaStream_t s) {
  if (a.D <= 64) return launch<64>(a, B, s);
  if (a.D <= 72) return launch<72>(a, B, s);
  if (a.D <= 128) return launch<128>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace tf32

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

template <int DP>
constexpr int smem_bytes() {
  return (TBQ + 4 * TBK) * row_len<DP>() * 2 + 2 * TBK;
}

template <int DP>
__global__ void __launch_bounds__(NTH) fwd_kernel(Args<bf16> a) {
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
cudaError_t launch(const Args<bf16>& a, int B, cudaStream_t stream) {
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

cudaError_t dispatch(const Args<bf16>& a, int B, cudaStream_t s) {
  if (a.D <= 64) return launch<64>(a, B, s);
  if (a.D <= 80) return launch<80>(a, B, s);
  if (a.D <= 112) return launch<112>(a, B, s);
  if (a.D <= 128) return launch<128>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace

namespace {

template <typename T, int E>
Args<T> make_args(const void* q, const void* k, const void* v,
                  const uint8_t* mask, void* o, void* lse, int H, int Lq,
                  int S, int D, const long long* strides, int causal,
                  int q_offset, float sm_scale) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.mask = mask;
  a.o = static_cast<T*>(o);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Lq = Lq;
  a.S = S;
  a.D = D;
  for (int i = 0; i < 13; ++i) a.st[i] = strides[i];
  a.causal = causal;
  a.q_offset = q_offset;
  a.sm_scale = sm_scale;
  a.vec = emmax::tc::rows_16b<E>(D, strides, {q, k, v});
  return a;
}

}  // namespace

// strides[13]: q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h), mask (b);
// all in elements. `lse` is null (serving) or fp32 [B, Lq, H] contiguous.
// bf16 runs the bf16 tensor-core kernel, fp32 the 3xTF32 one.
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
    err = tc::dispatch(make_args<__nv_bfloat16, 8>(
                           q, k, v, mask, o, lse, H, Lq, S, D, strides,
                           causal, q_offset, sm_scale),
                       B, s);
  else if (dtype == emmax::kFloat32)
    err = tf32::dispatch(make_args<float, 4>(q, k, v, mask, o, lse, H, Lq,
                                             S, D, strides, causal,
                                             q_offset, sm_scale),
                         B, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of the kernel for `dtype` at head dim D;
// -1 past 128.
extern "C" int emmax_flash_fwd_smem_bytes(int D, int dtype) {
  return dtype == emmax::kFloat32 ? tf32::smem_of(D) : tc::smem_of(D);
}
