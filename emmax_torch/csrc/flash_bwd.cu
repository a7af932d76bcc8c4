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
//   dq = ds k,  dk = ds^T q,  dv = p^T do   (fp32 sums, p kept in fp32)
// with the forward's masking: causal at a scalar `q_offset`, an optional
// [B, S] slot mask, keys past S and queries past Lq. The layout is the
// model's [B, L, H, D] with any row/head/batch strides (unit stride on D).
//
// What bounds it on the H100: per valid (query, key) pair dQ does 6*D and
// dK/dV 8*D operations (s and dp are recomputed by both), against
// (4*Lq + 4*S)*D*2 bytes per head at bf16: at the training shapes (fused
// length ~450, D 128) ~300 operations per byte, at the tensor cores'
// ridge. This first version runs every product on the CUDA cores in fp32
// (scalar FMAs from shared memory), so it is bound by the 67 TFLOP/s fp32
// rate; an mma/wgmma version is later work.
//
// Design. No atomics: every output element has one writer, so a gradient
// is the same from run to run.
// - `flash_bwd_dq`: one block of 256 threads per (q tile of 64 rows, head,
//   batch) loops over 64-key tiles (the TPU kernel's sequential kv grid
//   axis), with Q, dO and the tile's lse/di resident in shared memory and
//   the dQ accumulator in registers. Causal tiles above the diagonal are
//   never loaded.
// - `flash_bwd_dkv`: one block per (kv tile of 64 keys, head, batch) loops
//   over the q tiles that can see it (causal: from the diagonal on), with K
//   and V resident and the dK and dV accumulators in registers. P and dS
//   go through shared memory, key-major, for the two transposed products.
//   With FUSED the block also writes this kv tile's dQ partial for every q
//   tile, zeros for the tiles it skips, into fp32 [n_kv_tiles, B, Lq, H, D].
// Each thread owns a 2 x 8 micro-tile of the 64 x 64 score tile (rows
// 2*rg.., columns cg + 8*j) and the same 2 rows x D/8 columns of its
// accumulators. D is padded on-chip to 64, 72 or 128 with zeros; shared
// rows are padded by one float so the strided reads are conflict-free.

#include "common.cuh"

namespace {

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // threads per block: 32 row groups x 8 columns
constexpr int RPT = 2;      // rows per thread (BQ == BK == RPT * NT / 8)

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
};

__device__ __forceinline__ bool visible(const Args& a, const uint8_t* mb,
                                        int qi, int kj) {
  if (qi >= a.Lq || kj >= a.S) return false;
  if (mb && mb[kj] == 0) return false;
  return !a.causal || kj <= a.q_offset + qi;
}

// rows [r0, r0 + 64) of a [rows, D] slice -> shared [64][DP + 1] fp32,
// zero past `rows` and past D
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int rows, int D) {
  constexpr int QS = DP + 1;
  for (int i = threadIdx.x; i < 64 * DP; i += NT) {
    const int r = i / DP, d = i - (i / DP) * DP;
    float val = 0.f;
    if (r0 + r < rows && d < D) val = emmax::to_f32(src[(r0 + r) * row_stride + d]);
    dst[r * QS + d] = val;
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return emmax::to_f32(emmax::from_f32<T>(x));
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (4 * 64 * (DP + 1) + BQ * (BK + 1)) * (int)sizeof(float);
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return (4 * 64 * (DP + 1) + 2 * BK * (BQ + 1)) * (int)sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
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

  const T* qb = static_cast<const T*>(a.q) + b * st[0] + h * st[2];
  const T* kb = static_cast<const T*>(a.k) + b * st[3] + h * st[5];
  const T* vb = static_cast<const T*>(a.v) + b * st[6] + h * st[8];
  const T* ob = static_cast<const T*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  load_tile<T, DP>(Qs, qb, st[1], q0, a.Lq, a.D);
  load_tile<T, DP>(dOs, ob, st[10], q0, a.Lq, a.D);
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
    load_tile<T, DP>(Ks, kb, st[4], k0, a.S, a.D);
    load_tile<T, DP>(Vs, vb, st[7], k0, a.S, a.D);
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
        dSs[r * PS + c] =
            round_to<T>(p * (dp[i][j] - di_s[r]) * a.sm_scale);
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

  T* dqb = static_cast<T*>(a.dq) + b * st[12] + h * st[14];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = cg + 8 * c;
      if (d < a.D) dqb[row * st[13] + d] = emmax::from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int DP, bool FUSED>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Args a) {
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

  const T* qb = static_cast<const T*>(a.q) + b * st[0] + h * st[2];
  const T* kb = static_cast<const T*>(a.k) + b * st[3] + h * st[5];
  const T* vb = static_cast<const T*>(a.v) + b * st[6] + h * st[8];
  const T* ob = static_cast<const T*>(a.dout) + b * st[9] + h * st[11];
  const uint8_t* mb = a.mask ? a.mask + b * st[21] : nullptr;

  load_tile<T, DP>(Ks, kb, st[4], k0, a.S, a.D);
  load_tile<T, DP>(Vs, vb, st[7], k0, a.S, a.D);

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
    load_tile<T, DP>(Qs, qb, st[1], q0, a.Lq, a.D);
    load_tile<T, DP>(dOs, ob, st[10], q0, a.Lq, a.D);
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
        dSs[r * PQ + c] =
            round_to<T>(p * (dp[i][j] - di_s[c]) * a.sm_scale);
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

  T* dkb = static_cast<T*>(a.dk) + b * st[15] + h * st[17];
  T* dvb = static_cast<T*>(a.dv) + b * st[18] + h * st[20];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + rg * RPT + i;
    if (row >= a.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = cg + 8 * c;
      if (d < a.D) {
        dkb[row * st[16] + d] = emmax::from_f32<T>(dk[i][c]);
        dvb[row * st[19] + d] = emmax::from_f32<T>(dv[i][c]);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP, bool FUSED>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DP, FUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BK - 1) / BK, a.H, a.B);
  flash_bwd_dkv_kernel<T, DP, FUSED><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, bool dkv, bool fused,
                     cudaStream_t stream) {
  if (!dkv) {
    if (a.D <= 64) return launch_dq<T, 64>(a, stream);
    if (a.D <= 72) return launch_dq<T, 72>(a, stream);
    if (a.D <= 128) return launch_dq<T, 128>(a, stream);
    return cudaErrorInvalidValue;
  }
  if (fused) {
    if (a.D <= 64) return launch_dkv<T, 64, true>(a, stream);
    if (a.D <= 72) return launch_dkv<T, 72, true>(a, stream);
    if (a.D <= 128) return launch_dkv<T, 128, true>(a, stream);
    return cudaErrorInvalidValue;
  }
  if (a.D <= 64) return launch_dkv<T, 64, false>(a, stream);
  if (a.D <= 72) return launch_dkv<T, 72, false>(a, stream);
  if (a.D <= 128) return launch_dkv<T, 128, false>(a, stream);
  return cudaErrorInvalidValue;
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
  if (dkv && fused && dq_part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == emmax::kBFloat16)
    err = dispatch<__nv_bfloat16>(a, dkv, fused != 0, s);
  else if (dtype == emmax::kFloat32)
    err = dispatch<float>(a, dkv, fused != 0, s);
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
// [ceil(S / 64), B, Lq, H, D] into dq_part.
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
