// Paged decode attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces: the upstream Pallas TPU kernel
// `jax.experimental.pallas.ops.tpu.paged_attention` (`paged_attention`,
// paged_attention_kernel.py, body `paged_flash_attention_kernel`), which
// emmax_tpu/serving/paged.py calls in `_paged_step_body` under
// paged_attn="kernel" (:347-365, the call at :362).
//
// What it computes: one query token per batch row b, over that row's pages:
//   out[b, k*G + g] = sum_t softmax_t(s_t) v_t,  s_t = q[b, k*G + g] . k_t
// for the row's tokens t < lengths[b], where token t lives at offset t % ps
// of page page_indices[b, t / ps] of KV head k (pages [KV, P, ps, hd]).
// Query head k*G + g reads KV head k (grouped-query attention). No
// 1/sqrt(hd) is applied: the caller pre-scales q, as for the TPU kernel.
// int8 pages carry fp32 per-row scales [KV, P, ps, 1] and decode as
// int8 * scale / 127.5 (the kernel's quantization_utils.from_int8); here
// the K scale multiplies the score and the V scale the probability, both
// in fp32, so no dequantized row is formed. A row of length 0 stores zeros.
// Everything runs in fp32 and the output is rounded once, to q's dtype
// (the TPU kernel re-rounds its bf16 output buffer once per compute block).
//
// What bounds it on the H100: bytes. Each valid token's K and V rows (plus
// their scales) must be read once, 2 * hd * (1 or 2 or 4) bytes per KV head
// per token, against 4 * G * hd operations: at G = 1 in bf16 that is one
// operation per byte, far under the ~295 operations per byte where the
// tensor cores become the limit, so the least time is the valid pages'
// bytes over 3.35 TB/s.
//
// Design: one block of 8 warps per (row b, KV head k, chunk of <= 8 query
// heads), so each (row, KV head)'s pages are read by one block, once, for
// all of its query heads; the G query heads' q rows sit in registers. The
// block reads its own page ids from page_indices[b], only the first
// ceil(length / ps) of them (entries past a row's length, -1 or a trash
// page, are never touched), clamped into [0, P) as an XLA gather clamps.
// The warps stride over the row's tokens; inside a warp each token takes
// lpt = next_pow2(hd / 8) lanes of 8 dims each (one 16-byte load per lane
// in bf16), so a warp reads 32 / lpt neighbouring tokens' rows, which sit
// contiguously in a page. Each lane group keeps its own online-softmax
// state (running max m, sum l, fp32 accumulator for its 8 dims) for the
// tokens it saw; the groups of a warp merge with shuffles, the warps in
// shared memory, and normalisation is deferred to the one store.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kDims = 8;           // head dims per lane
constexpr int kMaxHeadDim = 128;
constexpr unsigned kFull = 0xffffffffu;

// 8 consecutive elements of a row -> fp32 (16-, 32- or 8-byte loads)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < kDims; ++i) out[i] = static_cast<float>(c[i]);
}

// weight of a softmax state with running max m against the merged max mn
__device__ __forceinline__ float rescale(float m, float mn) {
  return m == -INFINITY ? 0.f : expf(m - mn);
}

template <typename TQ, typename TKV, int GC>
__global__ void __launch_bounds__(kWarps * 32) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ lengths,
    const int* __restrict__ page_indices, TQ* __restrict__ out, int H, int G,
    int P, int ps, int MP, int hd, int lpt) {
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];
  __shared__ float sm_acc[kWarps][GC][kMaxHeadDim];

  const int chunks = (G + GC - 1) / GC;
  const int kv = blockIdx.x / chunks;
  const int g0 = (blockIdx.x % chunks) * GC;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tpw = 32 / lpt;               // tokens per warp per step
  const int grp = lane / lpt;             // this lane's token in the step
  const int d0 = (lane % lpt) * kDims;    // this lane's first head dim
  const bool dims = d0 < hd;              // lanes past hd hold zeros
  const int len = min(max(lengths[b], 0), MP * ps);

  float qr[GC][kDims];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (dims && g0 + g < G) {
      load8(q + ((size_t)b * H + (size_t)kv * G + g0 + g) * hd + d0, qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < kDims; ++j) qr[g][j] = 0.f;
    }
  }

  float m[GC], l[GC], acc[GC][kDims];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[g][j] = 0.f;
  }

  const size_t head_rows = (size_t)P * ps;   // token rows per KV head
  const TKV* kh = k_pages + (size_t)kv * head_rows * hd;
  const TKV* vh = v_pages + (size_t)kv * head_rows * hd;
  const int* table = page_indices + (size_t)b * MP;

  // the loop bound depends on the warp only, so every lane takes part in
  // every shuffle; lanes whose token is past the length skip the update
  for (int base = warp * tpw; base < len; base += kWarps * tpw) {
    const int t = base + grp;
    const bool live = t < len;
    float kr[kDims], vr[kDims];
    float ks = 1.f, vs = 1.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) kr[j] = vr[j] = 0.f;
    if (live) {
      const int pid = min(max(table[t / ps], 0), P - 1);
      const size_t row = (size_t)pid * ps + t % ps;
      if (dims) {
        load8(kh + row * hd + d0, kr);
        load8(vh + row * hd + d0, vr);
      }
      if (k_scale != nullptr) {
        ks = k_scale[(size_t)kv * head_rows + row] / 127.5f;
        vs = v_scale[(size_t)kv * head_rows + row] / 127.5f;
      }
    }
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kDims; ++j) dot = fmaf(qr[g][j], kr[j], dot);
      for (int o = lpt >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(kFull, dot, o);
      s[g] = dot * ks;
    }
    if (live) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float mn = fmaxf(m[g], s[g]);
        const float c = rescale(m[g], mn);
        const float p = expf(s[g] - mn);
        l[g] = l[g] * c + p;
        const float pv = p * vs;
#pragma unroll
        for (int j = 0; j < kDims; ++j)
          acc[g][j] = fmaf(acc[g][j], c, pv * vr[j]);
        m[g] = mn;
      }
    }
  }

  // merge the lane groups of the warp (lanes that hold the same dims)
  for (int o = lpt; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float m2 = __shfl_xor_sync(kFull, m[g], o);
      const float l2 = __shfl_xor_sync(kFull, l[g], o);
      const float mn = fmaxf(m[g], m2);
      const float c1 = rescale(m[g], mn);
      const float c2 = rescale(m2, mn);
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const float a2 = __shfl_xor_sync(kFull, acc[g][j], o);
        acc[g][j] = acc[g][j] * c1 + a2 * c2;
      }
      l[g] = l[g] * c1 + l2 * c2;
      m[g] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (dims) {
#pragma unroll
        for (int j = 0; j < kDims; ++j) sm_acc[warp][g][d0 + j] = acc[g][j];
      }
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; one store per output element
  for (int idx = threadIdx.x; idx < GC * hd; idx += blockDim.x) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    if (g0 + g >= G) continue;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(sm_m[w][g], mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    out[((size_t)b * H + (size_t)kv * G + g0 + g) * hd + d] =
        emmax::from_f32<TQ>(den > 0.f ? num / den : 0.f);
  }
}

template <typename TQ, typename TKV, int GC>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale,
                   const int* lengths, const int* page_indices, void* out,
                   int B, int H, int KV, int P, int ps, int MP, int hd,
                   int lpt, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(KV * ((G + GC - 1) / GC), B);
  paged_attention_kernel<TQ, TKV, GC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scale, v_scale, lengths,
      page_indices, static_cast<TQ*>(out), H, G, P, ps, MP, hd, lpt);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_g(const void* q, const void* k_pages,
                       const void* v_pages, const float* k_scale,
                       const float* v_scale, const int* lengths,
                       const int* page_indices, void* out, int B, int H,
                       int KV, int P, int ps, int MP, int hd, int lpt,
                       cudaStream_t stream) {
  const int G = H / KV;
#define EMMAX_PAGED_LAUNCH(GC)                                              \
  return launch<TQ, TKV, GC>(q, k_pages, v_pages, k_scale, v_scale,         \
                             lengths, page_indices, out, B, H, KV, P, ps,   \
                             MP, hd, lpt, stream)
  if (G == 1) EMMAX_PAGED_LAUNCH(1);
  if (G == 2) EMMAX_PAGED_LAUNCH(2);
  if (G <= 4) EMMAX_PAGED_LAUNCH(4);
  EMMAX_PAGED_LAUNCH(8);  // G > 8 runs ceil(G / 8) head chunks
#undef EMMAX_PAGED_LAUNCH
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scale,
                        const float* v_scale, const int* lengths,
                        const int* page_indices, void* out, int B, int H,
                        int KV, int P, int ps, int MP, int hd, int lpt,
                        cudaStream_t stream) {
  if (kv_dtype == emmax::kFloat32)
    return dispatch_g<TQ, float>(q, k_pages, v_pages, nullptr, nullptr,
                                 lengths, page_indices, out, B, H, KV, P, ps,
                                 MP, hd, lpt, stream);
  if (kv_dtype == emmax::kBFloat16)
    return dispatch_g<TQ, __nv_bfloat16>(q, k_pages, v_pages, nullptr,
                                         nullptr, lengths, page_indices, out,
                                         B, H, KV, P, ps, MP, hd, lpt,
                                         stream);
  if (kv_dtype == emmax::kInt8 && k_scale != nullptr && v_scale != nullptr)
    return dispatch_g<TQ, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                  lengths, page_indices, out, B, H, KV, P, ps,
                                  MP, hd, lpt, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int emmax_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* k_scale,
                                     const void* v_scale,
                                     const void* lengths,
                                     const void* page_indices, void* out,
                                     int B, int H, int KV, int P, int ps,
                                     int MP, int hd, int q_dtype,
                                     int kv_dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd % kDims != 0 ||
      hd > kMaxHeadDim || ps <= 0 || MP <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int lpt = 1;
  while (lpt * kDims < hd) lpt <<= 1;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* len = static_cast<const int*>(lengths);
  const int* table = static_cast<const int*>(page_indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == emmax::kBFloat16)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, ks, vs,
                                     len, table, out, B, H, KV, P, ps, MP, hd,
                                     lpt, s);
  else if (q_dtype == emmax::kFloat32)
    err = dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, ks, vs, len,
                             table, out, B, H, KV, P, ps, MP, hd, lpt, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
