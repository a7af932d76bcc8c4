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
// Design (flash-decoding): the grid is (KV head x chunk of <= GC query
// heads, row b, split), where a split is a range of `pps` pages of the
// row's table; the wrapper picks pps from ps (ops/paged_attention.py's
// `split_pages`: ranges of at least 128 tokens) and n_split = ceil(MP /
// pps) follows, never from the lengths, so nothing is read back to the
// host and the launches can be captured in a CUDA graph. A block of 4 warps reads its own page ids, only those of
// tokens below the row's length (entries past it, -1 or a trash page, are
// never touched), clamped into [0, P) as an XLA gather clamps. Inside a
// warp each token takes `lpt` lanes of EL dims each, one 16-byte load per
// lane for every page dtype (fp32 4 dims, bf16 8, int8 16; int8 rows of a
// head dim that is not a multiple of 16 take 8-byte loads), so a warp
// reads 32 / lpt neighbouring tokens' rows; each lane group has kUnroll
// tokens' K and V chunks in flight before it uses the first. An int8
// row's two scales are read once per token, by the group's first lane, and
// broadcast. The GC query heads of a KV head share the block, so a row is
// read once for all of them (int8 keeps GC <= 4 to hold its 16 dims per
// lane in registers; G > GC takes ceil(G / GC) chunks). Each lane group
// keeps an online-softmax state (running max m, sum l, fp32 accumulator of
// its dims) per query head; the groups of a warp merge with shuffles, the
// warps in shared memory. The block stores its fp32 partial (m, l,
// acc[hd]) into a workspace (a split wholly past the row's length stores
// m = -inf, l = 0), and `merge_kernel` combines the n_split partials of
// each (row, head) in split order, with `rescale`'s guard for empty ones,
// and rounds once; with one split that is the block's own normalised sum.
// No atomics: a rerun gives the same bits.

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // warps per block
constexpr int kUnroll = 4;         // tokens per lane group in flight
constexpr int kMaxHeadDim = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;   // null unless int8 pages
  const float* v_scale;
  const int* lengths;
  const int* page_indices;
  void* out;
  float* ws;              // m, l [n_split, B, H], acc [n_split, B, H, hd]
  int B, H, G, P, ps, MP, hd, lpt, pps, n_split;
};

// one lane's chunk of a row: EL elements of T in 16 (or 8) bytes
template <typename T, int EL>
struct Chunk {
  static constexpr int kBytes = EL * (int)sizeof(T);
  static_assert(kBytes == 16 || kBytes == 8, "16- or 8-byte chunks");
  using Raw = typename std::conditional<kBytes == 16, uint4, uint2>::type;
};

template <typename T, int EL>
__device__ __forceinline__ typename Chunk<T, EL>::Raw load_chunk(
    const T* p) {
  return *reinterpret_cast<const typename Chunk<T, EL>::Raw*>(p);
}

// a chunk's EL elements -> fp32
template <int EL>
__device__ __forceinline__ void to_f32(const uint4& r, const float*,
                                       float (&out)[EL]) {
  static_assert(EL == 4, "fp32 chunks hold 4 elements");
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

template <int EL>
__device__ __forceinline__ void to_f32(const uint4& r, const __nv_bfloat16*,
                                       float (&out)[EL]) {
  static_assert(EL == 8, "bf16 chunks hold 8 elements");
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int EL, typename R>
__device__ __forceinline__ void to_f32(const R& r, const int8_t*,
                                       float (&out)[EL]) {
  static_assert(EL * 1 == sizeof(R), "int8 chunks hold 16 or 8 elements");
  const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
  for (int i = 0; i < EL; ++i) out[i] = static_cast<float>(c[i]);
}

// weight of a softmax state with running max m against the merged max mn
__device__ __forceinline__ float rescale(float m, float mn) {
  return m == -INFINITY ? 0.f : expf(m - mn);
}

template <typename TQ, typename TKV, int GC, int EL>
__global__ void __launch_bounds__(kWarps * 32) split_kernel(Args a) {
  using Raw = typename Chunk<TKV, EL>::Raw;
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];
  __shared__ float sm_acc[kWarps][GC][kMaxHeadDim];

  const int chunks = (a.G + GC - 1) / GC;
  const int kv = blockIdx.x / chunks;
  const int g0 = (blockIdx.x % chunks) * GC;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpt = a.lpt, hd = a.hd, ps = a.ps;
  const int tpw = 32 / lpt;               // tokens per warp per step
  const int grp = lane / lpt;             // this lane's token in the step
  const int src = grp * lpt;              // the group's first lane
  const int d0 = (lane - src) * EL;       // this lane's first head dim
  const bool dims = d0 < hd;              // lanes past hd hold zeros
  const int len = min(max(a.lengths[b], 0), a.MP * ps);
  const int t0 = split * a.pps * ps;
  const int t1 = min(len, t0 + a.pps * ps);
  const size_t bh0 = (size_t)b * a.H + (size_t)kv * a.G + g0;  // head g0
  const size_t plane = (size_t)a.n_split * a.B * a.H;          // ws plane

  if (t0 >= t1) {   // nothing of this row in this split (uniform per block)
    for (int idx = threadIdx.x; idx < GC * hd; idx += blockDim.x) {
      const int g = idx / hd, d = idx - g * hd;
      if (g0 + g >= a.G) continue;
      const size_t w = (size_t)split * a.B * a.H + bh0 + g;
      if (d == 0) {
        a.ws[w] = -INFINITY;
        a.ws[plane + w] = 0.f;
      }
      a.ws[2 * plane + w * hd + d] = 0.f;
    }
    return;
  }

  float qr[GC][EL];
  const TQ* q = static_cast<const TQ*>(a.q);
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int j = 0; j < EL; ++j)
      qr[g][j] = dims && g0 + g < a.G
                     ? emmax::to_f32<TQ>(q[(bh0 + g) * hd + d0 + j])
                     : 0.f;

  float m[GC], l[GC], acc[GC][EL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < EL; ++j) acc[g][j] = 0.f;
  }

  const size_t head_rows = (size_t)a.P * ps;   // token rows per KV head
  const TKV* kh = static_cast<const TKV*>(a.k_pages) + kv * head_rows * hd;
  const TKV* vh = static_cast<const TKV*>(a.v_pages) + kv * head_rows * hd;
  const int* table = a.page_indices + (size_t)b * a.MP;
  const bool quant = a.k_scale != nullptr;

  // the loop bound depends on the warp only, so every lane takes part in
  // every shuffle; a token past the split's end is not live
  for (int base = t0 + warp * tpw * kUnroll; base < t1;
       base += kWarps * tpw * kUnroll) {
    Raw kr[kUnroll], vr[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * tpw + grp;
      live[u] = t < t1;
      kr[u] = vr[u] = Raw{};
      ks[u] = vs[u] = 1.f;
      if (live[u]) {
        const int pid = min(max(table[t / ps], 0), a.P - 1);
        const size_t row = (size_t)pid * ps + t % ps;
        if (dims) {
          kr[u] = load_chunk<TKV, EL>(kh + row * hd + d0);
          vr[u] = load_chunk<TKV, EL>(vh + row * hd + d0);
        }
        if (quant && lane == src) {
          ks[u] = a.k_scale[kv * head_rows + row];
          vs[u] = a.v_scale[kv * head_rows + row];
        }
      }
    }
    if (quant) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ks[u] = __shfl_sync(kFull, ks[u], src) / 127.5f;
        vs[u] = __shfl_sync(kFull, vs[u], src) / 127.5f;
      }
    }

    // scores: each lane's partial dot, summed over the group's lanes
    float s[GC][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[EL];
      to_f32<EL>(kr[u], (const TKV*)nullptr, kf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < EL; ++j) dot = fmaf(qr[g][j], kf[j], dot);
        s[g][u] = dot;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        for (int o = lpt >> 1; o > 0; o >>= 1)
          s[g][u] += __shfl_xor_sync(kFull, s[g][u], o);
        s[g][u] *= ks[u];
      }

    // the online softmax over this step's live tokens
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (live[u]) mn = fmaxf(mn, s[g][u]);
      const float c = rescale(m[g], mn);
      float ps_sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[g][u] = live[u] ? expf(s[g][u] - mn) : 0.f;   // p
        ps_sum += s[g][u];
        s[g][u] *= vs[u];
      }
      l[g] = l[g] * c + ps_sum;
      m[g] = mn;
#pragma unroll
      for (int j = 0; j < EL; ++j) acc[g][j] *= c;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[EL];
      to_f32<EL>(vr[u], (const TKV*)nullptr, vf);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int j = 0; j < EL; ++j)
          acc[g][j] = fmaf(s[g][u], vf[j], acc[g][j]);
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
      for (int j = 0; j < EL; ++j) {
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
        for (int j = 0; j < EL; ++j)
          if (d0 + j < hd) sm_acc[warp][g][d0 + j] = acc[g][j];
      }
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps into this split's partial
  for (int idx = threadIdx.x; idx < GC * hd; idx += blockDim.x) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    if (g0 + g >= a.G) continue;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(sm_m[w][g], mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    const size_t w = (size_t)split * a.B * a.H + bh0 + g;
    if (d == 0) {
      a.ws[w] = mx;
      a.ws[plane + w] = den;
    }
    a.ws[2 * plane + w * hd + d] = num;
  }
}

// out[b, h] from the n_split partials of (b, h), in split order
template <typename TQ>
__global__ void __launch_bounds__(128) merge_kernel(Args a) {
  const size_t i = (size_t)blockIdx.y * a.H + blockIdx.x;   // b * H + h
  const size_t bh = (size_t)a.B * a.H;
  const size_t plane = (size_t)a.n_split * bh;
  const float* wm = a.ws;
  const float* wl = a.ws + plane;
  const float* wacc = a.ws + 2 * plane;
  float mx = -INFINITY;
  for (int s = 0; s < a.n_split; ++s) mx = fmaxf(mx, wm[s * bh + i]);
  float den = 0.f;
  for (int s = 0; s < a.n_split; ++s)
    den += wl[s * bh + i] * rescale(wm[s * bh + i], mx);
  for (int d = threadIdx.x; d < a.hd; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < a.n_split; ++s)
      num += wacc[(s * bh + i) * a.hd + d] * rescale(wm[s * bh + i], mx);
    static_cast<TQ*>(a.out)[i * a.hd + d] =
        emmax::from_f32<TQ>(den > 0.f ? num / den : 0.f);
  }
}

template <typename TQ, typename TKV, int GC, int EL>
cudaError_t launch(const Args& a, int KV, cudaStream_t stream) {
  const dim3 grid(KV * ((a.G + GC - 1) / GC), a.B, a.n_split);
  split_kernel<TQ, TKV, GC, EL><<<grid, kWarps * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<TQ><<<dim3(a.H, a.B), 128, 0, stream>>>(a);
  return cudaGetLastError();
}

// query heads per block: up to 8, and up to 4 for 16 dims a lane
template <typename TQ, typename TKV, int EL>
cudaError_t dispatch_g(const Args& a, int KV, cudaStream_t stream) {
  constexpr int kMaxGC = EL > 8 ? 4 : 8;
  if (a.G == 1) return launch<TQ, TKV, 1, EL>(a, KV, stream);
  if (a.G == 2) return launch<TQ, TKV, 2, EL>(a, KV, stream);
  if (a.G <= 4 || kMaxGC == 4) return launch<TQ, TKV, 4, EL>(a, KV, stream);
  return launch<TQ, TKV, kMaxGC, EL>(a, KV, stream);
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, Args& a, int KV, cudaStream_t s) {
  if (kv_dtype == emmax::kFloat32 && !a.k_scale)
    return dispatch_g<TQ, float, 4>(a, KV, s);
  if (kv_dtype == emmax::kBFloat16 && !a.k_scale)
    return dispatch_g<TQ, __nv_bfloat16, 8>(a, KV, s);
  if (kv_dtype == emmax::kInt8 && a.k_scale && a.v_scale)
    return a.hd % 16 == 0 ? dispatch_g<TQ, int8_t, 16>(a, KV, s)
                          : dispatch_g<TQ, int8_t, 8>(a, KV, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// pps: pages per range, so n_split = ceil(MP / pps) ranges. ws: the
// caller's fp32 workspace of n_split * B * H * (hd + 2) floats (the
// partials' m, l and acc planes). Returns the cudaError_t of the two
// launches (0 = success).
extern "C" int emmax_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* k_scale,
                                     const void* v_scale,
                                     const void* lengths,
                                     const void* page_indices, void* out,
                                     void* ws, int B, int H, int KV, int P,
                                     int ps, int MP, int hd, int pps,
                                     int q_dtype, int kv_dtype,
                                     void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd % 8 != 0 ||
      hd > kMaxHeadDim || ps <= 0 || MP <= 0 || P <= 0 || pps <= 0 ||
      ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.lengths = static_cast<const int*>(lengths);
  a.page_indices = static_cast<const int*>(page_indices);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.B = B;
  a.H = H;
  a.G = H / KV;
  a.P = P;
  a.ps = ps;
  a.MP = MP;
  a.hd = hd;
  a.pps = pps;
  a.n_split = (MP + pps - 1) / pps;
  const int bytes = kv_dtype == emmax::kFloat32 ? 4
                    : kv_dtype == emmax::kBFloat16 ? 2 : 1;
  const int el = kv_dtype == emmax::kInt8 && hd % 16 ? 8 : 16 / bytes;
  a.lpt = 1;
  while (a.lpt * el < hd) a.lpt <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == emmax::kBFloat16)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, a, KV, s);
  else if (q_dtype == emmax::kFloat32)
    err = dispatch_kv<float>(kv_dtype, a, KV, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
