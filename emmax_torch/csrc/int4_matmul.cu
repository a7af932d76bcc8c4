// Int4 weight-only matmul for Hopper (sm_90a), bound with ctypes.
//
// Replaces: the Pallas TPU kernels `_int4_matmul_pallas` and
// `_int4_matmul_pallas_stacked` (emmax_tpu/ops/int4_matmul.py:329-418,
// pallas_calls at :345 and :404; body `_kernel` at :281-326). One kernel
// serves both: for a stacked [L, D/2, F] weight the wrapper passes the
// pointer of layer l, so no per-layer copy is ever made.
//
// What it computes: out[M, F] = x[M, D] @ dequant(q4, scale), with the
// JAX package's format unchanged: q4 [D/2, F] int8, byte b[p, f] holds
// original row p in its low nibble (stored +8, unsigned) and row p + D/2
// in its high nibble (two's complement, so `(int8)b >> 4` gives it);
// scale [D/group, F] bf16; mid-rise decode w = (q + 0.5) * s. Sums are
// fp32; the output has x's dtype.
//
// What bounds it on the H100: decode (M = 1 .. 48) reads every weight byte
// once and does 2*M flops per weight, far below the ~295 flops/byte
// ridge, so it is bound by the 3.35 TB/s of HBM: the weight bytes
// (D*F/2 + 2*F*D/group) are the cost. Prefill (M ~ 384) is compute-bound;
// this version does the products on the CUDA cores in fp32, so prefill
// runs far from the tensor-core bound (a known slow tile, written down in
// PERF.md).
//
// Design: a block of 4 warps owns 128 output columns (4 per lane, one
// 32-bit load of 4 packed bytes per row, so a warp reads 128 contiguous
// bytes of a row) and MT rows of x. The packed rows are walked one
// quantisation group at a time: the block stages that group's x values
// (both nibble planes) in shared memory, each warp takes every 4th packed
// row, unpacks both nibbles in registers and accumulates per plane in
// fp32; the group scale is applied once per group to the partial sums
// (BM*BN multiplies instead of group*BN), as the TPU kernel does. At
// decode sizes there are too few column tiles to fill 132 SMs, so the
// groups are split over gridDim.y (split-K); the per-split partial sums go
// to an fp32 scratch that a second small kernel reduces into the output.
// The ragged column edge (lm_head F = 32064) is masked per lane; `group`
// is a runtime argument (the JAX quantiser shrinks it for tiny dims).

#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per block (4 warps)
constexpr int BN = 128;   // output columns per block

template <typename T, int MT>
__global__ void __launch_bounds__(NT) int4_mm_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q4,
    const __nv_bfloat16* __restrict__ scale, float* __restrict__ part,
    T* __restrict__ out, int M, int D, int F, int group, int gps) {
  extern __shared__ float smem[];
  float* xs = smem;                   // [MT][2][group]: lo plane, hi plane
  float* red = smem + MT * 2 * group;  // [4 warps][MT][BN]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * BN + lane * 4;
  const int ks = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int D2 = D >> 1;
  const int Gh = D2 / group;
  const int g_begin = ks * gps;
  const int g_end = min(Gh, g_begin + gps);
  const bool col_ok = c0 < F;  // F % 4 == 0, checked by the wrapper

  float tot[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[m][j] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    __syncthreads();  // previous group's x no longer read
    for (int i = threadIdx.x; i < MT * group; i += NT) {
      const int m = i / group, r = i - (i / group) * group;
      float lo = 0.f, hi = 0.f;
      if (m0 + m < M) {
        const T* xr = x + (long long)(m0 + m) * D + g * group + r;
        lo = emmax::to_f32(xr[0]);
        hi = emmax::to_f32(xr[D2]);
      }
      xs[(2 * m) * group + r] = lo;
      xs[(2 * m + 1) * group + r] = hi;
    }
    __syncthreads();
    if (!col_ok) continue;

    float alo[MT][4], ahi[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) alo[m][j] = ahi[m][j] = 0.f;

    const int8_t* wp = q4 + (long long)g * group * F + c0;
#pragma unroll 8
    for (int r = warp; r < group; r += 4) {
      const int w = __ldg(reinterpret_cast<const int*>(wp + (long long)r * F));
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = (int)(signed char)(w >> (8 * j));
        lo[j] = (float)(b & 15) - 7.5f;  // biased low nibble, mid-rise
        hi[j] = (float)(b >> 4) + 0.5f;  // signed high nibble, mid-rise
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs[(2 * m) * group + r];
        const float xh = xs[(2 * m + 1) * group + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          alo[m][j] = fmaf(xl, lo[j], alo[m][j]);
          ahi[m][j] = fmaf(xh, hi[j], ahi[m][j]);
        }
      }
    }
    float slo[4], shi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      slo[j] = __bfloat162float(scale[(long long)g * F + c0 + j]);
      shi[j] = __bfloat162float(scale[(long long)(Gh + g) * F + c0 + j]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tot[m][j] += alo[m][j] * slo[j] + ahi[m][j] * shi[j];
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * MT + m) * BN + lane * 4 + j] = tot[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * BN; i += NT) {
    const int m = i / BN, c = i - (i / BN) * BN;
    const int col = blockIdx.x * BN + c;
    if (m0 + m >= M || col >= F) continue;
    const float sum = red[(0 * MT + m) * BN + c] + red[(1 * MT + m) * BN + c] +
                      red[(2 * MT + m) * BN + c] + red[(3 * MT + m) * BN + c];
    if (part)
      part[((long long)ks * M + m0 + m) * F + col] = sum;
    else
      out[(long long)(m0 + m) * F + col] = emmax::from_f32<T>(sum);
  }
}

template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ part,
                                   T* __restrict__ out, int splits,
                                   long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * n + i];
  out[i] = emmax::from_f32<T>(s);
}

template <typename T, int MT>
cudaError_t launch(const void* x, const void* q4, const void* scale,
                   void* part, void* out, int M, int D, int F, int group,
                   int gps, cudaStream_t stream) {
  const int Gh = (D / 2) / group;
  const int splits = (Gh + gps - 1) / gps;
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  dim3 grid((F + BN - 1) / BN, splits, (M + MT - 1) / MT);
  const int smem = (MT * 2 * group + 4 * MT * BN) * (int)sizeof(float);
  int4_mm_kernel<T, MT><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q4),
      static_cast<const __nv_bfloat16*>(scale),
      splits > 1 ? static_cast<float*>(part) : nullptr, static_cast<T*>(out),
      M, D, F, group, gps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)M * F;
  const int threads = 256;
  int4_reduce_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          stream>>>(static_cast<const float*>(part),
                                    static_cast<T*>(out), splits, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_m(const void* x, const void* q4, const void* scale,
                       void* part, void* out, int M, int D, int F, int group,
                       int gps, int mt, cudaStream_t s) {
  switch (mt) {
    case 1: return launch<T, 1>(x, q4, scale, part, out, M, D, F, group, gps, s);
    case 2: return launch<T, 2>(x, q4, scale, part, out, M, D, F, group, gps, s);
    case 4: return launch<T, 4>(x, q4, scale, part, out, M, D, F, group, gps, s);
    case 8: return launch<T, 8>(x, q4, scale, part, out, M, D, F, group, gps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, D] (dtype), q4 [D/2, F] int8, scale [D/group, F] bf16, out [M, F]
// (dtype), part [ceil((D/2/group)/gps), M, F] fp32 scratch when that count
// exceeds 1. `mt` is the number of x rows per block (1, 2, 4 or 8).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int emmax_int4_matmul(const void* x, const void* q4,
                                 const void* scale, void* part, void* out,
                                 int M, int D, int F, int group, int gps,
                                 int mt, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == emmax::kBFloat16)
    err = dispatch_m<__nv_bfloat16>(x, q4, scale, part, out, M, D, F, group,
                                    gps, mt, s);
  else if (dtype == emmax::kFloat32)
    err = dispatch_m<float>(x, q4, scale, part, out, M, D, F, group, gps, mt,
                            s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
