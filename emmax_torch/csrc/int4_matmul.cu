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
// What bounds it on the H100: decode (M = 1 .. 8) reads every weight byte
// once and does 2*M operations per weight, far below the ~295
// operations/byte ridge, so it is bound by the 3.35 TB/s of HBM: the weight
// bytes (D*F/2 + 2*F*D/group) are the cost. The unpacking costs
// instructions per weight whatever M is, so on the CUDA cores' fp32 FMAs
// (2*M per weight, plus the unpack) the old kernel became bound by
// operations from M ~ 4 up; on the tensor cores the unpack is shared by
// every row of x and prefill (M ~ 450) is bound by the products.
//
// bf16 x: tensor-core kernel (namespace `tc`), mma.sync m16n8k16 with A
// and B swapped: out^T = W^T x^T, so the weight is the 16-row A operand
// (16 output columns) and 8 rows of x the B operand. A warp owns CPL
// packed bytes of each of 16 packed rows per k-step and 8 * NN rows of x:
//   - lane (g, t), g = lane / 4, t = lane % 4, copies its CPL bytes of
//     packed rows k0 + 4 t .. k0 + 4 t + 3 (one 8-byte cp.async per row,
//     columns c0 + 8 g .., where F % 8 == 0; else 4-byte words i at
//     columns c0 + 32 i + 4 g ..) and the 8-byte runs x[m, k0 + 4 t ..]
//     of both nibble planes into its own slot of a ring of STAGES k-steps
//     in shared memory; it reads back only what it copied (no barrier:
//     its own cp.async.wait_group orders it), 80 bytes per lane and
//     stage, read with 16-byte loads (lane stride 5 x 16 bytes: no bank
//     conflict);
//   - packed row k0 + 4 t + r is the MMA's k = 2 t + {0, 1, 8, 9}[r] and
//     x follows the same order, so the four b32 of B are two 8-byte runs
//     of x; byte 2 j + h (h = 0, 1) of word i is output column row g + 8 h
//     of m16 tile 2 i + j. One byte permute gathers a tile's bytes of two
//     rows, and each nibble becomes its exact bf16 level q + 0.5 (low
//     nibble u - 7.5 with u the stored +8 value, high nibble (n ^ 8) - 7.5):
//     the nibble is placed in the mantissa of 64.0 (ulp 0.5) and 71.5
//     subtracted by one bf16x2 FMA, both exact;
//   - per 128-row group (any group % 16 == 0) the low and high planes are
//     accumulated in fp32 separately, then multiplied by that group's
//     scale of each column and added to the fp32 total: JAX's arithmetic
//     (int4_matmul.py:300-324) up to summation order, and no bf16 rounding
//     of the dequantized weight (the plain version has one).
// Each warp is a unit of (CPL * 8 columns, 8 * NN rows of x, a range of
// groups) with no barrier; M <= 8 runs CPL 8 / NN 1 (64 columns a warp:
// at M = 1 the kernel is bound by how many warps stream at once, and 16
// columns a lane held too many registers), larger M CPL 4 / NN 4 (32
// columns, 32 rows of x; the x tiles of one column tile are neighbouring
// warps, so their weight reads meet in L2). Four stages of 2.5 KB a warp.
// Where the units alone do not fill the card the groups are split over
// units (split-K) into an fp32 scratch [splits, M, F] that a second kernel
// sums in split order: deterministic, no atomics. The ragged column edge
// (lm_head F = 32064) is masked per 4-byte word (F % 4 == 0).
//
// fp32 x: TF32 tensor-core kernel (namespace `tf32`), mma.sync m16n8k8
// with the same swapped roles: the weight is the 16-row A operand, 8 rows
// of x the B operand. What differs from the bf16 kernel:
//   - two products, not three: every level q + 0.5 lies in +-7.5 in steps
//     of 1 (at most 4 significant bits), so it is exact in tf32; only x is
//     split, x = big + small (`split_tf32`, cvt.rna), and each product is
//     level * big + level * small, summed in fp32 by the tensor core. The
//     x values are not rounded to bf16 (the TPU kernel does so,
//     int4_matmul.py:311-313); the port's fp32 path keeps fp32's accuracy,
//     as JAX's XLA route does;
//   - each nibble becomes its fp32 level in registers: masked into the
//     mantissa of 2^(23 - s) (s its bit position, ulp 1) and 2^(23 - s) +
//     7.5 subtracted, both exact; bytes 0 / 1 of a word sit at s = 4 .. 12
//     as they are, bytes 2 / 3 after one shift, so a word's 8 levels take
//     2 shifts, 8 masks and 8 subtractions;
//   - the k order: lane (g, t) holds packed rows k0 + 4 t .. + 3 of its
//     columns, and packed row k0 + 4 t + 2 h + i (i = 0, 1) is the k t + 4 i
//     of the step's h-th MMA; x is read in the same order, so a lane's B of
//     both MMAs is one 16-byte run x[m, k0 + 4 t ..] of each plane;
//   - x is shared by a block: 4 warps on neighbouring column tiles (64
//     columns and 8 rows of x each at M <= 8, 32 columns and 32 rows
//     above) share the block's rows of x. Every thread helps copy the
//     step's x tile into the stage and splits what it copied, once for the
//     block, and one barrier a step publishes it (warps copying their own
//     x, as the bf16 kernel's do, would re-read fp32 x from L2 once per 32
//     columns: at prefill's rows more bytes than the weights);
//   - the group sums, scales, split-K and column masks are the bf16
//     kernel's.
//
// The scalar kernel (namespace `scalar`) serves only the groups that the
// tensor-core kernels cannot take: those that are not a multiple of 16
// (D / 2 % 16 != 0; e.g. D 80 gives group 8), in either dtype. A block of
// 4 warps owns 128 output columns (4 per lane, one 32-bit load of 4 packed
// bytes per row) and MT rows of x; the packed rows are walked one
// quantisation group at a time: the group's x values (both planes) are
// staged in shared memory, each warp takes every 4th packed row, unpacks
// both nibbles in registers and accumulates per plane in fp32 FMAs; the
// group scale is applied once per group to the partial sums, as the TPU
// kernel does. Split-K as above.

#include "common.cuh"
#include "mma.cuh"

namespace {

// the split-K partials [splits, M, F] summed in split order into out
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

template <typename T>
cudaError_t reduce(const void* part, void* out, int splits, int M, int F,
                   cudaStream_t stream) {
  const long long n = (long long)M * F;
  const int threads = 256;
  int4_reduce_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          stream>>>(static_cast<const float*>(part),
                                    static_cast<T*>(out), splits, n);
  return cudaGetLastError();
}

// bf16 number i (0..3) of four packed in a uint2, as fp32
__device__ __forceinline__ float bf16_at(uint2 v, int i) {
  const uint32_t w = i < 2 ? v.x : v.y;
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}

// ------------------------------------------------------ scalar (fp32) ---

namespace scalar {

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
  return reduce<T>(part, out, splits, M, F, stream);
}

template <typename T>
cudaError_t dispatch_m(const void* x, const void* q4, const void* scale,
                       void* part, void* out, int M, int D, int F, int group,
                       int gps, int mt, cudaStream_t s) {
  switch (mt) {
    case 1:
      return launch<T, 1>(x, q4, scale, part, out, M, D, F, group, gps,
                            s);
    case 2:
      return launch<T, 2>(x, q4, scale, part, out, M, D, F, group, gps,
                            s);
    case 4:
      return launch<T, 4>(x, q4, scale, part, out, M, D, F, group, gps,
                            s);
    case 8:
      return launch<T, 8>(x, q4, scale, part, out, M, D, F, group, gps,
                            s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace scalar

// --------------------------------------------------- tensor core (bf16) ---

namespace tc {

using bf16 = __nv_bfloat16;
using emmax::mma::cp_async_ca;
using emmax::mma::cp_async_commit;
using emmax::mma::cp_async_wait;
using emmax::mma::fma_bf16x2;
using emmax::mma::mma_16816;
using emmax::mma::pack_bf16;

constexpr int NW = 4;          // warps per block, each a unit of its own
constexpr int SLOT = 20;       // b32 per lane and stage (5 x 16 bytes)
constexpr uint32_t ONE2 = 0x3f803f80u;    // bf16x2 (1, 1)
constexpr uint32_t BIAS2 = 0xc28fc28fu;   // bf16x2 (-71.5, -71.5)

// a block's ring of `stages` k-steps
constexpr int smem_bytes(int stages) { return stages * NW * 32 * SLOT * 4; }

struct Args {
  const bf16* x;          // [M, D]
  const int8_t* q4;       // [D/2, F]
  const bf16* scale;      // [D/group, F]
  float* part;            // [splits, M, F] when splits > 1
  bf16* out;              // [M, F]
  int M, D, F, group, gps, splits;
};

// the exact bf16 levels of two nibbles sitting at bits 1..4 and 17..20:
// placed in the mantissa of 64.0 (ulp 0.5), then 71.5 subtracted. The low
// nibble u (stored +8) gives u - 7.5; the high nibble n (two's complement)
// gives (n ^ 8) - 7.5 = n + 0.5
__device__ __forceinline__ uint32_t lo_level(uint32_t v) {
  return fma_bf16x2((v & 0x001e001eu) | 0x42804280u, ONE2, BIAS2);
}
__device__ __forceinline__ uint32_t hi_level(uint32_t v) {
  return fma_bf16x2((v & 0x001e001eu) ^ 0x42904290u, ONE2, BIAS2);
}

// VEC: the lane's CPL = 8 bytes of a row are one 8-byte cp.async
// (F % 8 == 0, q4 8-byte aligned); otherwise 4-byte copies
template <int CPL, int NN, int STAGES, bool VEC>
__global__ void __launch_bounds__(32 * NW) int4_tc_kernel(Args a) {
  constexpr int W = CPL / 4;      // 4-byte words per lane and packed row
  constexpr int TW = CPL / 2;     // m16 tiles per warp
  constexpr int COLS = 8 * CPL;   // output columns per warp
  constexpr int MT = 8 * NN;      // rows of x per warp
  constexpr int STAGE = NW * 32 * SLOT;   // b32 per stage of the block
  static_assert(4 * W + 4 * NN <= SLOT, "a stage's slot holds it all");
  static_assert(!VEC || CPL == 8, "vector copies are 8-byte runs");

  extern __shared__ __align__(16) unsigned char smem_i4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_ct = (a.F + COLS - 1) / COLS, n_mt = (a.M + MT - 1) / MT;
  const long long unit = (long long)blockIdx.x * NW + warp;
  if (unit >= (long long)n_ct * n_mt * a.splits) return;
  // x tiles of one column tile are neighbouring units (L2 reuse)
  const int mt = (int)(unit % n_mt);
  const int ct = (int)((unit / n_mt) % n_ct);
  const int ks = (int)(unit / ((long long)n_mt * n_ct));
  const int c0 = ct * COLS, m0 = mt * MT;
  const int D2 = a.D >> 1, Gh = D2 / a.group;
  const int g_begin = ks * a.gps, g_end = min(Gh, g_begin + a.gps);
  const int spg = a.group / 16;   // k-steps per group
  // this lane's slot of stage 0; stage j is STAGE b32 further
  uint32_t* const slots =
      reinterpret_cast<uint32_t*>(smem_i4) + (warp * 32 + lane) * SLOT;

  // this lane's word i holds output columns c0 + CPL g + 4 i .. + 3 (VEC)
  // or c0 + 32 i + 4 g .. + 3: a warp's copy is 64 or 32 contiguous bytes
  // of each row
  int col[W];
  bool col_ok[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    col[i] = VEC ? c0 + CPL * g + 4 * i : c0 + 32 * i + 4 * g;
    col_ok[i] = col[i] < a.F;   // F % 4 == 0: a word is all in or all out
  }

  // the next step's sources: packed row k + 4t of the lane's words and the
  // x runs x[m0 + 8n + g, k + 4t ..] (column 0 and row 0 stand in for those
  // past F and M: valid addresses, copied as zeros), 16 rows on per step
  const int k_first = g_begin * a.group + 4 * t;
  const int8_t* wsrc[W];
#pragma unroll
  for (int i = 0; i < W; ++i)
    wsrc[i] = a.q4 + (long long)k_first * a.F + (col_ok[i] ? col[i] : 0);
  const bf16* xsrc[NN];
  bool x_ok[NN];
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int m = m0 + 8 * n + g;
    x_ok[n] = m < a.M;
    xsrc[n] = a.x + (long long)(x_ok[n] ? m : 0) * a.D + k_first;
  }
  const long long wstep = 16LL * a.F;
  int wslot = 0;
  auto issue = [&]() {
    uint32_t* slot = slots + wslot * STAGE;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (VEC) {   // F % 8 == 0: the run is all in or all out
        cp_async_ca<8>(slot + r * W, wsrc[0] + r * a.F, col_ok[0]);
        continue;
      }
#pragma unroll
      for (int i = 0; i < W; ++i)
        cp_async_ca<4>(slot + r * W + i, wsrc[i] + r * a.F, col_ok[i]);
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      cp_async_ca<8>(slot + 4 * W + 4 * n, xsrc[n], x_ok[n]);
      cp_async_ca<8>(slot + 4 * W + 4 * n + 2, xsrc[n] + D2, x_ok[n]);
      xsrc[n] += 16;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) wsrc[i] += wstep;
    wslot = wslot + 1 == STAGES ? 0 : wslot + 1;
  };

  const int n_steps = (g_end - g_begin) * spg;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) issue();
    cp_async_commit();
  }
  int to_issue = n_steps - (STAGES - 1);
  int rslot = 0;

  float tot[TW][NN][4], alo[TW][NN][4], ahi[TW][NN][4];
#pragma unroll
  for (int j = 0; j < TW; ++j)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[j][n][e] = alo[j][n][e] = ahi[j][n][e] = 0.f;

  for (int gi = g_begin; gi < g_end; ++gi) {
    uint2 slo[W], shi[W];   // the group's scales of the lane's columns
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint2 zero = make_uint2(0u, 0u);
      const bf16* sp = a.scale + (long long)gi * a.F + col[i];
      slo[i] = col_ok[i] ? __ldg(reinterpret_cast<const uint2*>(sp)) : zero;
      shi[i] = col_ok[i] ? __ldg(reinterpret_cast<const uint2*>(
                               sp + (long long)Gh * a.F))
                         : zero;
    }
    for (int kin = 0; kin < spg; ++kin) {
      cp_async_wait<STAGES - 2>();   // this step landed (the lane's copies)
      uint32_t d[SLOT];
      const uint4* slot =
          reinterpret_cast<const uint4*>(slots + rslot * STAGE);
#pragma unroll
      for (int c = 0; c < SLOT / 4; ++c) {
        const uint4 v = slot[c];
        d[4 * c] = v.x;
        d[4 * c + 1] = v.y;
        d[4 * c + 2] = v.z;
        d[4 * c + 3] = v.w;
      }
      rslot = rslot + 1 == STAGES ? 0 : rslot + 1;
      // the slot of the previous step, read last time, takes a new step
      if (to_issue-- > 0) issue();
      cp_async_commit();

#pragma unroll
      for (int j = 0; j < TW; ++j) {
        // bytes 2 (j & 1) .. + 1 of word j / 2 of rows 4t, 4t + 1 (p01)
        // and 4t + 2, 4t + 3 (p23): byte 0 / 2 column row g, byte 1 / 3
        // row g + 8
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const int i = j >> 1;
        const uint32_t p01 = __byte_perm(d[i], d[W + i], sel);
        const uint32_t p23 = __byte_perm(d[2 * W + i], d[3 * W + i], sel);
        const uint32_t al[4] = {lo_level(p01 << 1), lo_level(p01 >> 7),
                                lo_level(p23 << 1), lo_level(p23 >> 7)};
        const uint32_t ah[4] = {hi_level(p01 >> 3), hi_level(p01 >> 11),
                                hi_level(p23 >> 3), hi_level(p23 >> 11)};
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const uint32_t* xb = d + 4 * W + 4 * n;
          mma_16816(alo[j][n], al, xb[0], xb[1]);
          mma_16816(ahi[j][n], ah, xb[2], xb[3]);
        }
      }
    }

    // the group's end: scale its sums per column
#pragma unroll
    for (int j = 0; j < TW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sc = 2 * (j & 1) + (e >> 1);
        const float sl = bf16_at(slo[j >> 1], sc);
        const float sh = bf16_at(shi[j >> 1], sc);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          tot[j][n][e] += alo[j][n][e] * sl + ahi[j][n][e] * sh;
          alo[j][n][e] = ahi[j][n][e] = 0.f;
        }
      }
  }

  // C element e: column row g + 8 (e >> 1) of tile j, x row 2t + (e & 1)
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int cj = col[j >> 1] + 2 * (j & 1);
    if (!col_ok[j >> 1]) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int m = m0 + 8 * n + 2 * t + q;
        if (m >= a.M) continue;
        const float v0 = tot[j][n][q], v1 = tot[j][n][2 + q];
        if (a.splits > 1)
          *reinterpret_cast<float2*>(
              a.part + ((long long)ks * a.M + m) * a.F + cj) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(a.out + (long long)m * a.F + cj) =
              pack_bf16(v0, v1);
      }
  }
}

template <int CPL, int NN, int STAGES, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes(STAGES);
  cudaError_t err = cudaFuncSetAttribute(
      int4_tc_kernel<CPL, NN, STAGES, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long units = (long long)((a.F + 8 * CPL - 1) / (8 * CPL)) *
                          ((a.M + 8 * NN - 1) / (8 * NN)) * a.splits;
  const unsigned blocks = (unsigned)((units + NW - 1) / NW);
  int4_tc_kernel<CPL, NN, STAGES, VEC><<<blocks, 32 * NW, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return reduce<bf16>(a.part, a.out, a.splits, a.M, a.F, stream);
}

// the two shapes of unit: (columns a lane, x tiles, stages) for mt, the
// rows of x per warp
constexpr int SMALL_CPL = 8, SMALL_STAGES = 4;    // mt 8: M <= 8
constexpr int LARGE_CPL = 4, LARGE_NN = 4, LARGE_STAGES = 4;   // mt 32

cudaError_t dispatch(const Args& a, int mt, cudaStream_t s) {
  if (a.splits > 1 && a.part == nullptr) return cudaErrorInvalidValue;
  const bool vec = a.F % SMALL_CPL == 0 &&
                   reinterpret_cast<uintptr_t>(a.q4) % SMALL_CPL == 0;
  if (mt == 8)
    return vec ? launch<SMALL_CPL, 1, SMALL_STAGES, true>(a, s)
               : launch<SMALL_CPL, 1, SMALL_STAGES, false>(a, s);
  if (mt == 8 * LARGE_NN)
    return launch<LARGE_CPL, LARGE_NN, LARGE_STAGES, false>(a, s);
  return cudaErrorInvalidValue;
}

int smem_of(int mt) {
  if (mt == 8) return smem_bytes(SMALL_STAGES);
  if (mt == 8 * LARGE_NN) return smem_bytes(LARGE_STAGES);
  return -1;
}

}  // namespace tc

// --------------------------------------------------- tensor core (fp32) ---

namespace tf32 {

using emmax::mma::cp_async_16;
using emmax::mma::cp_async_ca;
using emmax::mma::cp_async_commit;
using emmax::mma::cp_async_wait;
using emmax::mma::mma_1688_tf32;
using emmax::mma::split_tf32;

constexpr int NW = 4;   // warps per block

struct Args {
  const float* x;                  // [M, D]
  const int8_t* q4;                // [D/2, F]
  const __nv_bfloat16* scale;      // [D/group, F]
  float* part;                     // [splits, M, F] when splits > 1
  float* out;                      // [M, F]
  int M, D, F, group, gps, splits;
};

// b32 of a lane's slot per stage: its 4 packed rows of W words, padded to
// an odd number of 16-byte chunks (no bank conflict on its 16-byte reads)
__host__ __device__ constexpr int lane_b32(int W) {
  return W % 2 ? 4 * W : 4 * W + 4;
}
// b32 of a block's stage: the shared x tile (2 planes x MT rows x 16 fp32,
// its big parts, then its small parts), then every lane's slot
__host__ __device__ constexpr int stage_b32(int NN, int W) {
  return 2 * 2 * 8 * NN * 16 + NW * 32 * lane_b32(W);
}
constexpr int smem_bytes(int NN, int W, int stages) {
  return stages * stage_b32(NN, W) * 4;
}

// the exact fp32 level of the nibble at bits S .. S + 3 of w (S = 4, 8, 12
// or 16), as a tf32 operand: the nibble placed in the mantissa of 2^E, E =
// 23 - S, where its ulp is 1, then 2^E + 7.5 subtracted (both exact). The
// low plane's u (stored +8) gives u - 7.5; the high plane's n (two's
// complement) has its top bit flipped first: (n ^ 8) - 7.5 = n + 0.5. A
// level has at most 4 significant bits, so it is exact in tf32
template <int S, bool HI>
__device__ __forceinline__ uint32_t level(uint32_t w) {
  constexpr int E = 23 - S;
  constexpr uint32_t BASE = (uint32_t)(127 + E) << 23;
  constexpr float OFF = (float)(1 << E) + 7.5f;
  const uint32_t m = w & (0xfu << S);
  return __float_as_uint(
      __uint_as_float(HI ? m ^ (BASE | (8u << S)) : m | BASE) - OFF);
}

// the levels in plane P (0 low, 1 high) of bytes 2 H and 2 H + 1 of w: the
// columns at rows g and g + 8 of an m16 tile. Two shifts serve a word's
// eight levels
template <int H, int P>
__device__ __forceinline__ void levels(uint32_t w, uint32_t& a, uint32_t& b) {
  if (H == 0 && P == 0) {
    a = level<8, false>(w << 8);
    b = level<8, false>(w);
  } else if (H == 0) {
    a = level<4, true>(w);
    b = level<12, true>(w);
  } else if (P == 0) {
    a = level<16, false>(w);
    b = level<8, false>(w >> 16);
  } else {
    a = level<4, true>(w >> 16);
    b = level<12, true>(w >> 16);
  }
}

// A warp: CPL * 8 columns, MT = 8 * NN rows of x, a range of groups; the
// NW warps of a block take neighbouring column tiles and share the
// block's x tile. Per k-step of 16 packed rows each lane copies its
// weight bytes (as the bf16 kernel does) into its slot of a ring of
// STAGES stages, every thread helps copy the x tile, and one barrier a
// step publishes the tile and frees the stage read the step before.
// VEC: 8-byte weight copies (F % 8 == 0)
template <int CPL, int NN, int STAGES, bool VEC>
__global__ void __launch_bounds__(32 * NW) int4_tc_kernel(Args a) {
  constexpr int W = CPL / 4;       // 4-byte words per lane and packed row
  constexpr int TW = CPL / 2;      // m16 tiles per warp
  constexpr int COLS = 8 * CPL;    // output columns per warp
  constexpr int MT = 8 * NN;       // rows of x per block
  constexpr int XT = 2 * MT * 16;  // b32 of an x tile
  constexpr int LS = lane_b32(W);
  constexpr int STAGE = stage_b32(NN, W);
  constexpr int XCH = XT / 4;      // 16-byte runs of an x tile
  // the 16-byte runs of x a thread copies each step
  constexpr int XQ = (XCH + 32 * NW - 1) / (32 * NW);
  static_assert(!VEC || CPL == 8, "vector copies are 8-byte runs");

  extern __shared__ __align__(16) unsigned char smem_tf[];
  uint32_t* const smem = reinterpret_cast<uint32_t*>(smem_tf);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // a block of NW column tiles; the row tiles of one column block are
  // neighbouring blocks (L2 reuse of the weights)
  const int n_mt = (a.M + MT - 1) / MT;
  const int n_cb = (a.F + NW * COLS - 1) / (NW * COLS);
  const int mt = (int)(blockIdx.x % n_mt);
  const int ct = (int)((blockIdx.x / n_mt) % n_cb) * NW + warp;
  const int ks = (int)(blockIdx.x / (n_mt * n_cb));
  const int c0 = ct * COLS, m0 = mt * MT;
  const int D2 = a.D >> 1, Gh = D2 / a.group;
  const int g_begin = ks * a.gps, g_end = min(Gh, g_begin + a.gps);
  const int spg = a.group / 16;   // k-steps per group

  // this lane's word i holds output columns c0 + CPL g + 4 i .. + 3 (VEC)
  // or c0 + 32 i + 4 g .. + 3, as in the bf16 kernel
  int col[W];
  bool col_ok[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    col[i] = VEC ? c0 + CPL * g + 4 * i : c0 + 32 * i + 4 * g;
    col_ok[i] = col[i] < a.F;   // F % 4 == 0: a word is all in or all out
  }

  // the next step's sources: packed rows k + 4t .. k + 4t + 3 of the lane's
  // words (column 0 stands in for those past F), and the thread's runs of
  // x, fp32 4 j .. 4 j + 3 of the step in plane p of row r (row 0 stands
  // in for rows past M; both copied as zeros), 16 rows on per step: run c
  // of the tile is p = c / (4 MT), r = (c / 4) % MT, j = c % 4 at b32 4 c
  // of the stage
  const int k_first = g_begin * a.group;
  const int8_t* wsrc[W];
#pragma unroll
  for (int i = 0; i < W; ++i)
    wsrc[i] = a.q4 + (long long)(k_first + 4 * t) * a.F +
              (col_ok[i] ? col[i] : 0);
  uint32_t* const own = smem + 2 * XT + (warp * 32 + lane) * LS;  // stage 0
  const float* xsrc[XQ];
  uint32_t* xdst[XQ];
  bool x_mine[XQ], x_ok[XQ];
#pragma unroll
  for (int q = 0; q < XQ; ++q) {
    const int c = threadIdx.x + 32 * NW * q;
    const int p = c / (4 * MT), r = (c >> 2) % MT, j = c & 3;
    x_mine[q] = c < XCH;
    x_ok[q] = x_mine[q] && m0 + r < a.M;
    xsrc[q] = a.x + (long long)(x_ok[q] ? m0 + r : 0) * a.D +
              (x_mine[q] ? p * D2 : 0) + k_first + 4 * j;
    xdst[q] = smem + 4 * c;
  }
  const long long wstep = 16LL * a.F;
  int wstage = 0;
  auto issue = [&]() {
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      if (x_mine[q])
        cp_async_16(xdst[q] + wstage * STAGE, xsrc[q], x_ok[q]);
      xsrc[q] += 16;
    }
    uint32_t* const slot = own + wstage * STAGE;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (VEC) {   // F % 8 == 0: the run is all in or all out
        cp_async_ca<8>(slot + r * W, wsrc[0] + r * a.F, col_ok[0]);
        continue;
      }
#pragma unroll
      for (int i = 0; i < W; ++i)
        cp_async_ca<4>(slot + r * W + i, wsrc[i] + r * a.F, col_ok[i]);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) wsrc[i] += wstep;
    wstage = wstage + 1 == STAGES ? 0 : wstage + 1;
  };

  const int n_steps = (g_end - g_begin) * spg;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) issue();
    cp_async_commit();
  }
  int to_issue = n_steps - (STAGES - 1);
  int rstage = 0;

  float tot[TW][NN][4], alo[TW][NN][4], ahi[TW][NN][4];
#pragma unroll
  for (int j = 0; j < TW; ++j)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[j][n][e] = alo[j][n][e] = ahi[j][n][e] = 0.f;

  for (int gi = g_begin; gi < g_end; ++gi) {
    uint2 slo[W], shi[W];   // the group's scales of the lane's columns
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint2 zero = make_uint2(0u, 0u);
      const __nv_bfloat16* sp = a.scale + (long long)gi * a.F + col[i];
      slo[i] = col_ok[i] ? __ldg(reinterpret_cast<const uint2*>(sp)) : zero;
      shi[i] = col_ok[i] ? __ldg(reinterpret_cast<const uint2*>(
                               sp + (long long)Gh * a.F))
                         : zero;
    }
    for (int kin = 0; kin < spg; ++kin) {
      cp_async_wait<STAGES - 2>();   // this thread's copies of the step
      uint32_t* const st = smem + rstage * STAGE;
      // each thread splits the runs it copied, once for the block: big in
      // place, small XT b32 on; then everyone's are published, and the
      // stage read last step is free for the step STAGES - 1 ahead
#pragma unroll
      for (int q = 0; q < XQ; ++q) {
        if (!x_mine[q]) continue;
        uint32_t* const run = xdst[q] + rstage * STAGE;
        const float4 v = *reinterpret_cast<const float4*>(run);
        uint4 big, small;
        split_tf32(v.x, big.x, small.x);
        split_tf32(v.y, big.y, small.y);
        split_tf32(v.z, big.z, small.z);
        split_tf32(v.w, big.w, small.w);
        *reinterpret_cast<uint4*>(run) = big;
        *reinterpret_cast<uint4*>(run + XT) = small;
      }
      __syncthreads();
      if (to_issue-- > 0) issue();
      cp_async_commit();
      rstage = rstage + 1 == STAGES ? 0 : rstage + 1;

      const uint32_t* const mine = st + 2 * XT + (warp * 32 + lane) * LS;
      uint32_t d[4 * W];   // d[r W + i]: word i of packed row k + 4t + r
      const uint4* wp = reinterpret_cast<const uint4*>(mine);
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const uint4 v = wp[c];
        d[4 * c] = v.x;
        d[4 * c + 1] = v.y;
        d[4 * c + 2] = v.z;
        d[4 * c + 3] = v.w;
      }
      // A of tile j, plane p, half h: MMA k t is packed row 4t + 2h, k t +
      // 4 row 4t + 2h + 1; A rows g / g + 8 are bytes 2 (j & 1) / + 1 of
      // word j / 2
      auto tile_levels = [&](int j, uint32_t (&lv)[2][2][4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w0 = d[2 * h * W + (j >> 1)];
          const uint32_t w1 = d[(2 * h + 1) * W + (j >> 1)];
          if (j & 1) {
            levels<1, 0>(w0, lv[0][h][0], lv[0][h][1]);
            levels<1, 0>(w1, lv[0][h][2], lv[0][h][3]);
            levels<1, 1>(w0, lv[1][h][0], lv[1][h][1]);
            levels<1, 1>(w1, lv[1][h][2], lv[1][h][3]);
          } else {
            levels<0, 0>(w0, lv[0][h][0], lv[0][h][1]);
            levels<0, 0>(w1, lv[0][h][2], lv[0][h][3]);
            levels<0, 1>(w0, lv[1][h][0], lv[1][h][1]);
            levels<0, 1>(w1, lv[1][h][2], lv[1][h][3]);
          }
        }
      };
      // B of x tile n: x[m0 + 8n + g, k + 4t + 2h], x[.., k + 4t + 2h + 1]
      // in each plane, split into big + small once for the block: two
      // products, exact levels times each part
      auto x_parts = [&](int n, uint32_t (&big)[2][4],
                         uint32_t (&small)[2][4]) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t* const run = st + (p * MT + 8 * n + g) * 16 + 4 * t;
          const uint4 b = *reinterpret_cast<const uint4*>(run);
          const uint4 sm = *reinterpret_cast<const uint4*>(run + XT);
          big[p][0] = b.x, big[p][1] = b.y, big[p][2] = b.z, big[p][3] = b.w;
          small[p][0] = sm.x, small[p][1] = sm.y, small[p][2] = sm.z;
          small[p][3] = sm.w;
        }
      };
      auto products = [&](int j, int n, const uint32_t (&lv)[2][2][4],
                          const uint32_t (&big)[2][4],
                          const uint32_t (&small)[2][4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_1688_tf32(alo[j][n], lv[0][h], big[0][2 * h],
                        big[0][2 * h + 1]);
          mma_1688_tf32(alo[j][n], lv[0][h], small[0][2 * h],
                        small[0][2 * h + 1]);
          mma_1688_tf32(ahi[j][n], lv[1][h], big[1][2 * h],
                        big[1][2 * h + 1]);
          mma_1688_tf32(ahi[j][n], lv[1][h], small[1][2 * h],
                        small[1][2 * h + 1]);
        }
      };
      if constexpr (NN > 1) {
        // every tile's levels, then x tile by x tile (the levels serve NN
        // x tiles, each x tile's parts are read once)
        uint32_t lv[TW][2][2][4];
#pragma unroll
        for (int j = 0; j < TW; ++j) tile_levels(j, lv[j]);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          uint32_t big[2][4], small[2][4];
          x_parts(n, big, small);
#pragma unroll
          for (int j = 0; j < TW; ++j) products(j, n, lv[j], big, small);
        }
      } else {
        // the one x tile's parts, then tile by tile (fewer live levels)
        uint32_t big[2][4], small[2][4];
        x_parts(0, big, small);
#pragma unroll
        for (int j = 0; j < TW; ++j) {
          uint32_t lv[2][2][4];
          tile_levels(j, lv);
          products(j, 0, lv, big, small);
        }
      }
    }

    // the group's end: scale its sums per column
#pragma unroll
    for (int j = 0; j < TW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sc = 2 * (j & 1) + (e >> 1);
        const float sl = bf16_at(slo[j >> 1], sc);
        const float sh = bf16_at(shi[j >> 1], sc);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          tot[j][n][e] += alo[j][n][e] * sl + ahi[j][n][e] * sh;
          alo[j][n][e] = ahi[j][n][e] = 0.f;
        }
      }
  }

  // C element e: column row g + 8 (e >> 1) of tile j, x row 2t + (e & 1)
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int cj = col[j >> 1] + 2 * (j & 1);
    if (!col_ok[j >> 1]) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int m = m0 + 8 * n + 2 * t + q;
        if (m >= a.M) continue;
        float* dst = a.splits > 1
                         ? a.part + ((long long)ks * a.M + m) * a.F + cj
                         : a.out + (long long)m * a.F + cj;
        *reinterpret_cast<float2*>(dst) =
            make_float2(tot[j][n][q], tot[j][n][2 + q]);
      }
  }
}

template <int CPL, int NN, int STAGES, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes(NN, CPL / 4, STAGES);
  cudaError_t err = cudaFuncSetAttribute(
      int4_tc_kernel<CPL, NN, STAGES, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // a block of NW column tiles, for each row tile and split
  const long long blocks = (long long)((a.F + NW * 8 * CPL - 1) /
                                       (NW * 8 * CPL)) *
                           ((a.M + 8 * NN - 1) / (8 * NN)) * a.splits;
  int4_tc_kernel<CPL, NN, STAGES, VEC>
      <<<(unsigned)blocks, 32 * NW, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return reduce<float>(a.part, a.out, a.splits, a.M, a.F, stream);
}

// the two shapes, by mt, the rows of x of a block: (columns a lane, x
// tiles, stages); mt 8 a block of NW warps on 64 columns each, mt 32 on
// 32 columns each
constexpr int SMALL_CPL = 8, SMALL_STAGES = 4;                 // M <= 8
constexpr int LARGE_CPL = 4, LARGE_NN = 4, LARGE_STAGES = 4;   // mt 32

cudaError_t dispatch(const Args& a, int mt, cudaStream_t s) {
  if (a.splits > 1 && a.part == nullptr) return cudaErrorInvalidValue;
  const bool vec = a.F % SMALL_CPL == 0 &&
                   reinterpret_cast<uintptr_t>(a.q4) % SMALL_CPL == 0;
  if (mt == 8)
    return vec ? launch<SMALL_CPL, 1, SMALL_STAGES, true>(a, s)
               : launch<SMALL_CPL, 1, SMALL_STAGES, false>(a, s);
  if (mt == 8 * LARGE_NN)
    return launch<LARGE_CPL, LARGE_NN, LARGE_STAGES, false>(a, s);
  return cudaErrorInvalidValue;
}

int smem_of(int mt) {
  if (mt == 8) return smem_bytes(1, SMALL_CPL / 4, SMALL_STAGES);
  if (mt == 8 * LARGE_NN)
    return smem_bytes(LARGE_NN, LARGE_CPL / 4, LARGE_STAGES);
  return -1;
}

}  // namespace tf32

}  // namespace

// x [M, D] (dtype), q4 [D/2, F] int8, scale [D/group, F] bf16, out [M, F]
// (dtype), part [ceil((D/2/group)/gps), M, F] fp32 scratch when that count
// exceeds 1. With group % 16 == 0 bf16 x runs the bf16 tensor-core kernel
// and fp32 x the TF32 one, `mt` their rows of x per warp or block (8 or
// 32; x 16-byte aligned, q4 4-byte, scale 8-byte); otherwise the scalar
// kernel, `mt` its rows of x per block (1, 2, 4 or 8). Returns the
// cudaError_t of the launches (0 = success).
extern "C" int emmax_int4_matmul(const void* x, const void* q4,
                                 const void* scale, void* part, void* out,
                                 int M, int D, int F, int group, int gps,
                                 int mt, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = ((D / 2) / group + gps - 1) / gps;
  cudaError_t err;
  if (dtype == emmax::kBFloat16 && group % 16 == 0) {
    tc::Args a;
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.q4 = static_cast<const int8_t*>(q4);
    a.scale = static_cast<const __nv_bfloat16*>(scale);
    a.part = static_cast<float*>(part);
    a.out = static_cast<__nv_bfloat16*>(out);
    a.M = M;
    a.D = D;
    a.F = F;
    a.group = group;
    a.gps = gps;
    a.splits = splits;
    err = tc::dispatch(a, mt, s);
  } else if (dtype == emmax::kFloat32 && group % 16 == 0) {
    tf32::Args a;
    a.x = static_cast<const float*>(x);
    a.q4 = static_cast<const int8_t*>(q4);
    a.scale = static_cast<const __nv_bfloat16*>(scale);
    a.part = static_cast<float*>(part);
    a.out = static_cast<float*>(out);
    a.M = M;
    a.D = D;
    a.F = F;
    a.group = group;
    a.gps = gps;
    a.splits = splits;
    err = tf32::dispatch(a, mt, s);
  } else if (dtype == emmax::kBFloat16) {
    err = scalar::dispatch_m<__nv_bfloat16>(x, q4, scale, part, out, M, D,
                                            F, group, gps, mt, s);
  } else if (dtype == emmax::kFloat32) {
    err = scalar::dispatch_m<float>(x, q4, scale, part, out, M, D, F, group,
                                    gps, mt, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of a tensor-core kernel's blocks at `mt`
// rows of x per warp or block (8 or 32): the bf16 kernel for dtype
// bfloat16, the TF32 one for float32; -1 otherwise.
extern "C" int emmax_int4_matmul_smem_bytes(int mt, int dtype) {
  if (dtype == emmax::kBFloat16) return tc::smem_of(mt);
  if (dtype == emmax::kFloat32) return tf32::smem_of(mt);
  return -1;
}
