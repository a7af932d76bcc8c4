// Tile helpers shared by the port's bf16 tensor-core attention kernels
// (csrc/flash_fwd.cu, csrc/flash_bwd.cu): bf16 rows staged in XOR-swizzled
// shared memory (csrc/mma.cuh's `swizzle`) and the mma.m16n8k16 fragments
// read back from them through ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace emmax {
namespace tc {

using bf16 = __nv_bfloat16;

// shared row length (elements) of a tile padded to DP: whole 128-byte
// groups, the unit of the swizzle
template <int DP>
__host__ __device__ constexpr int row_len() {
  return (DP + 63) / 64 * 64;
}

// rows [r0, r0 + R) of a [rows, D] bf16 slice -> swizzled shared
// [R][row_len<DP>()], zero past `rows` and in columns D..DP, by a block of
// NTH threads. With `vec` (D % 8 == 0, 16-byte aligned rows) one cp.async
// per 16 bytes; otherwise element loads.
template <int R, int DP, int NTH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int rows, int D, bool vec) {
  constexpr int ROW = row_len<DP>();
  constexpr int CH = DP / 8;
  if (vec) {
    for (int i = threadIdx.x; i < R * CH; i += NTH) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool in = r0 + r < rows && c * 8 < D;
      mma::cp_async_16(dst + mma::swizzle<ROW>(r, c),
                       in ? src + (r0 + r) * row_stride + c * 8 : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += NTH) {
      const int r = i / DP, d = i - (i / DP) * DP;
      bf16 val = __float2bfloat16(0.f);
      if (r0 + r < rows && d < D) val = src[(r0 + r) * row_stride + d];
      dst[mma::swizzle<ROW>(r, d >> 3) + (d & 7)] = val;
    }
  }
}

// 16-byte row loads (load_tile's `vec`) need D % E == 0 and every row to
// start on a 16-byte boundary: the (batch, row, head) strides of the
// tensors, st[0 .. 3N), multiples of E elements and their N bases 16-byte
// aligned. E is the elements in 16 bytes: 8 for bf16, 4 for fp32.
template <int E = 8, int N>
inline bool rows_16b(int D, const long long* st,
                     const void* const (&bases)[N]) {
  if (D % E) return false;
  for (int i = 0; i < 3 * N; ++i)
    if (st[i] % E) return false;
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// key kj of a row with S keys and an optional uint8 slot mask is valid
__device__ __forceinline__ uint8_t key_ok(int S, const uint8_t* mb, int kj) {
  return kj < S && (!mb || mb[kj] != 0);
}

// the [16 x 16] A fragment of rows r0.. of a swizzled tile, k-step kk
template <int ROW>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile,
                                       int r0, int kk, int lane) {
  mma::ldmatrix_x4(
      r, tile + mma::swizzle<ROW>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  2 * kk + (lane >> 4)));
}

// B fragments of two neighbouring n-tiles (rows n0.., n0 + 8..) of a
// swizzled row-major [n][k] tile, k-step kk: r[0..1] n-tile n0, r[2..3]
// n-tile n0 + 8
template <int ROW>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile,
                                       int n0, int kk, int lane) {
  mma::ldmatrix_x4(
      r, tile + mma::swizzle<ROW>(n0 + (lane & 7) + (lane >> 4) * 8,
                                  2 * kk + ((lane >> 3) & 1)));
}

// B fragments of d-chunks 2*np and 2*np + 1 from a swizzled row-major
// [k][d] tile (k rows k0..k0 + 15) through ldmatrix.trans
template <int ROW>
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const bf16* tile,
                                        int k0, int np, int lane) {
  mma::ldmatrix_x4_trans(
      r, tile + mma::swizzle<ROW>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  2 * np + (lane >> 4)));
}

}  // namespace tc
}  // namespace emmax
