// Tile helpers shared by the port's 3xTF32 (fp32) attention kernels
// (csrc/flash_fwd.cu, csrc/flash_bwd.cu): fp32 rows staged in shared memory
// with a padded row length, loaded with cp.async, and split in place into
// the (big, small) tf32 parts of csrc/mma.cuh's split_tf32.

#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace emmax {
namespace tf32 {

// shared row length (floats): DP + 4 = 4 (mod 8), so rows g (or 2t) of a
// fragment read start 4 * odd banks apart; a multiple of 4 floats, so
// 16-byte cp.async destinations stay aligned
template <int DP>
__host__ __device__ constexpr int row_len() {
  return DP + 4;
}

// rows [r0, r0 + R) of a [rows, D] fp32 slice -> shared [R][row_len], by
// a block of NTH threads, zero past `rows` and in columns D..DP: 16-byte
// cp.async with `vec`, else 4-byte cp.async, both zero-filling what is not
// read
template <int R, int DP, int NTH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int rows, int D, bool vec) {
  constexpr int ROW = row_len<DP>();
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < R * CH; i += NTH) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool in = r0 + r < rows && c * 4 < D;
      mma::cp_async_16(dst + r * ROW + c * 4,
                       in ? src + (r0 + r) * row_stride + c * 4 : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += NTH) {
      const int r = i / DP, d = i - (i / DP) * DP;
      const bool in = r0 + r < rows && d < D;
      mma::cp_async_ca<4>(dst + r * ROW + d,
                          in ? src + (r0 + r) * row_stride + d : src, in);
    }
  }
}

// a landed [R][row_len] tile split in place: `big` keeps rna(x), `small`
// (same layout) gets rna(x - big), both as tf32 bit patterns in floats
template <int R, int DP, int NTH>
__device__ __forceinline__ void split_tile(float* big, float* small) {
  constexpr int ROW = row_len<DP>();
  for (int i = threadIdx.x; i < R * DP; i += NTH) {
    const int at = (i / DP) * ROW + i - (i / DP) * DP;
    uint32_t b, s;
    mma::split_tf32(big[at], b, s);
    big[at] = __uint_as_float(b);
    small[at] = __uint_as_float(s);
  }
}

// the A fragment of mma.m16n8k8 (rows r0 + g, + 8; columns 8 kk + t, + 4)
// of a raw fp32 tile, split into (big, small) as it is read
template <int ROW>
__device__ __forceinline__ void load_a(uint32_t (&big)[4],
                                       uint32_t (&small)[4],
                                       const float* tile, int r0, int kk,
                                       int g, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    mma::split_tf32(
        tile[(r0 + g + 8 * (e & 1)) * ROW + 8 * kk + t + 4 * (e >> 1)],
        big[e], small[e]);
}

// a float of a split tile as the b32 operand of mma_1688_tf32
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

}  // namespace tf32
}  // namespace emmax
