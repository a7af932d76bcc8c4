// Warp-level tensor-core and async-copy helpers for the port's Hopper
// kernels: one inline function per PTX instruction, so a kernel's use of
// the fragment layouts reads in one place and each helper can be replaced
// by a scalar stand-in when the kernel logic is rehearsed off the card.
//
// Fragment layouts of mma.m16n8k16 with bf16 inputs (PTX ISA, "Matrix
// Fragments for mma.m16n8k16"), for lane l, g = l / 4, t = l % 4:
//   A (16 x 16, row-major), 4 x b32 of two bf16 each, the lower half the
//     lower column: a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//     a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..)
//   B (16 x 8, "col": stored n-major), 2 x b32: b[0] = (k 2t..2t+1, n g),
//     b[1] = (k 2t + 8.., n g)
//   C / D (16 x 8 fp32): c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..)
// So the C fragments of two neighbouring 16 x 8 tiles, rounded to bf16
// and packed pairwise, are the A fragment of their 16 x 16 tile.
//
// Fragment layouts of mma.m16n8k8 with tf32 inputs (PTX ISA, "Matrix
// Fragments for mma.m16n8k8", .tf32), one 32-bit element a register:
//   A (16 x 8, row-major): a[0] = (g, t), a[1] = (g + 8, t),
//     a[2] = (g, t + 4), a[3] = (g + 8, t + 4)
//   B (8 x 8, "col"): b[0] = (k t, n g), b[1] = (k t + 4, n g)
//   C / D (16 x 8 fp32): as for m16n8k16 above.
// So a C fragment's columns 2t, 2t + 1 are not an A fragment's t, t + 4:
// a kernel that feeds C back as A reads the other operand's k rows in the
// permuted order k t <-> 2t, k t + 4 <-> 2t + 1 instead of moving data.
//
// ldmatrix .x4 loads four 8 x 8 bf16 matrices; lanes 8j..8j+7 give the
// shared addresses of matrix j's rows (16 bytes each) and every lane gets,
// in r[j], row g, columns 2t..2t+1 of matrix j; with .trans the
// transposed matrix: rows 2t..2t+1, column g.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace emmax {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32; the
// operands are tf32 values in b32 registers (see tf32_rna)
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32: x rounded to tf32 (10 explicit mantissa bits; the 13
// low bits of the fp32 pattern cleared, ties away from zero)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the 3xTF32 split x = big + small, big = rna(x), small = rna(x - big):
// big * big + big * small + small * big keeps fp32's accuracy on the
// tensor cores (the dropped small * small is ~2^-22 of the product)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16; `row` is this lane's row
// address (16-byte aligned)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// cp.async.cg.shared.global of 16 bytes; with `valid` false the 16 shared
// bytes are zero-filled and nothing is read (src-size 0)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// cp.async.ca.shared.global of N = 4 or 8 bytes (both addresses N-byte
// aligned); with `valid` false the N shared bytes are zero-filled and
// nothing is read
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid) {
  static_assert(N == 4 || N == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N), "r"(valid ? N : 0)
               : "memory");
}

// cp.async.commit_group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// cp.async.wait_group N: at most N of this thread's groups still pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// XOR swizzle for tiles of bf16 rows of ROW elements (a multiple of 64,
// i.e. of 128 bytes): the element offset of 16-byte chunk `chunk` of row
// `row`. Within each 128-byte group the chunk index is XORed with the row
// (mod 8), so the 8 row addresses of one ldmatrix matrix, and the 16-byte
// stores of cp.async, fall in 8 different bank groups.
template <int ROW>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  static_assert(ROW % 64 == 0, "swizzled rows are whole 128-byte groups");
  return row * ROW + ((chunk & ~7) | ((chunk ^ row) & 7)) * 8;
}

// two fp32 -> one b32 of bf16 (round to nearest even), `lo` in the lower
// half: the packing of an A fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a * b + c on two bf16 lanes (fma.rn.bf16x2), each operand a b32 of two
// bf16, the lower half the lower lane
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

}  // namespace mma
}  // namespace emmax
