// Tensor-core tile helpers of the training kernels' bf16 routes
// (train_stack.cu namespace tsc, post_loss.cu namespace ptc): ldmatrix
// fragment loads from shared-memory tiles, mma.sync m16n8k16 bf16 -> fp32,
// the from-zero k-step sum the plain versions model, and cp.async.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wn {
namespace tct {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A operand (16 x 16: rows m0.., depth k0..) of a row-major [m][k] tile.
__device__ __forceinline__ void lda_rm(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(a, sa(s + (m0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + k0 + (l >> 4) * 8));
}
// A operand of a depth-major [k][m] tile (A = tile^T).
__device__ __forceinline__ void lda_km(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4t(a, sa(s + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8));
}
// B operands of two 8-column tiles (n0.. in b[0..1], n0 + 8.. in b[2..3]),
// depth k0..k0+15, from an output-major [n][k] tile.
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(b, sa(s + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8));
}
// The same from a depth-major [k][n] tile.
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* s, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4t(b, sa(s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8));
}

// d += A B for one 16x8 tile: d[0], d[1] at (row g, cols 2q, 2q+1), d[2],
// d[3] at row g + 8 (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B for one 16x8 tile and one 16-deep k-step: the mma runs from
// zero and its result is added to the fp32 sum, so a product is ((s_0 +
// s_1) + s_2) + ... over its k-steps, the order ar_tc.py `tc_product`
// reproduces bit for bit (the sum inside an mma from zero is calibrated;
// with a live accumulator it is not).
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma(s, a, b0, b1);
#pragma unroll
  for (int v = 0; v < 4; ++v) acc[v] += s[v];
}

// Two 8-column tiles of a 16-row strip: d[0] (cols n0..), d[1] (n0 + 8..).
__device__ __forceinline__ void mma2(float (&d)[2][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma_add(d[0], a, b[0], b[1]);
  mma_add(d[1], a, b[2], b[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
}

// 16-byte asynchronous copy global -> shared, zeros when !valid (no bytes
// read); complete at the thread's next cp.async wait.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sa(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

}  // namespace tct
}  // namespace wn
