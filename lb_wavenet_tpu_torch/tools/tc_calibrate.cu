// One mma.sync.m16n8k16 bf16 -> fp32 per warp on given tiles, to check the
// model of the tensor core's rounding (tc_calibrate.py).
// A (n,16,16) [m][k], B (n,16,8) [k][n], C and D (n,16,8) [m][n].
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t pk(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__global__ void calib(const __nv_bfloat16* A, const __nv_bfloat16* Bm, const float* Cm, float* D,
                      int n) {
  const int tile = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (tile >= n) return;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* a = A + (size_t)tile * 256;
  const __nv_bfloat16* b = Bm + (size_t)tile * 128;
  const float* c = Cm + (size_t)tile * 128;
  float* d = D + (size_t)tile * 128;
  uint32_t a0 = pk(a[g * 16 + 2 * t], a[g * 16 + 2 * t + 1]);
  uint32_t a1 = pk(a[(g + 8) * 16 + 2 * t], a[(g + 8) * 16 + 2 * t + 1]);
  uint32_t a2 = pk(a[g * 16 + 2 * t + 8], a[g * 16 + 2 * t + 9]);
  uint32_t a3 = pk(a[(g + 8) * 16 + 2 * t + 8], a[(g + 8) * 16 + 2 * t + 9]);
  uint32_t b0 = pk(b[(2 * t) * 8 + g], b[(2 * t + 1) * 8 + g]);
  uint32_t b1 = pk(b[(2 * t + 8) * 8 + g], b[(2 * t + 9) * 8 + g]);
  float r[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                c[(g + 8) * 8 + 2 * t + 1]};
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  d[g * 8 + 2 * t] = r[0];
  d[g * 8 + 2 * t + 1] = r[1];
  d[(g + 8) * 8 + 2 * t] = r[2];
  d[(g + 8) * 8 + 2 * t + 1] = r[3];
}

extern "C" int run_calib(const void* A, const void* B, const void* C, void* D, int n, void* s) {
  calib<<<(n + 7) / 8, 256, 0, (cudaStream_t)s>>>((const __nv_bfloat16*)A,
                                                   (const __nv_bfloat16*)B, (const float*)C,
                                                   (float*)D, n);
  return (int)cudaGetLastError();
}
