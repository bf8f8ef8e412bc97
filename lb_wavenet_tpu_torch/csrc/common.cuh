// Shared device code of the WaveNet sampling kernels (ar_step.cu, ar_mega.cu).
//
// Both kernels give one thread block a tile of TB lanes (batch rows) and walk
// the layers inside the block. Activations of the tile live in shared memory
// FEATURE-major, x[k * TB + lane], so that a block-wide matrix product reads
// one weight element per (thread, k) from global memory (coalesced over the
// output index m, weights stored k-major) and the activations of LPG lanes as
// a broadcast shared-memory load. Products use CUDA cores: operands are
// rounded to the compute dtype (bf16 weights are stored as bf16; activations
// are rounded when staged), products and sums in fp32, k summed in order.
// Every (output, lane) pair is one thread's sequential sum, so a lane's
// result does not depend on its position in the batch or the tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wn {

constexpr int TB = 8;     // lanes per block (the lane tile)
constexpr int NT = 256;   // threads per block
constexpr int NLG = 2;    // lane groups per matrix-product item
constexpr int LPG = TB / NLG;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round to the compute dtype T, held in fp32.
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// out[m][lane] = sum_k W[k * ldw + m] * X[k * TB + lane] for m < M and all TB
// lanes; epi(m, lane, acc) consumes each sum. W is global (k-major), X is a
// shared-memory [K][TB] tile already rounded to the compute dtype. The item
// -> thread mapping depends only on (M, threadIdx), so two calls with the
// same M hand each (m, lane) to the same thread.
template <typename T, typename Epi>
__device__ __forceinline__ void block_mm(const T* __restrict__ W, int ldw, int M,
                                         int K, const float* X, Epi epi) {
  for (int item = threadIdx.x; item < M * NLG; item += NT) {
    const int m = item % M;
    const int lg = item / M;
    const float* x = X + lg * LPG;
    float acc[LPG];
#pragma unroll
    for (int j = 0; j < LPG; ++j) acc[j] = 0.f;
#pragma unroll 16
    for (int k = 0; k < K; ++k) {
      const float w = to_f(W[(size_t)k * ldw + m]);
      const float4 xv = *reinterpret_cast<const float4*>(x + k * TB);
      acc[0] = fmaf(w, xv.x, acc[0]);
      acc[1] = fmaf(w, xv.y, acc[1]);
      acc[2] = fmaf(w, xv.z, acc[2]);
      acc[3] = fmaf(w, xv.w, acc[3]);
    }
#pragma unroll
    for (int j = 0; j < LPG; ++j) epi(m, lg * LPG + j, acc[j]);
  }
}
static_assert(LPG == 4, "block_mm reads four lanes as one float4");

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// The per-lane counter hash (generate.perlane_gumbel, bit stage).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// Gumbel noise from 32 hash bits: u = ((bits >> 8) + 0.5) * 2^-24, then
// -log(-log(u)) with each log taken in double and rounded to float, the
// same arithmetic as the PyTorch version on either device.
__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = ((float)(bits >> 8) + 0.5f) * 5.9604644775390625e-08f;
  const float l1 = (float)log((double)u);
  return -(float)log((double)(-l1));
}

}  // namespace wn

extern "C" const char* wn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
