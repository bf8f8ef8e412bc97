// Shared device code of the WaveNet sampling kernels (ar_step.cu, ar_mega.cu,
// ar_turbo.cu).
//
// The kernels give one thread block a tile of TB lanes (batch rows) and walk
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

// ---- one gated layer in the split order (the pallas and turbo engines) ----

template <typename T>
struct LayerW {  // layer l's weights (compute dtype) and biases (fp32)
  const T* w_cur;      // (C, 2G)
  const T* w_prev;     // (C, 2G)
  const float* b;      // (2G,)
  const T* w_res;      // (G, C)
  const float* b_res;  // (C,)
  const T* w_skip;     // (G, S)
  const float* b_skip; // (S,)
  const T* w_cond;     // (Cc, 2G), or null: unconditioned
  int Cc;
};

template <typename T>
__device__ __forceinline__ LayerW<T> layer_w(const void* w_cur, const void* w_prev,
                                             const float* b, const void* w_res,
                                             const float* b_res, const void* w_skip,
                                             const float* b_skip, const void* w_cond, int l,
                                             int C, int G, int S, int Cc) {
  return {static_cast<const T*>(w_cur) + (size_t)l * C * 2 * G,
          static_cast<const T*>(w_prev) + (size_t)l * C * 2 * G, b + l * 2 * G,
          static_cast<const T*>(w_res) + (size_t)l * G * C, b_res + l * C,
          static_cast<const T*>(w_skip) + (size_t)l * G * S, b_skip + l * S,
          w_cond ? static_cast<const T*>(w_cond) + (size_t)l * Cc * 2 * G : nullptr, Cc};
}

// Stage a tile's conditioning rounded to the compute dtype into cr
// [Cc][TB] (0 past B), from lane-major rows (B, Cc) (FM false) or
// feature-major ones (Cc, B). The caller syncs.
template <typename T, bool FM>
__device__ __forceinline__ void stage_cond(const T* cond, float* cr, int B, int b0, int Cc,
                                           int nthreads) {
  for (int i = threadIdx.x; i < Cc * TB; i += nthreads) {
    const int c = i / TB, j = i % TB, b = b0 + j;
    cr[i] = b < B ? rnd<T>(to_f(cond[FM ? (size_t)c * B + b : (size_t)b * Cc + c])) : 0.f;
  }
}

// The layer on the tile's residual stream x [C][TB] and skip sum [S][TB]
// (shared memory; xr, tr [C][TB], pre [2G][TB], zr [G][TB] scratch). `ring`
// is the layer's ring row (B, C): each lane's tap is read, then the same row
// takes its h. pre = (h @ w_cur + tap @ w_prev) + b (two sums), then, when
// conditioned, pre + cr @ w_cond (cr [Cc][TB] the staged conditioning; the
// JAX order); h = (h + z @ w_res) + b_res; skip = (skip + z @ w_skip) +
// b_skip.
template <typename T>
__device__ __forceinline__ void split_layer(const LayerW<T>& w, float* ring, int B, int b0,
                                            int C, int G, int S, float* x, float* xr,
                                            float* tr, float* pre, float* zr, float* skip,
                                            const float* cr) {
  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int j = i / C, c = i % C, b = b0 + j;
    const float h = x[c * TB + j];
    float tap = 0.f;
    if (b < B) {
      float* p = ring + (size_t)b * C + c;
      tap = *p;
      *p = h;
    }
    xr[c * TB + j] = rnd<T>(h);
    tr[c * TB + j] = rnd<T>(tap);
  }
  __syncthreads();
  block_mm(w.w_cur, 2 * G, 2 * G, C, xr,
           [&](int m, int j, float acc) { pre[m * TB + j] = acc; });
  block_mm(w.w_prev, 2 * G, 2 * G, C, tr, [&](int m, int j, float acc) {
    pre[m * TB + j] = (pre[m * TB + j] + acc) + w.b[m];
  });
  if (w.w_cond) {  // same M: each (m, lane) stays with its thread
    block_mm(w.w_cond, 2 * G, 2 * G, w.Cc, cr,
             [&](int m, int j, float acc) { pre[m * TB + j] = pre[m * TB + j] + acc; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * TB; i += NT) {
    const float z = tanhf(pre[i]) * sigmoidf(pre[G * TB + i]);
    zr[i] = rnd<T>(z);
  }
  __syncthreads();
  block_mm(w.w_res, C, C, G, zr, [&](int m, int j, float acc) {
    x[m * TB + j] = (x[m * TB + j] + acc) + w.b_res[m];
  });
  block_mm(w.w_skip, S, S, G, zr, [&](int m, int j, float acc) {
    skip[m * TB + j] = (skip[m * TB + j] + acc) + w.b_skip[m];
  });
  __syncthreads();
}

// ---- the step's finale (the mega and turbo kernels) -----------------------

// Post network of the tile: lg [Q][TB] = relu(relu(skip) @ w1 + b1) @ w2 + b2
// (ar, hid [S][TB] scratch); emit(m, j, v) sees each logit.
template <typename T, typename Emit>
__device__ __forceinline__ void post_logits(const float* skip, float* ar, float* hid,
                                            float* lg, const T* w1, const float* b1,
                                            const T* w2, const float* b2, int S, int Q,
                                            Emit emit) {
  for (int i = threadIdx.x; i < S * TB; i += NT) ar[i] = rnd<T>(fmaxf(skip[i], 0.f));
  __syncthreads();
  block_mm(w1, S, S, S, ar, [&](int m, int j, float acc) {
    hid[m * TB + j] = rnd<T>(fmaxf(acc + b1[m], 0.f));
  });
  __syncthreads();
  block_mm(w2, Q, Q, S, hid, [&](int m, int j, float acc) {
    const float v = acc + b2[m];
    lg[m * TB + j] = v;
    emit(m, j, v);
  });
  __syncthreads();
}

struct Sampler {
  const int* lane;  // (lane_rows, B): seeds; lease times; [f32(1/tau) bits]
  int lane_rows;
  int mode;         // 0 greedy, 1 per-lane hash, 2 counter hash over the batch
  int seed_base;    // mode 2: the step's seed is seed_base + t
  float inv_temp;   // f32(1/tau) (modes 1 with 2 lane rows, and 2)
  int ctr_q, ctr_b; // mode 2: counter of (q, b) = q * ctr_q + b * ctr_b
};

// Gumbel-max sampling of lg [Q][TB] at absolute step t, one warp per lane:
// first-max argmax, then the forced override (forced[b] >= 0). The class
// goes to cls[j] (shared; 0 for tile lanes past B) and out[b].
__device__ __forceinline__ void sample_tile(const float* lg, const Sampler& sp, int B, int b0,
                                            int Q, int t_abs, const int* forced, int* cls,
                                            int* out) {
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  for (int j = warp; j < TB; j += NT / 32) {
    const int b = b0 + j;
    if (b >= B) {
      if (lid == 0) cls[j] = 0;
      continue;
    }
    float best = -INFINITY;
    int bq = Q;
    for (int q = lid; q < Q; q += 32) {
      const float v = lg[q * TB + j];
      float s = v;
      if (sp.mode == 1) {
        const uint32_t seed = (uint32_t)sp.lane[b];
        const uint32_t tl = (uint32_t)(t_abs - sp.lane[B + b]);
        const float g = gumbel(mix32(seed + tl * 0x9E3779B9u + (uint32_t)q * 0x7FEB352Du));
        if (sp.lane_rows == 3) {
          const float inv = __int_as_float(sp.lane[2 * B + b]);
          s = inv > 0.f ? __fadd_rn(__fmul_rn(v, inv), g) : v;
        } else {
          s = __fadd_rn(__fmul_rn(v, sp.inv_temp), g);
        }
      } else if (sp.mode == 2) {
        const uint32_t ctr = (uint32_t)q * (uint32_t)sp.ctr_q + (uint32_t)b * (uint32_t)sp.ctr_b;
        const uint32_t seed = (uint32_t)(sp.seed_base + t_abs);
        s = __fadd_rn(__fmul_rn(v, sp.inv_temp), gumbel(mix32(seed + ctr * 0x9E3779B9u)));
      }
      if (s > best) { best = s; bq = q; }  // q rises: keeps the first max
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oq = __shfl_xor_sync(0xffffffffu, bq, o);
      if (ob > best || (ob == best && oq < bq)) { best = ob; bq = oq; }
    }
    if (lid == 0) {
      const int f = forced[b];
      const int c = f >= 0 ? f : bq;
      cls[j] = c;
      out[b] = c;
    }
  }
  __syncthreads();
}

// Next step's frontend: e = emb[cls] (the compute dtype, as the one-hot
// matmul gives it), x = (b_in + e @ w_in[K-1]) + sum_j es[j] @ w_in[j], then
// the stack es [(K-1)C][TB] shifts and takes e. er [C][TB] and xr scratch.
template <typename T>
__device__ __forceinline__ void next_frontend(float* x, float* xr, float* es, float* er,
                                              const int* cls, const T* emb, const T* w_in,
                                              const float* b_in, int C, int K) {
  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int c = i / TB, j = i % TB;
    er[i] = to_f(emb[(size_t)cls[j] * C + c]);
  }
  __syncthreads();
  block_mm(w_in + (size_t)(K - 1) * C * C, C, C, C, er, [&](int m, int j, float acc) {
    x[m * TB + j] = b_in[m] + acc;
  });
  __syncthreads();
  for (int p = 0; p < K - 1; ++p) {
    // The rounded past embedding goes through xr (free until next step).
    for (int i = threadIdx.x; i < C * TB; i += NT) xr[i] = rnd<T>(es[p * C * TB + i]);
    __syncthreads();
    block_mm(w_in + (size_t)p * C * C, C, C, C, xr, [&](int m, int j, float acc) {
      x[m * TB + j] = x[m * TB + j] + acc;
    });
    __syncthreads();
  }
  if (K > 1) {
    for (int i = threadIdx.x; i < C * TB; i += NT) {
      for (int p = 0; p < K - 2; ++p) es[p * C * TB + i] = es[(p + 1) * C * TB + i];
      es[(K - 2) * C * TB + i] = er[i];
    }
    __syncthreads();
  }
}

}  // namespace wn

extern "C" const char* wn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
