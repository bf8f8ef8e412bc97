// Shared device code of the training kernels (train_stack.cu, post_loss.cu).
//
// A block owns a tile of TT consecutive time rows of one batch row. Its
// activations live in shared memory FEATURE-major, a[k * TT + t], rounded to
// the compute dtype where they feed a product; weights are read from global
// memory (L1/L2) k-major, four consecutive outputs per load. Each thread
// computes a 4 (rows) x 4 (outputs) register tile with CUDA-core FMAs and
// sums k in order, so a result does not depend on the grid or the batch.
//
// Weight gradients reduce over every (batch, time) position. `wgrad_kernel`
// splits the positions into fixed chunks: block (tile, chunk) sums its chunk
// in position order into a partial, and `reduce_partials` adds the partials
// of each output in chunk order. No float atomics: a run is bit-reproducible.
#pragma once

#include "common.cuh"

namespace wn {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma16(float (&acc)[4][4], const float4 a, const float4 w) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
}

// Two products into one [TT][N] tile; epi(t, n, s1, s2) consumes
//   s1[t][n] = sum_{k < K1} A1[k][t] * W1[k * N + n]
//   s2[t][n] = sum_{k < K2} A2[k][t] * W2[k * N + n]   (0 when W2 is null)
// With FUSE the second sum continues the first accumulator (one K1 + K2
// contraction, the TPU kernel's tap concat) and s2 is 0. A1/A2 are shared
// feature-major tiles; W1/W2 global, k-major with row length N.
template <int TT, bool FUSE, typename T, typename Epi>
__device__ __forceinline__ void tile_mm2(const float* A1, const T* __restrict__ W1, int K1,
                                         const float* A2, const T* __restrict__ W2, int K2,
                                         int N, Epi epi) {
  const int nq = N / 4;
  for (int item = threadIdx.x; item < (TT / 4) * nq; item += NT) {
    const int n0 = (item % nq) * 4, t0 = (item / nq) * 4;
    float s1[4][4], s2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s1[i][j] = s2[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K1; ++k)
      fma16(s1, *reinterpret_cast<const float4*>(A1 + k * TT + t0),
            load4(W1 + (size_t)k * N + n0));
    if (W2 != nullptr) {
#pragma unroll 4
      for (int k = 0; k < K2; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(A2 + k * TT + t0);
        const float4 w = load4(W2 + (size_t)k * N + n0);
        if (FUSE) fma16(s1, a, w); else fma16(s2, a, w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(t0 + i, n0 + j, s1[i][j], s2[i][j]);
  }
}

// ---- weight gradients: sum over positions of outer products --------------

// A per-position vector: element i of position (b, w) is read from row
// row0 + w - shift of batch entry b (zero when that row is before row0),
// optionally through relu, as float or bf16.
struct WOp {
  const void* p;
  int bf16, ld, rows_per_b, row0, shift, relu;
};
// out[m * N + n] = sum_pos rnd(a[m]) * rnd(b[n]); with colsum, out[n] =
// sum_pos b[n] unrounded (a bias gradient).
struct WJob {
  WOp a, b;
  int M, N, out, colsum;
};
constexpr int MAX_JOBS = 8;
constexpr int WT = 64;  // output tile edge
constexpr int WK = 16;  // positions staged per step
struct WGrad {
  WJob job[MAX_JOBS];
  int n_jobs, n_pos_b, B, chunk, nw, round_bf16;
  float* partial;  // [chunks][nw], this call's slice
};

__host__ __device__ inline int job_tiles(const WJob& j) {
  return j.colsum ? (j.N + NT - 1) / NT : ((j.M + WT - 1) / WT) * ((j.N + WT - 1) / WT);
}

__device__ __forceinline__ float load_op(const WOp& o, int b, int w, int i) {
  const int row = o.row0 + w - o.shift;
  if (row < o.row0) return 0.f;
  const size_t at = ((size_t)b * o.rows_per_b + row) * o.ld + i;
  float v = o.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(o.p)[at])
                   : static_cast<const float*>(o.p)[at];
  return o.relu ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ float round_to(float v, int bf16) {
  return bf16 ? rnd<__nv_bfloat16>(v) : v;
}

__global__ void __launch_bounds__(NT) wgrad_kernel(WGrad a) {
  int tile = blockIdx.x, j = 0;
  for (; j < a.n_jobs - 1; ++j) {
    const int nt = job_tiles(a.job[j]);
    if (tile < nt) break;
    tile -= nt;
  }
  const WJob& jb = a.job[j];
  const int n_pos = a.B * a.n_pos_b;
  const int p0 = blockIdx.y * a.chunk, p1 = min(n_pos, p0 + a.chunk);
  float* out = a.partial + (size_t)blockIdx.y * a.nw + jb.out;
  if (jb.colsum) {
    const int n = tile * NT + threadIdx.x;
    if (n < jb.N) {
      float s = 0.f;
      for (int p = p0; p < p1; ++p) s += load_op(jb.b, p / a.n_pos_b, p % a.n_pos_b, n);
      out[n] = s;
    }
    return;
  }
  __shared__ __align__(16) float As[WK][WT], Bs[WK][WT];
  const int ntn = (jb.N + WT - 1) / WT;
  const int m_base = (tile / ntn) * WT, n_base = (tile % ntn) * WT;
  const int mq = threadIdx.x / (WT / 4), nq = threadIdx.x % (WT / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  for (int pb = p0; pb < p1; pb += WK) {
    for (int i = threadIdx.x; i < WK * WT; i += NT) {
      const int k = i / WT, e = i % WT, p = pb + k;
      float va = 0.f, vb = 0.f;
      if (p < p1) {
        const int b = p / a.n_pos_b, w = p % a.n_pos_b;
        if (m_base + e < jb.M) va = round_to(load_op(jb.a, b, w, m_base + e), a.round_bf16);
        if (n_base + e < jb.N) vb = round_to(load_op(jb.b, b, w, n_base + e), a.round_bf16);
      }
      As[k][e] = va;
      Bs[k][e] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WK; ++k)
      fma16(acc, *reinterpret_cast<const float4*>(&As[k][mq * 4]),
            *reinterpret_cast<const float4*>(&Bs[k][nq * 4]));
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int m = m_base + mq * 4 + i, n = n_base + nq * 4 + k;
      if (m < jb.M && n < jb.N) out[(size_t)m * jb.N + n] = acc[i][k];
    }
}

// out[g * nw + i] = sum_c partial[(g * chunks + c) * nw + i], c in order.
__global__ void __launch_bounds__(NT) reduce_partials(const float* __restrict__ partial,
                                                      float* __restrict__ out, int groups,
                                                      int chunks, int nw) {
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (size_t)groups * nw) return;
  const size_t g = idx / nw, i = idx % nw;
  const float* p = partial + g * chunks * nw + i;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += p[(size_t)c * nw];
  out[idx] = s;
}

// Launch the weight-gradient jobs of `a` over `chunks` chunks.
inline cudaError_t launch_wgrad(const WGrad& a, int chunks, cudaStream_t stream) {
  int tiles = 0;
  for (int j = 0; j < a.n_jobs; ++j) tiles += job_tiles(a.job[j]);
  wgrad_kernel<<<dim3(tiles, chunks), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch_reduce(const float* partial, float* out, int groups, int chunks,
                                 int nw, cudaStream_t stream) {
  const size_t n = (size_t)groups * nw;
  reduce_partials<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(partial, out, groups,
                                                                     chunks, nw);
  return cudaGetLastError();
}

inline WOp wop(const void* p, int bf16, int ld, int rows_per_b, int row0 = 0, int shift = 0,
               int relu = 0) {
  WOp o;
  o.p = p; o.bf16 = bf16; o.ld = ld; o.rows_per_b = rows_per_b;
  o.row0 = row0; o.shift = shift; o.relu = relu;
  return o;
}

inline WJob outer(WOp a, WOp b, int M, int N, int out) {
  WJob j;
  j.a = a; j.b = b; j.M = M; j.N = N; j.out = out; j.colsum = 0;
  return j;
}

inline WJob colsum(WOp b, int N, int out) {
  WJob j;
  j.a = b; j.b = b; j.M = 0; j.N = N; j.out = out; j.colsum = 1;
  return j;
}

}  // namespace wn
