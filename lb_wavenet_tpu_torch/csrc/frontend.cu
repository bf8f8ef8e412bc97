// The input frontend of the training step, forward and backward: the
// embedding of the input classes and the width-K causal input conv,
//   h0[b, t] = bias + sum_k rnd(embed[x[b, t - (K-1) + k]]) @ rnd(w[k]).
//
// Replaces the Pallas kernels of lb_wavenet_tpu/ops/pallas/frontend.py
// (`_fwd_kernel`, `_bwd_kernel`, both under `fused_frontend`). The TPU version
// builds a one-hot of each time tile and contracts it with the table on the
// MXU (a gather written as a matrix product), and carries the three gradients
// in VMEM scratch across its sequential grid. Here the gather is a gather, and
// the gradients reduce in fixed chunks:
//
// Forward (`front_fwd`, 1 launch): a block owns FT time rows of one batch row;
// it stages the FT + K - 1 embedding rows the taps need (rounded to the compute
// dtype; positions before t = 0 and out-of-range classes give zero rows) in
// shared memory, and each thread sums (row, output) items tap by tap:
// h = bias + ((tap_0 + tap_1) + ...), each tap a sequential fp32 sum over C.
//
// Backward (4 launches): `front_de` (one thread per (position, c)) writes
// d_e[s] = sum_k rnd(dh[s + K-1-k] @ rnd(w[k])^T) and the unrounded gathered
// embedding e[s]; `front_scatter` gives one block a chunk of SCATTER positions
// and one thread each column c, which walks the chunk in position order adding
// d_e into a (Q, C) partial in shared memory by class; `wgrad_kernel`
// (tile.cuh) forms d_w[k] = sum_s e[s - (K-1-k)]^T dh[s] and d_b = sum_s dh[s]
// over the same chunks; `reduce_partials` adds every chunk's partial
// [d_embed | d_w | d_b] in chunk order. No float atomics: the result does not
// change from run to run.
//
// Bound on an H100 at the training shapes (WaveNet-30, B = 8, T = 13310,
// C = 64, K = 2): the forward writes h0 (27 MB fp32) and does 2 B T K C C =
// 1.7 GFLOP; the backward reads dh (27 MB) and does twice that. Both are set
// by bytes (~8 us each at 3.35 TB/s). This first version moves more than that
// (the backward writes and reads d_e and e, 4 x 27 MB) and multiplies on CUDA
// cores; the chunked scatter walks its chunk with one thread per column.
#include "tile.cuh"

namespace wn {

constexpr int FT = 32;         // time rows per forward / d_e block
constexpr int SCATTER = 256;   // positions per scatter chunk

struct FrontArgs {
  const int* x;        // (B, T) classes
  const float* emb;    // (Q, C) fp32
  const void* w;       // (K, C, C) compute dtype
  const void* wT;      // (K, C, C) w[k] transposed, compute dtype (backward)
  const float* bias;   // (C,)
  float* h;            // (B, T, C) out (forward)
  const float* dh;     // (B, T, C) cotangent of h (backward)
  float* de;           // (B, T, C) scratch: d_e
  float* e;            // (B, T, C) scratch: unrounded embedding rows
  float* partial;      // (chunks, Q C + K C C + C) per-chunk gradients
  float* grads;        // (Q C + K C C + C) out: d_embed | d_w | d_b
  int B, T, Q, C, K, bf16;
};

__device__ __forceinline__ bool valid_class(int v, int Q) { return v >= 0 && v < Q; }

template <typename T>
__global__ void __launch_bounds__(NT) front_fwd(FrontArgs a) {
  extern __shared__ __align__(16) float E[];  // [FT + K - 1][C] rounded rows
  const int C = a.C, K = a.K, rows = FT + K - 1;
  const int b = blockIdx.y, t0 = blockIdx.x * FT;
  for (int i = threadIdx.x; i < rows * C; i += NT) {
    const int r = i / C, c = i % C, p = t0 - (K - 1) + r;
    float v = 0.f;
    if (p >= 0 && p < a.T) {
      const int cls = a.x[(size_t)b * a.T + p];
      if (valid_class(cls, a.Q)) v = rnd<T>(a.emb[(size_t)cls * C + c]);
    }
    E[i] = v;
  }
  __syncthreads();
  const T* w = static_cast<const T*>(a.w);
  for (int item = threadIdx.x; item < FT * C; item += NT) {
    const int r = item / C, n = item % C;
    if (t0 + r >= a.T) continue;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* er = E + (r + k) * C;
      const T* wk = w + (size_t)k * C * C + n;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s = fmaf(er[c], to_f(wk[(size_t)c * C]), s);
      acc = k == 0 ? s : acc + s;
    }
    a.h[((size_t)b * a.T + t0 + r) * C + n] = a.bias[n] + acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) front_de(FrontArgs a) {
  extern __shared__ __align__(16) float D[];  // [FT + K - 1][C] dh rows t0 .. t0+FT+K-2
  const int C = a.C, K = a.K, rows = FT + K - 1;
  const int b = blockIdx.y, t0 = blockIdx.x * FT;
  for (int i = threadIdx.x; i < rows * C; i += NT) {
    const int r = i / C, t = t0 + r;
    D[i] = t < a.T ? a.dh[((size_t)b * a.T + t) * C + i % C] : 0.f;
  }
  __syncthreads();
  const T* wT = static_cast<const T*>(a.wT);
  for (int item = threadIdx.x; item < FT * C; item += NT) {
    const int r = item / C, c = item % C, s = t0 + r;
    if (s >= a.T) continue;
    // d_e[s] takes tap k's piece of output position s + K-1-k, each piece
    // rounded to the compute dtype before the fp32 tap-sum.
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int t = s + K - 1 - k;
      if (t >= a.T) continue;
      const float* dr = D + (r + K - 1 - k) * C;
      const T* wk = wT + (size_t)k * C * C + c;
      float p = 0.f;
      for (int n = 0; n < C; ++n) p = fmaf(dr[n], to_f(wk[(size_t)n * C]), p);
      acc += rnd<T>(p);
    }
    const size_t at = ((size_t)b * a.T + s) * C + c;
    a.de[at] = acc;
    const int cls = a.x[(size_t)b * a.T + s];
    a.e[at] = valid_class(cls, a.Q) ? a.emb[(size_t)cls * C + c] : 0.f;
  }
}

// Block = one chunk of SCATTER positions; thread c owns column c of the
// chunk's (Q, C) partial and adds d_e in position order.
__global__ void front_scatter(FrontArgs a) {
  extern __shared__ __align__(16) float P[];  // [Q][C]
  const int C = a.C, Q = a.Q, c = threadIdx.x;
  for (int i = threadIdx.x; i < Q * C; i += blockDim.x) P[i] = 0.f;
  __syncthreads();
  const int n_pos = a.B * a.T;
  const int p0 = blockIdx.x * SCATTER, p1 = min(n_pos, p0 + SCATTER);
  if (c < C) {
    for (int p = p0; p < p1; ++p) {
      const int cls = a.x[p];
      if (valid_class(cls, Q)) P[cls * C + c] += a.de[(size_t)p * C + c];
    }
  }
  __syncthreads();
  float* out = a.partial + (size_t)blockIdx.x * (Q * C + a.K * C * C + C);
  for (int i = threadIdx.x; i < Q * C; i += blockDim.x) out[i] = P[i];
}

#define WN_TRY(expr)                  \
  do {                                \
    cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
static cudaError_t forward(const FrontArgs& a, cudaStream_t s, int* launches) {
  const size_t bytes = sizeof(float) * (FT + a.K - 1) * a.C;
  WN_TRY(cudaFuncSetAttribute(front_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes));
  front_fwd<T><<<dim3((a.T + FT - 1) / FT, a.B), NT, bytes, s>>>(a);
  WN_TRY(cudaGetLastError());
  *launches += 1;
  return cudaSuccess;
}

template <typename T>
static cudaError_t backward(const FrontArgs& a, cudaStream_t s, int* launches) {
  const int C = a.C, Q = a.Q, K = a.K;
  const size_t rows_bytes = sizeof(float) * (FT + K - 1) * C;
  WN_TRY(cudaFuncSetAttribute(front_de<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)rows_bytes));
  front_de<T><<<dim3((a.T + FT - 1) / FT, a.B), NT, rows_bytes, s>>>(a);
  WN_TRY(cudaGetLastError());

  const int n_pos = a.B * a.T;
  const int chunks = (n_pos + SCATTER - 1) / SCATTER;
  const size_t part_bytes = sizeof(float) * Q * C;
  WN_TRY(cudaFuncSetAttribute(front_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)part_bytes));
  front_scatter<<<chunks, (C + 31) / 32 * 32, part_bytes, s>>>(a);
  WN_TRY(cudaGetLastError());

  // d_w[k] = sum_s e[s - (K-1-k)]^T dh[s] and d_b = sum_s dh[s], unrounded,
  // over the scatter's chunks, into the same partial rows after d_embed.
  const int nw = Q * C + K * C * C + C;
  WGrad w;
  const WOp dho = wop(a.dh, 0, C, a.T);
  for (int k = 0; k < K; ++k)
    w.job[k] = outer(wop(a.e, 0, C, a.T, 0, K - 1 - k), dho, C, C, Q * C + k * C * C);
  w.job[K] = colsum(dho, C, Q * C + K * C * C);
  w.n_jobs = K + 1;
  w.n_pos_b = a.T;
  w.B = a.B;
  w.chunk = SCATTER;
  w.nw = nw;
  w.round_bf16 = 0;
  w.partial = a.partial;
  WN_TRY(launch_wgrad(w, chunks, s));
  WN_TRY(launch_reduce(a.partial, a.grads, 1, chunks, nw, s));
  *launches += 4;
  return cudaSuccess;
}

}  // namespace wn

extern "C" int wn_front_scatter_chunk() { return wn::SCATTER; }

// Each returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_front_fwd(const wn::FrontArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::forward<__nv_bfloat16>(*a, s, launches)
                       : wn::forward<float>(*a, s, launches));
}

extern "C" int wn_front_bwd(const wn::FrontArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::backward<__nv_bfloat16>(*a, s, launches)
                       : wn::backward<float>(*a, s, launches));
}
