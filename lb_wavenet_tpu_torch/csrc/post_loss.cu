// Post network + masked cross-entropy, forward and backward, over the scored
// window of the training step.
//
// Replaces the Pallas kernels of lb_wavenet_tpu/ops/pallas/post_loss.py
// (`_fwd_kernel`, `_bwd_kernel`, both under `fused_post_loss`). The TPU
// version walks a sequential (B, time tiles) grid, skips the tiles of the
// unscored receptive-field head statically and carries the numerator and
// the post-weight gradients in VMEM scratch across the grid. Here a block
// owns PT rows of the window [head, T) of one batch row (head rows are never
// visited: they add 0 to the numerator and get dskip = 0 from the caller's
// zero fill) and keeps relu(skip), the hidden layer, the logits and the
// softmax of its rows in shared memory; only the scalar and the gradients
// leave it.
//
// Forward: `post_fwd_rows` writes one partial numerator per block (its rows
// summed in order); `post_sum` adds the partials in order (2 launches).
// Backward: `post_bwd_rows` recomputes the rows, forms
// dlogits = (softmax - onehot) * mask * gbar, writes dskip and the per-row
// h1, dlogits and du for the weight gradients; `wgrad_kernel` and
// `reduce_partials` (tile.cuh) reduce dw1, db1, dw2, db2 over the rows in a
// fixed order (3 launches). w1 and w2 (128 KB each in bf16) together exceed
// an SM's shared memory, so they are read through L1/L2 per k step.
//
// Bound on an H100 at WaveNet-30, B = 8, W = 10240, S = Q = 256: the forward
// is 2 B W S (S + Q) = 21.5 GFLOP, the backward ~3x that; skip in (0.1 GB)
// and dskip out set the byte bound, below the operation bound at the bf16
// tensor-core peak. CUDA-core FMAs here: a simple first version.
#include "tile.cuh"

namespace wn {

constexpr int PT = 16;  // window rows per block

struct PostArgs {
  const float* skip;   // (B, T, S)
  const int* tgt;      // (B, W)
  const float* mask;   // (B, W)
  const void* w1;      // (S, S) compute dtype
  const float* b1;     // (S,)
  const void* w2;      // (S, Q)
  const float* b2;     // (Q,)
  const void* w1T;     // (S, S) transposed (backward)
  const void* w2T;     // (Q, S)
  const float* gbar;   // () upstream cotangent of the numerator (backward)
  float* partial;      // forward: (blocks,); backward: (chunks, nw)
  float* num;          // () out (forward)
  float* dskip;        // (B, T, S) out (backward; head rows left as given)
  float* h1;           // (B, W, S) scratch (backward)
  float* g;            // (B, W, Q) scratch
  float* du;           // (B, W, S) scratch
  float* grads;        // (nw,) out: dw1 | db1 | dw2 | db2
  int B, T, W, S, Q, bf16, chunks;
};

// Stage relu(skip) of the block's rows feature-major, rounded.
template <typename T>
__device__ __forceinline__ void stage_relu(float* A, const PostArgs& a, int b, int w0) {
  const int head = a.T - a.W;
  for (int i = threadIdx.x; i < a.S * PT; i += NT) {
    const int s = i % a.S, r = i / a.S;
    float v = 0.f;
    if (w0 + r < a.W) v = fmaxf(a.skip[((size_t)b * a.T + head + w0 + r) * a.S + s], 0.f);
    A[s * PT + r] = rnd<T>(v);
  }
}

// Logits v = relu(relu(skip) w1 + b1) w2 + b2 of the block's rows into V
// ([PT][Q] row-major); H gets the rounded hidden layer, U (if given) its
// pre-relu value, both feature-major.
template <typename T>
__device__ __forceinline__ void logits(const PostArgs& a, const float* A, float* H, float* U,
                                       float* V) {
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  tile_mm2<PT, false>(A, w1, a.S, A, (const T*)nullptr, 0, a.S, [&](int t, int n, float s, float) {
    const float u = s + a.b1[n];
    if (U != nullptr) U[n * PT + t] = u;
    H[n * PT + t] = rnd<T>(fmaxf(u, 0.f));
  });
  __syncthreads();
  tile_mm2<PT, false>(H, w2, a.S, H, (const T*)nullptr, 0, a.Q, [&](int t, int n, float s, float) {
    V[t * a.Q + n] = s + a.b2[n];
  });
  __syncthreads();
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT) post_fwd_rows(PostArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* A = sm;              // [S][PT]
  float* H = A + a.S * PT;    // [S][PT]
  float* V = H + a.S * PT;    // [PT][Q]
  __shared__ float row_val[PT];
  const int b = blockIdx.y, w0 = blockIdx.x * PT;
  stage_relu<T>(A, a, b, w0);
  __syncthreads();
  logits<T>(a, A, H, nullptr, V);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < PT; r += NT / 32) {
    const float* v = V + r * a.Q;
    float m = -INFINITY;
    for (int q = lane; q < a.Q; q += 32) m = fmaxf(m, v[q]);
    m = warp_max(m);
    float e = 0.f;
    for (int q = lane; q < a.Q; q += 32) e += expf(v[q] - m);
    e = warp_sum(e);
    if (lane == 0) {
      float val = 0.f;
      if (w0 + r < a.W) {
        const size_t at = (size_t)b * a.W + w0 + r;
        val = ((logf(e) + m) - v[a.tgt[at]]) * a.mask[at];
      }
      row_val[r] = val;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < PT; ++r) s += row_val[r];
    a.partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// num = the n partials added in a fixed order (one block).
__global__ void __launch_bounds__(NT) post_sum(const float* __restrict__ partial, int n,
                                               float* __restrict__ num) {
  __shared__ float s[NT];
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) v += partial[i];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int o = NT / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) *num = s[0];
}

template <typename T>
__global__ void __launch_bounds__(NT) post_bwd_rows(PostArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* A = sm;              // [S][PT] rounded relu(skip)
  float* U = A + a.S * PT;    // [S][PT] pre-relu hidden
  float* H = U + a.S * PT;    // [S][PT] rounded hidden
  float* V = H + a.S * PT;    // [PT][Q] logits, then dlogits
  float* Gr = V + PT * a.Q;   // [Q][PT] rounded dlogits
  float* DU = Gr + a.Q * PT;  // [S][PT] rounded du
  const int b = blockIdx.y, w0 = blockIdx.x * PT, head = a.T - a.W;
  const float gbar = *a.gbar;
  stage_relu<T>(A, a, b, w0);
  __syncthreads();
  logits<T>(a, A, H, U, V);
  for (int i = threadIdx.x; i < a.S * PT; i += NT) {
    const int s = i % a.S, r = i / a.S;
    if (w0 + r < a.W) a.h1[((size_t)b * a.W + w0 + r) * a.S + s] = H[s * PT + r];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < PT; r += NT / 32) {
    float* v = V + r * a.Q;
    float m = -INFINITY;
    for (int q = lane; q < a.Q; q += 32) m = fmaxf(m, v[q]);
    m = warp_max(m);
    float e = 0.f;
    for (int q = lane; q < a.Q; q += 32) e += expf(v[q] - m);
    e = warp_sum(e);
    const bool valid = w0 + r < a.W;
    const size_t at = (size_t)b * a.W + w0 + r;
    const int tgt = valid ? a.tgt[at] : -1;
    const float scale = valid ? a.mask[at] * gbar : 0.f;
    for (int q = lane; q < a.Q; q += 32) {
      const float p = expf(v[q] - m) / e;
      const float g = (p - (q == tgt ? 1.f : 0.f)) * scale;
      v[q] = g;
      Gr[q * PT + r] = rnd<T>(g);
      if (valid) a.g[at * a.Q + q] = g;
    }
  }
  __syncthreads();
  tile_mm2<PT, false>(Gr, static_cast<const T*>(a.w2T), a.Q, Gr, (const T*)nullptr, 0, a.S,
                      [&](int t, int n, float s, float) {
                        const float du = U[n * PT + t] > 0.f ? s : 0.f;
                        DU[n * PT + t] = rnd<T>(du);
                        if (w0 + t < a.W) a.du[((size_t)b * a.W + w0 + t) * a.S + n] = du;
                      });
  __syncthreads();
  tile_mm2<PT, false>(DU, static_cast<const T*>(a.w1T), a.S, DU, (const T*)nullptr, 0, a.S,
                      [&](int t, int n, float s, float) {
                        if (w0 + t >= a.W) return;
                        const size_t at = ((size_t)b * a.T + head + w0 + t) * a.S + n;
                        a.dskip[at] = a.skip[at] > 0.f ? s : 0.f;
                      });
}

#define WN_TRY(expr)                          \
  do {                                        \
    cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

template <typename T>
static cudaError_t forward(const PostArgs& a, cudaStream_t s, int* launches) {
  const dim3 grid((a.W + PT - 1) / PT, a.B);
  const size_t bytes = sizeof(float) * PT * (2 * a.S + a.Q);
  WN_TRY(cudaFuncSetAttribute(post_fwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes));
  post_fwd_rows<T><<<grid, NT, bytes, s>>>(a);
  WN_TRY(cudaGetLastError());
  post_sum<<<1, NT, 0, s>>>(a.partial, (int)(grid.x * grid.y), a.num);
  WN_TRY(cudaGetLastError());
  *launches += 2;
  return cudaSuccess;
}

template <typename T>
static cudaError_t backward(const PostArgs& a, cudaStream_t s, int* launches) {
  const int S = a.S, Q = a.Q;
  const dim3 grid((a.W + PT - 1) / PT, a.B);
  const size_t bytes = sizeof(float) * PT * (4 * S + 2 * Q);
  WN_TRY(cudaFuncSetAttribute(post_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes));
  post_bwd_rows<T><<<grid, NT, bytes, s>>>(a);
  WN_TRY(cudaGetLastError());
  // Gradient pack: dw1 (S x S) | db1 (S) | dw2 (S x Q) | db2 (Q).
  const int nw = S * S + S + S * Q + Q;
  const int head = a.T - a.W;
  WGrad w;
  const WOp ao = wop(a.skip, 0, S, a.T, head, 0, 1), duo = wop(a.du, 0, S, a.W);
  const WOp ho = wop(a.h1, 0, S, a.W), go = wop(a.g, 0, Q, a.W);
  w.job[0] = outer(ao, duo, S, S, 0);
  w.job[1] = colsum(duo, S, S * S);
  w.job[2] = outer(ho, go, S, Q, S * S + S);
  w.job[3] = colsum(go, Q, S * S + S + S * Q);
  w.n_jobs = 4;
  w.n_pos_b = a.W;
  w.B = a.B;
  w.chunk = (a.B * a.W + a.chunks - 1) / a.chunks;
  w.nw = nw;
  w.round_bf16 = a.bf16;
  w.partial = a.partial;
  WN_TRY(launch_wgrad(w, a.chunks, s));
  WN_TRY(launch_reduce(a.partial, a.grads, 1, a.chunks, nw, s));
  *launches += 3;
  return cudaSuccess;
}

}  // namespace wn

extern "C" int wn_post_loss_rows() { return wn::PT; }

// Each returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_post_loss_fwd(const wn::PostArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::forward<__nv_bfloat16>(*a, s, launches)
                       : wn::forward<float>(*a, s, launches));
}

extern "C" int wn_post_loss_bwd(const wn::PostArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::backward<__nv_bfloat16>(*a, s, launches)
                       : wn::backward<float>(*a, s, launches));
}
