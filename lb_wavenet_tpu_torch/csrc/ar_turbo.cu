// turbo_step: one whole autoregressive sample step per launch.
//
// Replaces the Pallas kernel lb_wavenet_tpu/ops/pallas/ar_turbo.py
// (`turbo_step`, body `_turbo_kernel`). The TPU version walks a sequential grid
// over the L layers with h and the skip sum in VMEM scratch and runs the
// finale in the last grid step: the post network, Gumbel-max sampling, the
// forced-class override, the next class's embedding and the next step's K-tap
// input conv. Here one block owns a tile of TB lanes and runs all L layers,
// then the finale, so no grid-wide synchronisation is needed (the design of
// ar_step.cu and ar_mega.cu, whose device code it shares through common.cuh):
//   * layers in turbo's split order, pre = (h @ w_cur + tap @ w_prev) + b,
//     each lane's tap read from ring row offset_l + t mod d_l before that row
//     takes h (the JAX kernel aliases the ring onto its output);
//   * the finale of mega: post network, sampling (greedy; the per-lane
//     counter hash with 2 or 3 lane rows; or, for global_rng, the counter
//     hash over the batch with counter b * Q + q and seed seed_base + t, the
//     JAX kernel's interpret-mode branch: the TPU's hardware PRNG has no
//     counterpart here), first-max argmax, the forced override, then
//     h0_next = (b_in + e @ w_in[K-1]) + sum_j estack[j] @ w_in[j] and the
//     embedding stack shifted left with e appended.
// The kernel takes the absolute step t and computes its ring slots and its
// seed itself; `wn_turbo_steps` launches it once per step of a chunk with
// t, t+1, ..., so a chunk is queued without a host round trip. h and the
// embedding stack are carried in place from step to step (a block reads its
// lanes before it writes them).
//
// Bound on an H100 at the serving shapes (WaveNet-30, B = 512): per step
// 2 B (L (2C 2G + G C + G S) + S S + S Q + K C C) ~ 1.3 GFLOP of bf16 products
// (1.3 us at 989 TFLOP/s) against ~2.5 MB of bf16 weights and 2 L B C fp32
// ring values (~7.9 MB, 2.4 us at 3.35 TB/s): bytes bound. Like ar_step.cu
// the step is latency-bound in this first version: CUDA-core fp32 FMAs on
// weights read from L2 in a dependent k-loop, 64 blocks at B = 512.
#include "common.cuh"

namespace wn {

struct TurboArgs {
  float* bufs;          // (sum_d, B, C) ring, in place
  float* h;             // (B, C) the step's residual input, then the next's
  float* e;             // (K-1, B, C) embedding stack, shifted in place
  const int* dils;      // (L,)
  const void* w_cur;    // (L, C, 2G) compute dtype
  const void* w_prev;   // (L, C, 2G)
  const float* b;       // (L, 2G)
  const void* w_res;    // (L, G, C)
  const float* b_res;   // (L, C)
  const void* w_skip;   // (L, G, S)
  const float* b_skip;  // (L, S)
  const void* w1;       // (S, S)
  const float* b1;      // (S,)
  const void* w2;       // (S, Q)
  const float* b2;      // (Q,)
  const void* emb;      // (Q, C)
  const void* w_in;     // (K, C, C)
  const float* b_in;    // (C,)
  const int* forced;    // (T, B), -1 = free-running
  const int* lane;      // (lane_rows, B) or null
  int* classes;         // (T, B) out
  float* logits;        // (T, B, Q) out, or null
  int B, L, C, G, S, Q, K;
  int lane_rows, seed_base, mode;  // mode: 0 greedy, 1 per-lane, 2 global
  float inv_temp;
  int bf16;
};

template <typename T>
__global__ void __launch_bounds__(NT) turbo_kernel(TurboArgs a, int t, int step) {
  extern __shared__ float sm[];
  const int C = a.C, G = a.G, S = a.S, Q = a.Q, K = a.K, B = a.B;
  float* x = sm;                      // [C][TB] residual stream h (fp32)
  float* xr = x + C * TB;             // [C][TB] rounded h
  float* tr = xr + C * TB;            // [C][TB] rounded tap
  float* pre = tr + C * TB;           // [2G][TB]
  float* zr = pre + 2 * G * TB;       // [G][TB] rounded gate output
  float* skip = zr + G * TB;          // [S][TB]
  float* ar = skip + S * TB;          // [S][TB] rounded relu(skip)
  float* hid = ar + S * TB;           // [S][TB] rounded hidden
  float* lg = hid + S * TB;           // [Q][TB] logits
  float* es = lg + Q * TB;            // [(K-1)C][TB] embedding stack (fp32)
  float* er = es + (K - 1) * C * TB;  // [C][TB] rounded embedding operand
  int* cls = reinterpret_cast<int*>(er + C * TB);  // [TB]
  const int b0 = blockIdx.x * TB;

  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int j = i / C, c = i % C, b = b0 + j;
    x[c * TB + j] = b < B ? a.h[(size_t)b * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += NT) {
    const int p = i / (C * TB), j = (i / C) % TB, c = i % C, b = b0 + j;
    es[(p * C + c) * TB + j] = b < B ? a.e[((size_t)p * B + b) * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < S * TB; i += NT) skip[i] = 0.f;
  __syncthreads();

  int off = 0;
  for (int l = 0; l < a.L; ++l) {
    const int d = a.dils[l];
    const LayerW<T> w = layer_w<T>(a.w_cur, a.w_prev, a.b, a.w_res, a.b_res, a.w_skip,
                                   a.b_skip, l, C, G, S);
    split_layer(w, a.bufs + (size_t)(off + t % d) * B * C, B, b0, C, G, S, x, xr, tr, pre,
                zr, skip);
    off += d;
  }

  float* logits = a.logits ? a.logits + (size_t)step * B * Q : nullptr;
  post_logits(skip, ar, hid, lg, static_cast<const T*>(a.w1), a.b1,
              static_cast<const T*>(a.w2), a.b2, S, Q, [&](int m, int j, float v) {
                if (logits && b0 + j < B) logits[(size_t)(b0 + j) * Q + m] = v;
              });
  // The global counter hash runs over (b, q) batch-major: b * Q + q.
  const Sampler sp = {a.lane, a.lane_rows, a.mode, a.seed_base, a.inv_temp, 1, Q};
  sample_tile(lg, sp, B, b0, Q, t, a.forced + (size_t)step * B, cls,
              a.classes + (size_t)step * B);
  next_frontend(x, xr, es, er, cls, static_cast<const T*>(a.emb),
                static_cast<const T*>(a.w_in), a.b_in, C, K);

  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int j = i / C, c = i % C, b = b0 + j;
    if (b < B) a.h[(size_t)b * C + c] = x[c * TB + j];
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += NT) {
    const int p = i / (C * TB), j = (i / C) % TB, c = i % C, b = b0 + j;
    if (b < B) a.e[((size_t)p * B + b) * C + c] = es[(p * C + c) * TB + j];
  }
}

// Launch the kernel for steps t0 .. t0 + n - 1 (step i reads forced row i and
// writes class and logits row i).
template <typename T>
static cudaError_t steps(const TurboArgs& a, int t0, int n, cudaStream_t stream,
                         int* launches) {
  const size_t smem = sizeof(float) * TB *
                          (4 * a.C + 3 * a.G + 3 * a.S + a.Q + (a.K - 1) * a.C) +
                      sizeof(int) * TB;
  cudaError_t err = cudaFuncSetAttribute(
      turbo_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.B + TB - 1) / TB;
  for (int i = 0; i < n; ++i) {
    turbo_kernel<T><<<grid, NT, smem, stream>>>(a, t0 + i, i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

}  // namespace wn

// Steps t0 .. t0 + n - 1, one launch each. Returns a CUDA error code and adds
// the kernels it launched to *launches.
extern "C" int wn_turbo_steps(const wn::TurboArgs* a, int t0, int n, void* stream,
                              int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::steps<__nv_bfloat16>(*a, t0, n, s, launches)
                       : wn::steps<float>(*a, t0, n, s, launches));
}
