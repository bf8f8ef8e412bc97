// fused_stack: one autoregressive sample step through all L gated layers.
//
// Replaces the Pallas kernel lb_wavenet_tpu/ops/pallas/ar_step.py
// (`fused_stack`, body `_stack_kernel`). The TPU version runs a sequential
// grid over layers, carries h and the skip sum in VMEM scratch and gets each
// layer's ring slot by scalar prefetch. Here one block owns a tile of TB
// lanes and loops over the layers itself: h (C per lane), the skip sum (S per
// lane) and the gate pre-activations stay in shared memory, and the block
// computes its own ring slot offset_l + t mod d_l. For each layer the tap is
// read from the packed ring (sum_d, B, C) before the same row is overwritten
// with h; lanes are disjoint across blocks, so blocks never race.
//
// Bound on an H100 at the serving shapes (WaveNet-30, B = 512): the step
// reads ~2.4 MB of bf16 weights and moves 2 L B C fp32 ring values
// (~7.9 MB), against 2 B L (2C 2G + G C + G S) = 1.1 GFLOP; both bounds are
// a few microseconds, so a launch per step is latency-bound. The design keeps
// every intermediate on chip and reads each weight once per block from L2.
#include "common.cuh"

namespace wn {

struct StackArgs {
  const float* h0;     // (B, C)
  float* bufs;         // (sum_d, B, C), updated in place
  const int* dils;     // (L,)
  const void* w_cur;   // (L, C, 2G)  compute dtype
  const void* w_prev;  // (L, C, 2G)
  const float* b;      // (L, 2G)
  const void* w_res;   // (L, G, C)
  const float* b_res;  // (L, C)
  const void* w_skip;  // (L, G, S)
  const float* b_skip; // (L, S)
  float* skip;         // (B, S) out
  int B, L, C, G, S, t, bf16;
};

template <typename T>
__global__ void __launch_bounds__(NT) stack_kernel(StackArgs a) {
  extern __shared__ float sm[];
  const int C = a.C, G = a.G, S = a.S, B = a.B;
  float* x = sm;                 // [C][TB] residual stream h (fp32)
  float* xr = x + C * TB;        // [C][TB] rounded h
  float* tr = xr + C * TB;       // [C][TB] rounded tap
  float* pre = tr + C * TB;      // [2G][TB]
  float* zr = pre + 2 * G * TB;  // [G][TB] rounded gate output
  float* skip = zr + G * TB;     // [S][TB]
  const int b0 = blockIdx.x * TB;
  const T* w_cur = static_cast<const T*>(a.w_cur);
  const T* w_prev = static_cast<const T*>(a.w_prev);
  const T* w_res = static_cast<const T*>(a.w_res);
  const T* w_skip = static_cast<const T*>(a.w_skip);

  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int j = i / C, c = i % C, b = b0 + j;
    x[c * TB + j] = b < B ? a.h0[(size_t)b * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < S * TB; i += NT) skip[i] = 0.f;
  __syncthreads();

  int off = 0;
  for (int l = 0; l < a.L; ++l) {
    const int d = a.dils[l];
    const int slot = off + a.t % d;
    // Read the tap, then overwrite the same ring row with this layer's h.
    for (int i = threadIdx.x; i < C * TB; i += NT) {
      const int j = i / C, c = i % C, b = b0 + j;
      const float h = x[c * TB + j];
      float tap = 0.f;
      if (b < B) {
        float* p = a.bufs + ((size_t)slot * B + b) * C + c;
        tap = *p;
        *p = h;
      }
      xr[c * TB + j] = rnd<T>(h);
      tr[c * TB + j] = rnd<T>(tap);
    }
    __syncthreads();
    // pre = (h @ w_cur + tap @ w_prev) + b: two sums, as the JAX kernel.
    block_mm(w_cur + (size_t)l * C * 2 * G, 2 * G, 2 * G, C, xr,
             [&](int m, int j, float acc) { pre[m * TB + j] = acc; });
    block_mm(w_prev + (size_t)l * C * 2 * G, 2 * G, 2 * G, C, tr,
             [&](int m, int j, float acc) {
               pre[m * TB + j] = (pre[m * TB + j] + acc) + a.b[l * 2 * G + m];
             });
    __syncthreads();
    for (int i = threadIdx.x; i < G * TB; i += NT) {
      const float z = tanhf(pre[i]) * sigmoidf(pre[G * TB + i]);
      zr[i] = rnd<T>(z);
    }
    __syncthreads();
    // h = (h + z @ w_res) + b_res;  skip = (skip + z @ w_skip) + b_skip.
    block_mm(w_res + (size_t)l * G * C, C, C, G, zr, [&](int m, int j, float acc) {
      x[m * TB + j] = (x[m * TB + j] + acc) + a.b_res[l * C + m];
    });
    block_mm(w_skip + (size_t)l * G * S, S, S, G, zr, [&](int m, int j, float acc) {
      skip[m * TB + j] = (skip[m * TB + j] + acc) + a.b_skip[l * S + m];
    });
    __syncthreads();
    off += d;
  }
  for (int i = threadIdx.x; i < S * TB; i += NT) {
    const int j = i / S, s = i % S, b = b0 + j;
    if (b < B) a.skip[(size_t)b * S + s] = skip[s * TB + j];
  }
}

template <typename T>
static cudaError_t launch(const StackArgs& a, cudaStream_t stream, int* launches) {
  const size_t smem = sizeof(float) * TB * (3 * a.C + 3 * a.G + a.S);
  cudaError_t err = cudaFuncSetAttribute(
      stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.B + TB - 1) / TB;
  stack_kernel<T><<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

}  // namespace wn

extern "C" int wn_stack_lane_tile() { return wn::TB; }

// Returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_fused_stack(const wn::StackArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::launch<__nv_bfloat16>(*a, s, launches)
                       : wn::launch<float>(*a, s, launches));
}
