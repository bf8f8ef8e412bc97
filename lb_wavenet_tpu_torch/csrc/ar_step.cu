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
// Bound on an H100 at the serving shapes (WaveNet-30, B = 512; chip_smoke.py
// `stack_cost`): the step reads ~2.4 MB of bf16 weights and moves 2 L B C
// fp32 ring values (~7.9 MB), against 2 B L (2C 2G + G C + G S) = 1.1 GFLOP:
// ~3.2 us, bytes bound.
//
// Two routes, chosen on the host from dtype and widths before the launch
// (ar_tc.py `stack_route`, from the S of the skip slice it is given; not a
// fallback):
//   * bf16 with C, G, S multiples of 16, C+S <= 768, G <= 384 and a ring of
//     at least two weight slots in shared memory: tc::stack_tc_kernel
//     (ar_tc.cuh), turbo's layer loop without its finale. 8 consumer warps
//     and a producer warp per 8-lane block; the step's weights ([w_cur ;
//     w_prev] and [w_res | w_skip] per layer, packed once per weight set in
//     mma fragment order) stream through a ring of 32 KB shared-memory
//     slots by cp.async.bulk, so each weight byte is read once per block
//     and feeds 8 lanes; products on tensor cores (mma.sync m16n8k16 bf16
//     -> fp32, one mma from zero per 16-deep k-step added in k order, the
//     two halves of the tap product summed apart: turbo's split order,
//     which the plain version reproduces bit for bit on the card); taps
//     prefetched by cp.async during the layer before; any batch. The first
//     version's hold, a dependent chain of fp32 FMAs on 2-byte weights read
//     from L2, is gone; what is left is latency: three block barriers and
//     the shared-memory round trips of each of the L layers.
//   * fp32, and bf16 at other widths: stack_kernel below, CUDA-core FMAs in
//     k order through common.cuh (split_layer), the first version.
// The step keeps every intermediate on chip.
#include "ar_tc.cuh"

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

  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int j = i / C, c = i % C, b = b0 + j;
    x[c * TB + j] = b < B ? a.h0[(size_t)b * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < S * TB; i += NT) skip[i] = 0.f;
  __syncthreads();

  int off = 0;
  for (int l = 0; l < a.L; ++l) {
    const int d = a.dils[l];
    const LayerW<T> w = layer_w<T>(a.w_cur, a.w_prev, a.b, a.w_res, a.b_res, a.w_skip,
                                   a.b_skip, l, C, G, S);
    split_layer(w, a.bufs + (size_t)(off + a.t % d) * B * C, B, b0, C, G, S, x, xr, tr, pre,
                zr, skip);
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

// The tensor-core route (bf16): one launch of tc::stack_tc_kernel,
// lane-major and in turbo's split order. Returns a CUDA error code.
extern "C" int wn_fused_stack_tc(const wn::tc::StackArgs* a, void* stream, int* launches) {
  return (int)wn::tc::stack_launch<true, false>(*a, static_cast<cudaStream_t>(stream), launches);
}

// Bytes of dynamic shared memory of the tensor-core route at these widths
// on this device (ar_tc.py `stack_smem` must agree).
extern "C" long long wn_fused_stack_tc_smem(int L, int C, int G, int S) {
  int n_slots;
  return (long long)wn::tc::stack_smem(L, C, G, S, &n_slots);
}
