// tp_fused_stack: one sample step of a model-sharded (skip-split) stack, all
// L layers through this rank's slice of the skip sum.
//
// Replaces the Pallas kernel lb_wavenet_tpu/ops/pallas/ar_tp.py
// (`tp_fused_stack`, body `_tp_kernel`). On the TPU the grid runs in order
// over the L layers, with h, the local skip sum and the staged [h ; tap] pair
// in VMEM scratch, the ring slot of each layer scalar-prefetched and the ring
// aliased onto the output. Lanes are independent, so here one block owns a
// tile of TB lanes for all L layers (a loop inside the block takes the place
// of the sequential grid axis; no grid-wide synchronisation). Per layer, in
// mega's accumulation contract (ar_mega.cu), which the JAX TP kernel keeps:
//   * each lane's tap is read from ring row offset_l + t mod d_l (computed
//     here from t and the dilations), then the same row takes h;
//   * ONE merged tap product pre = [h ; tap] @ wcat + b, 2C deep;
//   * z = tanh(pre[:G]) * sigmoid(pre[G:]);
//   * ONE merged output product rs = z @ [w_res | w_skip_local], then
//     h = (h + rs[:C]) + b_res and skip += rs[C:] + b_skip.
// Operands are rounded to the compute dtype, products and sums in fp32; h,
// the skip slice and the pre-activations stay in shared memory. The caller
// completes the post network's hidden layer with one all-reduce over the
// model axis per step.
//
// Layout: FEATURE-major as the JAX kernel (lanes last): h0 (C, B), the ring
// (sum_d, C, B), the local skip sum out (S_l, B); the CUDA-core route's
// weights k-major, wcat (L, 2C, 2G) and wrs (L, G, C + S_l).
//
// Bound on an H100 at the stress config (configs/stress_gen.json: L = 30,
// C = G = 64, S = 512, bf16, B = 256; chip_smoke.py `tp_cost`): 2 L B (2G 2C
// + (C + S_l) G) = 0.82 GFLOP at S_l = 512 (0.57 at 256) against ~3.2 MB of
// bf16 weights and 2 L C B fp32 ring values (3.9 MB): bytes bound, ~2 us.
//
// Two routes, chosen on the host from dtype and the widths (C, G, S_l)
// before the launch (ar_tc.py `stack_route`; not a fallback):
//   * bf16 with C, G, S_l multiples of 16, C+S_l <= 768, G <= 384 and a ring
//     of at least two weight slots in shared memory: tc::stack_tc_kernel
//     (ar_tc.cuh), mega's layer loop without its finale, feature-major and
//     in mega's merged order. 8 consumer warps and a producer warp per
//     8-lane block; the step's weights (wcat^T and wrs^T per layer, packed
//     once per weight set from the feature-major views in mma fragment
//     order) stream through a ring of 32 KB shared-memory slots by
//     cp.async.bulk; products on tensor cores (mma.sync m16n8k16 bf16 ->
//     fp32, one mma from zero per 16-deep k-step added in k order, which the
//     plain version reproduces bit for bit on the card); taps prefetched by
//     cp.async during the layer before, masked past B, by 4-byte copies
//     where a lane chunk is not 16-byte aligned (B % 4 != 0): any batch,
//     down to the mesh pool's B = 4.
//   * fp32, and bf16 at other widths (an S_l split 3 ways): tp_kernel below,
//     CUDA-core fp32 FMAs on weights read from L2 in a dependent k-loop
//     (common.cuh block_mm), the first version; latency-bound.
#include "ar_tc.cuh"

namespace wn {

struct TpArgs {
  const float* h0;     // (C, B) residual input of the step
  float* bufs;         // (sum_d, C, B) ring, in place
  const int* dils;     // (L,)
  const void* wcat;    // (L, 2C, 2G) [w_cur ; w_prev], compute dtype
  const float* b;      // (L, 2G)
  const void* wrs;     // (L, G, C + S) [w_res | w_skip_local]
  const float* brs;    // (L, C + S)
  float* skip;         // (S, B) out: the local skip sum
  int B, L, C, G, S, t, bf16;
};

template <typename T>
__global__ void __launch_bounds__(NT) tp_kernel(TpArgs a) {
  extern __shared__ float sm[];
  const int C = a.C, G = a.G, S = a.S, B = a.B;
  const int CS = C + S;
  float* x = sm;                  // [C][TB] residual stream h (fp32)
  float* xr = x + C * TB;         // [2C][TB] rounded pair [h ; tap]
  float* pre = xr + 2 * C * TB;   // [2G][TB]
  float* zr = pre + 2 * G * TB;   // [G][TB] rounded gate output
  float* skip = zr + G * TB;      // [S][TB] local skip sum
  const int b0 = blockIdx.x * TB;
  const T* wcat = static_cast<const T*>(a.wcat);
  const T* wrs = static_cast<const T*>(a.wrs);

  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int c = i / TB, j = i % TB, b = b0 + j;
    x[i] = b < B ? a.h0[(size_t)c * B + b] : 0.f;
  }
  for (int i = threadIdx.x; i < S * TB; i += NT) skip[i] = 0.f;
  __syncthreads();

  int off = 0;
  for (int l = 0; l < a.L; ++l) {
    const int d = a.dils[l];
    float* ring = a.bufs + (size_t)(off + a.t % d) * C * B;
    for (int i = threadIdx.x; i < C * TB; i += NT) {
      const int c = i / TB, j = i % TB, b = b0 + j;
      const float h = x[i];
      float tap = 0.f;
      if (b < B) {
        float* p = ring + (size_t)c * B + b;
        tap = *p;
        *p = h;
      }
      xr[i] = rnd<T>(h);
      xr[C * TB + i] = rnd<T>(tap);
    }
    __syncthreads();
    block_mm(wcat + (size_t)l * 2 * C * 2 * G, 2 * G, 2 * G, 2 * C, xr,
             [&](int m, int j, float acc) { pre[m * TB + j] = acc + a.b[l * 2 * G + m]; });
    __syncthreads();
    for (int i = threadIdx.x; i < G * TB; i += NT) {
      zr[i] = rnd<T>(tanhf(pre[i]) * sigmoidf(pre[G * TB + i]));
    }
    __syncthreads();
    block_mm(wrs + (size_t)l * G * CS, CS, CS, G, zr, [&](int m, int j, float acc) {
      const float bias = a.brs[l * CS + m];
      if (m < C) {
        x[m * TB + j] = (x[m * TB + j] + acc) + bias;
      } else {
        float* s = skip + (m - C) * TB + j;
        *s = *s + (acc + bias);
      }
    });
    __syncthreads();
    off += d;
  }
  for (int i = threadIdx.x; i < S * TB; i += NT) {
    const int s = i / TB, j = i % TB, b = b0 + j;
    if (b < B) a.skip[(size_t)s * B + b] = skip[i];
  }
}

template <typename T>
static cudaError_t launch(const TpArgs& a, cudaStream_t stream, int* launches) {
  const size_t smem = sizeof(float) * TB * (3 * a.C + 3 * a.G + a.S);
  cudaError_t err = cudaFuncSetAttribute(
      tp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.B + TB - 1) / TB;
  tp_kernel<T><<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

}  // namespace wn

// Returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_tp_fused_stack(const wn::TpArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::launch<__nv_bfloat16>(*a, s, launches)
                       : wn::launch<float>(*a, s, launches));
}

// The tensor-core route (bf16): one launch of tc::stack_tc_kernel,
// feature-major and in mega's merged order. Returns a CUDA error code.
extern "C" int wn_tp_fused_stack_tc(const wn::tc::StackArgs* a, void* stream, int* launches) {
  return (int)wn::tc::stack_launch<false, true>(*a, static_cast<cudaStream_t>(stream), launches);
}

// Bytes of dynamic shared memory of the tensor-core route at these widths
// on this device (ar_tc.py `stack_smem` must agree).
extern "C" long long wn_tp_fused_stack_tc_smem(int L, int C, int G, int S) {
  int n_slots;
  return (long long)wn::tc::stack_smem(L, C, G, S, &n_slots);
}
