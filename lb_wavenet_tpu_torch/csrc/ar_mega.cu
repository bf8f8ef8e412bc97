// mega_generate: the whole T-step sampling loop in one launch.
//
// Replaces the Pallas kernel lb_wavenet_tpu/ops/pallas/ar_mega.py
// (`mega_generate`, body `_make_mega_kernel`). On the TPU the grid runs
// sequentially over the T steps with all weights resident in VMEM and the
// ring taps moved by manual DMA. Lanes are independent, so here one block
// owns a tile of TB lanes for ALL T steps of the chunk, with no grid-wide
// synchronisation. Per step the block runs the L layers with the merged
// contractions of the TPU kernel ([h | tap] 2C -> 2G against wcat, then one
// G -> C+S product against [w_res | w_skip], mega's bias order), the post
// network, Gumbel-max sampling (per-lane counter hash, a counter hash over
// the whole batch for global_rng, or greedy), the forced-class override, the
// next step's embedding (rounded to the compute dtype, as the one-hot matmul
// does) and the K-tap input conv with its embedding stack. Layers with
// dilation 1 take their tap from the staged previous h, never the ring.
//
// The streaming carry (bufs, hstate, h_s, e_s) is read at the start and
// written back at the end IN PLACE, in the JAX layout (feature-major, lanes
// last), so reset_lanes and chunk-to-chunk resume work unchanged.
//
// Bound on an H100 at the serving shapes (WaveNet-30, B = 512, T = 1024):
// 2 B T (L (2C 2G + G (C+S)) + S S + S Q + K C C) ~ 1.3 TFLOP of bf16
// products (1.3 ms at 989 TFLOP/s) against ~0.8 GB of carry (0.25 ms at
// 3.35 TB/s): operations bound. This first version multiplies on CUDA cores
// in fp32 (no tensor cores yet) and reads each layer's ~72 KB of bf16 weights
// from L2 once per block and step; intermediates never leave the SM.
#include "common.cuh"

namespace wn {

struct MegaArgs {
  float* bufs;         // (sum_d*C, B) ring, in place
  float* hstate;       // (L*2C, B) staged [h | tap] pairs, in place
  float* h_s;          // (C, B) next step's residual input, in place
  float* e_s;          // ((K-1)*C, B) embedding stack, in place
  const int* dils;     // (L,)
  const void* wcat;    // (L, 2C, 2G)  [w_cur ; w_prev], compute dtype
  const float* bcat;   // (L, 2G)
  const void* wrs;     // (L, G, C+S)  [w_res | w_skip]
  const float* brs;    // (L, C+S)
  const void* w1;      // (S, S)
  const float* b1;     // (S,)
  const void* w2;      // (S, Q)
  const float* b2;     // (Q,)
  const void* emb;     // (Q, C)
  const void* w_in;    // (K, C, C)
  const float* b_in;   // (C,)
  const int* forced;   // (T, B), -1 = free-running
  const int* lane;     // (lane_rows, B): seeds; lease times; [1/tau bits]
  int* classes;        // (T, B) out
  float* logits;       // (T, Q, B) out, or null
  int B, T, t0, L, C, G, S, Q, K;
  int lane_rows, seed_base, mode;  // mode: 0 greedy, 1 per-lane, 2 global
  float inv_temp;
  int bf16, n_d1;
};

template <typename T>
__global__ void __launch_bounds__(NT) mega_kernel(MegaArgs a) {
  extern __shared__ float sm[];
  const int C = a.C, G = a.G, S = a.S, Q = a.Q, K = a.K, B = a.B;
  const int CS = C + S;
  float* x = sm;                    // [2C][TB] pair [h ; tap] (fp32)
  float* xr = x + 2 * C * TB;       // [2C][TB] rounded pair
  float* pre = xr + 2 * C * TB;     // [2G][TB]
  float* zr = pre + 2 * G * TB;     // [G][TB]
  float* skip = zr + G * TB;        // [S][TB]
  float* ar = skip + S * TB;        // [S][TB] rounded relu(skip)
  float* hid = ar + S * TB;         // [S][TB] rounded hidden
  float* lg = hid + S * TB;         // [Q][TB] logits
  float* d1 = lg + Q * TB;          // [n_d1][C][TB] previous h of d == 1 layers
  float* es = d1 + a.n_d1 * C * TB; // [(K-1)C][TB] embedding stack (fp32)
  float* er = es + (K - 1) * C * TB;  // [C][TB] rounded embedding operand
  int* cls = reinterpret_cast<int*>(er + C * TB);  // [TB]
  const int b0 = blockIdx.x * TB;
  const T* wcat = static_cast<const T*>(a.wcat);
  const T* wrs = static_cast<const T*>(a.wrs);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  const T* emb = static_cast<const T*>(a.emb);
  const T* w_in = static_cast<const T*>(a.w_in);
  // The global counter hash runs over (q, b) feature-major: q * B + b.
  const Sampler sp = {a.lane, a.lane_rows, a.mode, a.seed_base, a.inv_temp, B, 1};

  // Load the carry of this tile.
  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int c = i / TB, j = i % TB;
    x[i] = a.h_s[(size_t)c * B + b0 + j];
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += NT) {
    const int r = i / TB, j = i % TB;
    es[i] = a.e_s[(size_t)r * B + b0 + j];
  }
  {
    int i1 = 0;
    for (int l = 0; l < a.L; ++l) {
      if (a.dils[l] != 1) continue;
      for (int i = threadIdx.x; i < C * TB; i += NT) {
        const int c = i / TB, j = i % TB;
        d1[i1 * C * TB + i] = a.hstate[((size_t)l * 2 * C + c) * B + b0 + j];
      }
      ++i1;
    }
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const int t_abs = a.t0 + t;
    const bool last = t == a.T - 1;
    int off = 0, i1 = 0;
    for (int l = 0; l < a.L; ++l) {
      const int d = a.dils[l];
      // Stage [h | tap]: the tap is read before its ring row takes h.
      for (int i = threadIdx.x; i < C * TB; i += NT) {
        const int c = i / TB, j = i % TB, b = b0 + j;
        const float h = x[i];
        float tap;
        if (d > 1) {
          float* p = a.bufs + ((size_t)(off + t_abs % d) * C + c) * B + b;
          tap = *p;
          *p = h;
        } else {
          float* p = d1 + i1 * C * TB + i;
          tap = *p;
          *p = h;
        }
        x[C * TB + i] = tap;
        xr[i] = rnd<T>(h);
        xr[C * TB + i] = rnd<T>(tap);
        if (last) {
          a.hstate[((size_t)l * 2 * C + c) * B + b] = h;
          a.hstate[((size_t)l * 2 * C + C + c) * B + b] = tap;
        }
      }
      __syncthreads();
      // pre = [h ; tap] @ wcat + b: ONE 2C-deep sum (mega's merged tap).
      block_mm(wcat + (size_t)l * 2 * C * 2 * G, 2 * G, 2 * G, 2 * C, xr,
               [&](int m, int j, float acc) {
                 pre[m * TB + j] = acc + a.bcat[l * 2 * G + m];
               });
      __syncthreads();
      for (int i = threadIdx.x; i < G * TB; i += NT) {
        zr[i] = rnd<T>(tanhf(pre[i]) * sigmoidf(pre[G * TB + i]));
      }
      __syncthreads();
      // One z @ [w_res | w_skip] product: h = (h + rs) + b_res,
      // skip += rs + b_skip.
      block_mm(wrs + (size_t)l * G * CS, CS, CS, G, zr, [&](int m, int j, float acc) {
        const float bias = a.brs[l * CS + m];
        if (m < C) {
          x[m * TB + j] = (x[m * TB + j] + acc) + bias;
        } else {
          const float contrib = acc + bias;
          float* s = skip + (m - C) * TB + j;
          *s = l == 0 ? contrib : *s + contrib;
        }
      });
      __syncthreads();
      off += d;
      if (d == 1) ++i1;
    }

    // Post network, sampling, then the next step's frontend (common.cuh).
    post_logits(skip, ar, hid, lg, w1, a.b1, w2, a.b2, S, Q, [&](int m, int j, float v) {
      if (a.logits) a.logits[((size_t)t * Q + m) * B + b0 + j] = v;
    });
    sample_tile(lg, sp, B, b0, Q, t_abs, a.forced + (size_t)t * B, cls,
                a.classes + (size_t)t * B);
    next_frontend(x, xr, es, er, cls, emb, w_in, a.b_in, C, K);
  }

  // Export the carry: next step's h and the embedding stack.
  for (int i = threadIdx.x; i < C * TB; i += NT) {
    const int c = i / TB, j = i % TB;
    a.h_s[(size_t)c * B + b0 + j] = x[i];
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += NT) {
    const int r = i / TB, j = i % TB;
    a.e_s[(size_t)r * B + b0 + j] = es[i];
  }
}

template <typename T>
static cudaError_t launch(const MegaArgs& a, cudaStream_t stream, int* launches) {
  const size_t smem = sizeof(float) * TB *
                          (4 * a.C + 3 * a.G + 3 * a.S + a.Q + a.n_d1 * a.C +
                           (a.K - 1) * a.C + a.C) +
                      sizeof(int) * TB;
  cudaError_t err = cudaFuncSetAttribute(
      mega_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mega_kernel<T><<<a.B / TB, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

}  // namespace wn

extern "C" int wn_mega_lane_tile() { return wn::TB; }

// Returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_mega_generate(const wn::MegaArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::launch<__nv_bfloat16>(*a, s, launches)
                       : wn::launch<float>(*a, s, launches));
}
