// turbo_step: one whole autoregressive sample step per launch.
//
// Replaces the Pallas kernel lb_wavenet_tpu/ops/pallas/ar_turbo.py
// (`turbo_step`, body `_turbo_kernel`). The TPU version walks a sequential grid
// over the L layers with h and the skip sum in VMEM scratch and runs the
// finale in the last grid step: the post network, Gumbel-max sampling, the
// forced-class override, the next class's embedding and the next step's K-tap
// input conv. Here one block owns a tile of TB lanes and runs all L layers,
// then the finale, so no grid-wide synchronisation is needed:
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
// Bound on an H100 (WaveNet-30; chip_smoke.py `turbo_cost`): per step the
// bf16 weights (2.5 MB), h, the embedding stack and the L ring rows read and
// written once: 3.28 us at B = 512 and 1.08 us at B = 64 (bytes bound;
// the 1.3 GFLOP of products take 1.3 us at B = 512).
//
// Three instantiations, chosen on the host from dtype and widths before the
// launch (ar_tc.py `route`; not a fallback): fp32, and bf16 at widths the
// tensor-core kernel does not take, keep the CUDA-core path of common.cuh
// (split_layer, post_logits, sample_tile, next_frontend); bf16 at the other
// widths runs turbo_tc_kernel, the tensor-core design of
// ar_tc.cuh shared with ar_mega.cu (see its note): weights streamed through
// a shared-memory ring by a producer warp, mma.sync m16n8k16 products per
// 16-deep k-step, the same packed step stream as mega's: [h | tap] @
// [w_cur ; w_prev] with its two halves summed apart (turbo's split order,
// (h @ w_cur + tap @ w_prev) + b) on paired tiles so that one thread holds
// both halves of a gate, then one z @ [w_res | w_skip] product; taps
// prefetched by cp.async, any batch (the last block masks lanes past B).
// One launch per sample step, with programmatic dependent launch. ptxas
// (chip_smoke.py prints the report): 128 registers, no spills at 3 tiles
// per warp (WaveNet-30); 168 registers, 12/20 bytes of spills at 6; 201,600
// bytes of dynamic shared memory at WaveNet-30.
//
// Conditioning (the JAX kernel's has_cond variant: mel and/or speaker folded
// into one cond row of Cc' channels, cond (T, B, Cc') in the compute dtype,
// w_cond (L, Cc', 2G)): every layer adds cond_t @ w_cond[l] to its gate
// pre-activation. On the tensor cores w_cond's k-steps follow w_prev's in
// the gate product of the packed stream, summed in the tap half of the split,
// pre = (h @ w_cur + [tap | cond] @ [w_prev ; w_cond]) + b; the step's cond
// row is staged once per launch into columns 2C.. of the bf16 tile (lda = 2C
// + Cc' + 8; +TB Cc' bf16 of shared memory, 1 KB at Cc' = 64). On CUDA cores
// a third in-order product after the bias, ((h-sum + tap-sum) + b) +
// cond-sum, the JAX kernel's order, from a [Cc'][TB] fp32 tile (+TB Cc' 4
// bytes). Per step and lane it adds 2 L Cc' 2G operations (+31 MFLOP a step
// at B = 64, Cc' = 64: +20% of the step's products), L Cc' 2G bf16
// weight bytes to the stream (+0.49 MB, +20%) and Cc' cond bytes a lane.
#include "ar_tc.cuh"

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
  const void* wpk;      // bf16: the step's weights packed for the tensor cores
  const int* prods;     // bf16: (n_prod, 2) (M, K) of each packed product
  int n_prod, grid;     // bf16: products per step; blocks (lane tiles)
  const float* brs;     // bf16: (L, C+S) [b_res | b_skip]
  int tc;               // bf16: 1 the tensor-core kernel, 0 the CUDA-core one
  const void* cond;     // (T, B, Cc) compute dtype, or null: unconditioned
  const void* w_cond;   // CUDA-core route: (L, Cc, 2G) compute dtype
  int Cc;               // conditioning channels (tensor cores: a multiple of 16)
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
  float* cr = er + C * TB;            // [Cc][TB] rounded conditioning of the step
  int* cls = reinterpret_cast<int*>(cr + a.Cc * TB);  // [TB]
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
  if (a.w_cond) {
    stage_cond<T, false>(static_cast<const T*>(a.cond) + (size_t)step * B * a.Cc, cr, B, b0,
                         a.Cc, NT);
  }
  __syncthreads();

  int off = 0;
  for (int l = 0; l < a.L; ++l) {
    const int d = a.dils[l];
    const LayerW<T> w = layer_w<T>(a.w_cur, a.w_prev, a.b, a.w_res, a.b_res, a.w_skip,
                                   a.b_skip, a.w_cond, l, C, G, S, a.Cc);
    split_layer(w, a.bufs + (size_t)(off + t % d) * B * C, B, b0, C, G, S, x, xr, tr, pre,
                zr, skip, cr);
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
  if ((a.w_cond != nullptr) != (a.cond != nullptr) || (a.cond ? a.Cc < 1 : a.Cc != 0))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * TB *
                          (4 * a.C + 3 * a.G + 3 * a.S + a.Q + (a.K - 1) * a.C +
                           (a.cond ? a.Cc : 0)) +
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

// ---- bf16: the tensor-core kernel (ar_tc.cuh) -------------------------------

static int tc_smem = 0;  // dynamic shared memory of the last launch (bytes)

struct TurboTc {  // the block's shared memory
  float *x, *skip, *lg, *es, *tap[2];
  int* dl;
  tc::bf16 *xb, *zb, *ab, *hb, *eb;
  int* cls;
  tc::Ring ring;
};

__host__ __device__ inline TurboTc turbo_tc_carve(const TurboArgs& a, char* base, int n_slots,
                                                 size_t* bytes) {
  tc::Carve cv{base, 0};
  TurboTc s;
  s.ring.full = cv.take<uint64_t>(tc::MAX_SLOTS);
  s.ring.empty = cv.take<uint64_t>(tc::MAX_SLOTS);
  s.ring.slots = cv.take<char>((size_t)n_slots * tc::SLOT);
  s.ring.n = n_slots;
  s.ring.i = 0;
  s.x = cv.take<float>(a.C * TB);
  s.skip = cv.take<float>(a.S * TB);
  s.lg = cv.take<float>(a.Q * TB);
  s.es = cv.take<float>((a.K - 1) * a.C * TB);
  s.tap[0] = cv.take<float>(a.C * TB);
  s.tap[1] = cv.take<float>(a.C * TB);
  s.dl = cv.take<int>(a.L);
  s.xb = cv.take<tc::bf16>(TB * (2 * a.C + a.Cc + 8));
  s.zb = cv.take<tc::bf16>(TB * (a.G + 8));
  s.ab = cv.take<tc::bf16>(TB * (a.S + 8));
  s.hb = cv.take<tc::bf16>(TB * (a.S + 8));
  s.eb = cv.take<tc::bf16>(TB * (a.C + 8));
  s.cls = cv.take<int>(TB);
  *bytes = cv.off;
  return s;
}

template <int TPW>
__global__ void __launch_bounds__(tc::NTH, 1) turbo_tc_kernel(TurboArgs a, int t, int step,
                                                              int n_slots) {
  extern __shared__ __align__(128) char smem[];
  const int C = a.C, G = a.G, S = a.S, Q = a.Q, K = a.K, B = a.B, Cc = a.Cc;
  const int CS = C + S, lda = 2 * C + Cc + 8, ldg = G + 8;
  size_t bytes;
  TurboTc s = turbo_tc_carve(a, smem, n_slots, &bytes);
  tc::Ring ring = s.ring;  // locals: no lambda captures the struct
  tc::bf16 *xb = s.xb, *zb = s.zb, *ab = s.ab, *hb = s.hb, *eb = s.eb;
  int *cls = s.cls, *dl = s.dl;
  float *lg = s.lg, *tap0 = s.tap[0], *tap1 = s.tap[1];
  tc::ring_init(ring);
  __syncthreads();
  // The next step's launch may start its prologue (barriers, weight
  // stream) on free SMs while this one runs; the producer streams weights
  // at once, the consumers wait for the previous step's state.
  tc::pdl_launch_dependents();
  if (threadIdx.x >= tc::NC) {
    if (threadIdx.x == tc::NC)
      tc::produce(ring, static_cast<const char*>(a.wpk), a.prods, a.n_prod, 1);
    return;
  }
  tc::pdl_wait();
  float *x = s.x, *skip = s.skip, *es = s.es;
  const int b0 = blockIdx.x * TB;
  // Layer l's taps (ring row off + t mod d, lane-major [TB][C]; 0 past B)
  // go to tap[l & 1] by cp.async while the layer before it computes.
  auto prefetch = [&](int l, int off, float* dst) {
    const float* src = a.bufs + (size_t)(off + t % dl[l]) * B * C;
    for (int i = threadIdx.x; i < TB * C / 4; i += tc::NC) {
      const int j = i / (C / 4), b = b0 + j;
      if (b < B) {
        tc::cp_async16(dst + i * 4, src + (size_t)b * C + (i % (C / 4)) * 4);
      } else {
        *reinterpret_cast<float4*>(dst + i * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  for (int l = threadIdx.x; l < a.L; l += tc::NC) dl[l] = a.dils[l];
  for (int i = threadIdx.x; i < C * TB; i += tc::NC) {
    const int j = i / C, c = i % C, b = b0 + j;
    x[c * TB + j] = b < B ? a.h[(size_t)b * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += tc::NC) {
    const int p = i / (C * TB), j = (i / C) % TB, c = i % C, b = b0 + j;
    es[(p * C + c) * TB + j] = b < B ? a.e[((size_t)p * B + b) * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < S * TB; i += tc::NC) skip[i] = 0.f;
  // The step's cond row into columns 2C.. of the staged tile (0 past B).
  const tc::bf16* ct = static_cast<const tc::bf16*>(a.cond) + (size_t)step * B * Cc;
  for (int i = threadIdx.x; i < Cc * TB; i += tc::NC) {
    const int j = i / Cc, b = b0 + j;
    xb[j * lda + 2 * C + i % Cc] = b < B ? ct[(size_t)b0 * Cc + i] : __float2bfloat16_rn(0.f);
  }
  tc::csync();
  prefetch(0, 0, tap0);
  tc::cp_async_wait_all();
  tc::csync();

  int off = 0;
  for (int l = 0; l < a.L; ++l) {
    const int d = dl[l];
    float* row = a.bufs + (size_t)(off + t % d) * B * C;  // this layer's ring row
    const float* tp = l & 1 ? tap1 : tap0;  // no dynamic index
    // Stage bf16 [h | tap] per lane; h takes the tap's ring row.
    for (int i = threadIdx.x; i < C * TB; i += tc::NC) {
      const int j = i / C, c = i % C, b = b0 + j;
      const float h = x[c * TB + j];
      if (b < B) row[(size_t)b * C + c] = h;
      xb[j * lda + c] = __float2bfloat16_rn(h);
      xb[j * lda + C + c] = __float2bfloat16_rn(tp[i]);
    }
    if (l + 1 < a.L) prefetch(l + 1, off + d, l & 1 ? tap0 : tap1);
    tc::csync();
    // pre = (h @ w_cur + [tap | cond] @ [w_prev ; w_cond]) + b, turbo's
    // split order: h's k-steps and the rest summed apart (SPLIT), then
    // z = tanh(pre[m]) sigmoid(pre[G + m]) from the same thread's pair.
    tc::mm<TPW, true, true>(
        ring, 2 * G, 2 * C + Cc, xb, lda, a.b + l * 2 * G,
        [&](int m, int j, float at, float bt, float as, float bs) {
          zb[j * ldg + m] = __float2bfloat16_rn(tanhf(at + bt) * sigmoidf(as + bs));
        },
        C / 16);
    tc::csync();
    // One z @ [w_res | w_skip] product: h = (h + res) + b_res,
    // skip = (skip + sk) + b_skip.
    tc::mm<TPW>(ring, CS, G, zb, ldg, a.brs + l * CS, [&](int m, int j, float acc, float b) {
      float* o = m < C ? x + m * TB + j : skip + (m - C) * TB + j;
      *o = (*o + acc) + b;
    });
    tc::cp_async_wait_all();
    tc::csync();
    off += d;
  }

  float* logits = a.logits ? a.logits + (size_t)step * B * Q : nullptr;
  tc::post_logits<TPW>(ring, skip, ab, hb, lg, a.b1, a.b2, S, Q, [&](int m, int j, float v) {
    if (logits && b0 + j < B) logits[(size_t)(b0 + j) * Q + m] = v;
  });
  // The global counter hash runs over (b, q) batch-major: b * Q + q.
  const Sampler sp = {a.lane, a.lane_rows, a.mode, a.seed_base, a.inv_temp, 1, Q};
  tc::sample(lg, sp, B, b0, Q, t, a.forced + (size_t)step * B, cls,
             a.classes + (size_t)step * B);
  tc::next_frontend<TPW>(ring, x, es, eb, xb, cls, static_cast<const tc::bf16*>(a.emb),
                    a.b_in, C, K);

  for (int i = threadIdx.x; i < C * TB; i += tc::NC) {
    const int j = i / C, c = i % C, b = b0 + j;
    if (b < B) a.h[(size_t)b * C + c] = x[c * TB + j];
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += tc::NC) {
    const int p = i / (C * TB), j = (i / C) % TB, c = i % C, b = b0 + j;
    if (b < B) a.e[((size_t)p * B + b) * C + c] = es[(p * C + c) * TB + j];
  }
}

template <int TPW>
static cudaError_t steps_nt(const TurboArgs& a, int t0, int n, int n_slots, size_t smem,
                            cudaStream_t stream, int* launches) {
  cudaError_t err = cudaFuncSetAttribute(
      turbo_tc_kernel<TPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid);
  cfg.blockDim = dim3(tc::NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int i = 0; i < n; ++i) {
    err = cudaLaunchKernelEx(&cfg, turbo_tc_kernel<TPW>, a, t0 + i, i, n_slots);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

static cudaError_t steps_tc(const TurboArgs& a, int t0, int n, cudaStream_t stream,
                            int* launches) {
  if (a.grid * TB < a.B || (a.grid - 1) * TB >= a.B || !a.wpk || !a.prods || !a.brs ||
      a.Cc < 0 || a.Cc % 16 || (a.Cc > 0) != (a.cond != nullptr))
    return cudaErrorInvalidValue;
  size_t fixed;
  turbo_tc_carve(a, nullptr, 0, &fixed);
  const int n_slots = tc::ring_slots(fixed);
  if (n_slots < 2) return cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)n_slots * tc::SLOT;
  tc_smem = (int)smem;
  switch (tc::step_tpw(a.C, a.G, a.S, a.Q)) {
    case 3: return steps_nt<3>(a, t0, n, n_slots, smem, stream, launches);
    case tc::MAX_MT: return steps_nt<tc::MAX_MT>(a, t0, n, n_slots, smem, stream, launches);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wn

// Steps t0 .. t0 + n - 1, one launch each. Returns a CUDA error code and adds
// the kernels it launched to *launches.
extern "C" int wn_turbo_steps(const wn::TurboArgs* a, int t0, int n, void* stream,
                              int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a->bf16) return (int)wn::steps<float>(*a, t0, n, s, launches);
  return (int)(a->tc ? wn::steps_tc(*a, t0, n, s, launches)
                     : wn::steps<__nv_bfloat16>(*a, t0, n, s, launches));
}

// Dynamic shared memory (bytes) of the last bf16 launch: activations plus
// the weight ring.
extern "C" int wn_turbo_tc_smem() { return wn::tc_smem; }
