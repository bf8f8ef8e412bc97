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
// Bound on an H100 (WaveNet-30: L = 30, C = G = 64, S = Q = 256, K = 2;
// chip_smoke.py `mega_cost`): per 1024-step launch 2 B T (L (2C 2G + G
// (C+S)) + S S + S Q + K C C) of bf16 products against the weights and the
// carry read once: 1.320 ms at B = 512 (1.31 TFLOP at 989 TFLOP/s) and
// 0.165 ms at B = 64, operations bound at both.
//
// Three instantiations, chosen on the host from dtype and widths before the
// launch (ar_tc.py `route`; not a fallback):
//   * fp32, and bf16 at widths the tensor-core kernel does not take (any of
//     C, G, S, Q not a multiple of 16, C+S or Q above 768, G above 384):
//     mega_kernel<T>, CUDA-core FMAs in k order through common.cuh
//     (block_mm), as in the first port.
//   * bf16 at the other widths: mega_tc_kernel, the tensor-core design of
//     ar_tc.cuh, for the five holds of the CUDA-core version: (1) the
//     dependent chain of 2-byte weight loads from L2 becomes a producer
//     warp streaming the step's packed weights (ar_tc.py) through a ring of 32 KB shared-memory
//     slots by cp.async.bulk, consumers reading 16-byte fragments by
//     32-bit shared-memory address, two k-steps per turn in two register
//     sets; (2) each weight byte feeds all 8 lanes of the block
//     through one mma fragment; (3) products on tensor cores (mma.sync
//     m16n8k16 bf16 -> fp32, one mma per 16-deep k-step from zero, added
//     in k order; the plain version reproduces those sums bit for bit);
//     (4) a block still owns 8 lanes (64 blocks at B = 512, 8 at B = 64:
//     the cluster and multicast options are reckoned in PERF.md);
//     (5) three block barriers per layer (the gate runs in the pre
//     product's epilogue on tile pairs held by one warp), biases loaded
//     before a product's first wait, each layer's ring taps prefetched by
//     cp.async during the layer before. ptxas (chip_smoke.py prints the
//     report): 157 registers, no spills in the 3-tiles-per-warp
//     instantiation WaveNet-30 selects; 168 registers and 180/552 bytes of
//     spills at 6 (the stress config); 207,744 bytes of dynamic shared
//     memory at WaveNet-30. Measured: PERF.md, Findings.
//
// Conditioning (the JAX kernel's has_cond variant: mel and/or speaker,
// cond_ts (T, B, Cc') in the compute dtype, w_cond (L, Cc', 2G)): every
// layer adds cond_t @ w_cond[l] to its gate pre-activation. On the tensor
// cores the cond k-steps extend the gate product ([w_cur ; w_prev ;
// w_cond] against [h | tap | cond], one chain, then + b; ar_tc.cuh), the
// step's cond row staged into the bf16 tile at the start of each step (Cc'
// bf16 a lane, 128 B at Cc' = 64; the row of the 8 lanes is contiguous);
// on CUDA cores a separate in-order product after the bias, (wcat-sum + b)
// + cond-sum, the JAX order. Per 1024-step launch it adds 2 B T L Cc' 2G
// operations (+0.26 TFLOP at B = 512, Cc' = 64: +20%) and T B Cc' bf16
// cond bytes (64 MB at B = 512); shared memory grows by 8 Cc' bf16 (1 KB).
#include "ar_tc.cuh"

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
  const void* wpk;     // bf16: the step's weights packed for the tensor cores
  const int* prods;    // bf16: (n_prod, 2) (M, K) of each packed product
  int n_prod, grid;    // bf16: products per step; blocks (lane tiles)
  int tc;              // bf16: 1 the tensor-core kernel, 0 the CUDA-core one
  const void* cond;    // (T, B, Cc) compute dtype, or null: unconditioned
  const void* wcond;   // CUDA-core route: (L, Cc, 2G) compute dtype
  int Cc;              // conditioning channels (tensor cores: a multiple of 16)
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
  float* cr = er + C * TB;          // [Cc][TB] rounded conditioning of the step
  int* cls = reinterpret_cast<int*>(cr + a.Cc * TB);  // [TB]
  const int b0 = blockIdx.x * TB;
  const T* wcat = static_cast<const T*>(a.wcat);
  const T* wcond = static_cast<const T*>(a.wcond);
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
    if (wcond) {  // synced by layer 0's staging barrier
      stage_cond<T, false>(static_cast<const T*>(a.cond) + (size_t)t * B * a.Cc, cr, B, b0,
                           a.Cc, NT);
    }
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
      if (wcond) {  // (wcat-sum + b) + cond-sum; same M, same threads
        block_mm(wcond + (size_t)l * a.Cc * 2 * G, 2 * G, 2 * G, a.Cc, cr,
                 [&](int m, int j, float acc) { pre[m * TB + j] = pre[m * TB + j] + acc; });
      }
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
  if ((a.wcond != nullptr) != (a.cond != nullptr) || (a.cond ? a.Cc < 1 : a.Cc != 0))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * TB *
                          (4 * a.C + 3 * a.G + 3 * a.S + a.Q + a.n_d1 * a.C +
                           (a.K - 1) * a.C + a.C + (a.cond ? a.Cc : 0)) +
                      sizeof(int) * TB;
  cudaError_t err = cudaFuncSetAttribute(
      mega_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mega_kernel<T><<<a.B / TB, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

// ---- bf16: the tensor-core kernel (ar_tc.cuh) -------------------------------

static int tc_smem = 0;  // dynamic shared memory of the last launch (bytes)

struct MegaTc {  // the block's shared memory
  float *x, *skip, *lg, *d1, *es, *tap[2];
  int* dl;
  tc::bf16 *xb, *zb, *ab, *hb, *eb;
  int* cls;
  tc::Ring ring;
};

__host__ __device__ inline MegaTc mega_tc_carve(const MegaArgs& a, char* base, int n_slots,
                                               size_t* bytes) {
  tc::Carve cv{base, 0};
  MegaTc s;
  s.ring.full = cv.take<uint64_t>(tc::MAX_SLOTS);
  s.ring.empty = cv.take<uint64_t>(tc::MAX_SLOTS);
  s.ring.slots = cv.take<char>((size_t)n_slots * tc::SLOT);
  s.ring.n = n_slots;
  s.ring.i = 0;
  s.x = cv.take<float>(a.C * TB);
  s.skip = cv.take<float>(a.S * TB);
  s.lg = cv.take<float>(a.Q * TB);
  s.d1 = cv.take<float>(a.n_d1 * a.C * TB);
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
__global__ void __launch_bounds__(tc::NTH, 1) mega_tc_kernel(MegaArgs a, int n_slots) {
  extern __shared__ __align__(128) char smem[];
  const int C = a.C, G = a.G, S = a.S, Q = a.Q, K = a.K, B = a.B, Cc = a.Cc;
  const int CS = C + S, lda = 2 * C + Cc + 8, ldg = G + 8;
  size_t bytes;
  MegaTc s = mega_tc_carve(a, smem, n_slots, &bytes);
  tc::Ring ring = s.ring;  // locals: no lambda captures the struct
  tc::bf16 *xb = s.xb, *zb = s.zb, *ab = s.ab, *hb = s.hb, *eb = s.eb;
  int *cls = s.cls, *dl = s.dl;
  float *lg = s.lg, *tap0 = s.tap[0], *tap1 = s.tap[1];
  tc::ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= tc::NC) {
    if (threadIdx.x == tc::NC)
      tc::produce(ring, static_cast<const char*>(a.wpk), a.prods, a.n_prod, a.T);
    return;
  }
  float *x = s.x, *skip = s.skip, *d1 = s.d1, *es = s.es;
  const int b0 = blockIdx.x * TB;
  const Sampler sp = {a.lane, a.lane_rows, a.mode, a.seed_base, a.inv_temp, B, 1};
  // Layer l's taps (ring row off + t mod d, lanes b0..b0+7) go to tap[q & 1]
  // by cp.async while the layer before it computes (q counts layers).
  auto prefetch = [&](int l, int t_abs, int off, float* dst) {
    const int d = dl[l];
    if (d == 1) return;
    const float* src = a.bufs + (size_t)(off + t_abs % d) * C * B + b0;
    for (int i = threadIdx.x; i < 2 * C; i += tc::NC) {
      tc::cp_async16(dst + i * 4, src + (size_t)(i >> 1) * B + (i & 1) * 4);
    }
  };

  for (int l = threadIdx.x; l < a.L; l += tc::NC) dl[l] = a.dils[l];
  for (int i = threadIdx.x; i < C * TB; i += tc::NC) {
    x[i] = a.h_s[(size_t)(i / TB) * B + b0 + i % TB];
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += tc::NC) {
    es[i] = a.e_s[(size_t)(i / TB) * B + b0 + i % TB];
  }
  for (int l = 0, i1 = 0; l < a.L; ++l) {
    if (a.dils[l] != 1) continue;
    for (int i = threadIdx.x; i < C * TB; i += tc::NC) {
      d1[i1 * C * TB + i] = a.hstate[((size_t)l * 2 * C + i / TB) * B + b0 + i % TB];
    }
    ++i1;
  }
  tc::csync();
  if (a.T > 0) prefetch(0, a.t0, 0, tap0);
  tc::cp_async_wait_all();
  tc::csync();

  for (int t = 0, q = 0; t < a.T; ++t) {
    const int t_abs = a.t0 + t;
    const bool last = t == a.T - 1;
    // The step's cond row into columns 2C.. of the staged tile (the
    // frontend's scratch use of xb ended at the last barrier); synced by
    // layer 0's staging barrier.
    if (Cc) {
      const tc::bf16* ct = static_cast<const tc::bf16*>(a.cond) + ((size_t)t * B + b0) * Cc;
      for (int i = threadIdx.x; i < Cc * TB; i += tc::NC) {
        xb[(i / Cc) * lda + 2 * C + i % Cc] = ct[i];
      }
    }
    int off = 0, i1 = 0;
    for (int l = 0; l < a.L; ++l, ++q) {
      const int d = dl[l];
      const float* tp = q & 1 ? tap1 : tap0;  // no dynamic index
      // Stage bf16 [h | tap] per lane; h takes the tap's ring row.
      for (int i = threadIdx.x; i < C * TB; i += tc::NC) {
        const int c = i / TB, j = i % TB, b = b0 + j;
        const float h = x[i];
        float tap;
        if (d > 1) {
          tap = tp[i];
          a.bufs[((size_t)(off + t_abs % d) * C + c) * B + b] = h;
        } else {
          float* p = d1 + i1 * C * TB + i;
          tap = *p;
          *p = h;
        }
        xb[j * lda + c] = __float2bfloat16_rn(h);
        xb[j * lda + C + c] = __float2bfloat16_rn(tap);
        if (last) {
          a.hstate[((size_t)l * 2 * C + c) * B + b] = h;
          a.hstate[((size_t)l * 2 * C + C + c) * B + b] = tap;
        }
      }
      float* next = q & 1 ? tap0 : tap1;
      if (l + 1 < a.L) {
        prefetch(l + 1, t_abs, off + d, next);
      } else if (!last) {
        prefetch(0, t_abs + 1, 0, next);
      }
      tc::csync();
      // pre = [h ; tap (; cond)] @ wcat + b: ONE (2C + Cc)-deep sum
      // (mega's merged tap, the cond k-steps last); z = tanh(pre[m])
      // sigmoid(pre[G + m]) from the same thread's pair.
      tc::mm<TPW, true>(ring, 2 * G, 2 * C + Cc, xb, lda, a.bcat + l * 2 * G,
                   [&](int m, int j, float at, float bt, float as, float bs) {
                     zb[j * ldg + m] =
                         __float2bfloat16_rn(tanhf(at + bt) * sigmoidf(as + bs));
                   });
      tc::csync();
      // One z @ [w_res | w_skip] product: h = (h + rs) + b_res,
      // skip += rs + b_skip.
      tc::mm<TPW>(ring, CS, G, zb, ldg, a.brs + l * CS, [&](int m, int j, float acc,
                                                           float bias) {
        if (m < C) {
          x[m * TB + j] = (x[m * TB + j] + acc) + bias;
        } else {
          const float contrib = acc + bias;
          float* sk = skip + (m - C) * TB + j;
          *sk = l == 0 ? contrib : *sk + contrib;
        }
      });
      tc::cp_async_wait_all();
      tc::csync();
      off += d;
      if (d == 1) ++i1;
    }

    tc::post_logits<TPW>(ring, skip, ab, hb, lg, a.b1, a.b2, S, Q,
                    [&](int m, int j, float v) {
                      if (a.logits) a.logits[((size_t)t * Q + m) * B + b0 + j] = v;
                    });
    tc::sample(lg, sp, B, b0, Q, t_abs, a.forced + (size_t)t * B, cls,
               a.classes + (size_t)t * B);
    tc::next_frontend<TPW>(ring, x, es, eb, xb, cls, static_cast<const tc::bf16*>(a.emb),
                      a.b_in, C, K);
  }

  for (int i = threadIdx.x; i < C * TB; i += tc::NC) {
    a.h_s[(size_t)(i / TB) * B + b0 + i % TB] = x[i];
  }
  for (int i = threadIdx.x; i < (K - 1) * C * TB; i += tc::NC) {
    a.e_s[(size_t)(i / TB) * B + b0 + i % TB] = es[i];
  }
}

template <int TPW>
static cudaError_t launch_nt(const MegaArgs& a, int n_slots, size_t smem, cudaStream_t stream,
                             int* launches) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_tc_kernel<TPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mega_tc_kernel<TPW><<<a.grid, tc::NTH, smem, stream>>>(a, n_slots);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

static cudaError_t launch_tc(const MegaArgs& a, cudaStream_t stream, int* launches) {
  if (a.grid * TB != a.B || !a.wpk || !a.prods || a.Cc < 0 || a.Cc % 16 ||
      (a.Cc > 0) != (a.cond != nullptr))
    return cudaErrorInvalidValue;
  size_t fixed;
  mega_tc_carve(a, nullptr, 0, &fixed);
  const int n_slots = tc::ring_slots(fixed);
  if (n_slots < 2) return cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)n_slots * tc::SLOT;
  tc_smem = (int)smem;
  switch (tc::step_tpw(a.C, a.G, a.S, a.Q)) {
    case 3: return launch_nt<3>(a, n_slots, smem, stream, launches);
    case tc::MAX_MT: return launch_nt<tc::MAX_MT>(a, n_slots, smem, stream, launches);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wn

extern "C" int wn_mega_lane_tile() { return wn::TB; }

// Returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_mega_generate(const wn::MegaArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a->bf16) return (int)wn::launch<float>(*a, s, launches);
  return (int)(a->tc ? wn::launch_tc(*a, s, launches)
                     : wn::launch<__nv_bfloat16>(*a, s, launches));
}

// Dynamic shared memory (bytes) of the last bf16 launch: activations plus
// the weight ring.
extern "C" int wn_mega_tc_smem() { return wn::tc_smem; }
