// Post network + masked cross-entropy, forward and backward, over the scored
// window of the training step.
//
// Replaces the Pallas kernels of lb_wavenet_tpu/ops/pallas/post_loss.py
// (`_fwd_kernel`, `_bwd_kernel`, both under `fused_post_loss`). The TPU
// version walks a sequential (B, time tiles) grid, skips the tiles of the
// unscored receptive-field head statically and carries the numerator and
// the post-weight gradients in VMEM scratch across the grid. Here blocks own
// tiles of rows of the window [head, T) of one batch row (head rows are
// never visited: they add 0 to the numerator and get dskip = 0) and keep
// relu(skip), the hidden layer, the logits and the softmax of their rows on
// chip; only the scalar, dskip and the gradients' operands leave it.
//
// Bound on an H100 at WaveNet-30, B = 8, W = 10240, S = Q = 256 (chip_smoke.py
// `post_loss_cost`): the forward is 2 B W S (S + Q) = 21.5 GFLOP, the
// backward 3x that (0.065 ms at the bf16 tensor-core peak); skip in (84 MB)
// and dskip out set the forward's byte bound (0.025 ms).
//
// Two routes, chosen on the host before the launch from dtype and widths
// (ops/cuda/post_loss.py `route`; not a fallback):
//   * fp32 (tensor cores would be TF32, another function), and bf16 at
//     widths the tensor-core tiles do not take: the first-version kernels
//     of namespace wn below. A block owns PT = 16 rows; products on CUDA
//     cores in 4x4 register tiles, w1 and w2 read through L1/L2 per k step.
//     Forward: `post_fwd_rows` writes one partial numerator per block,
//     `post_sum` adds them in order (2 launches). Backward: `post_bwd_rows`
//     recomputes the rows, forms dlogits = (softmax - onehot) * mask * gbar,
//     writes dskip and the fp32 h1, dlogits and du; `wgrad_kernel` and
//     `reduce_partials` (tile.cuh) reduce dw1, db1, dw2, db2 in a fixed
//     order (3 launches); the caller zero-fills dskip's head rows.
//   * bf16 with S and Q multiples of 16, Q <= 256, whose tiles fit in a
//     block's shared memory (WaveNet-30 and the 512-skip stress config):
//     namespace `ptc`, for what held the first version back (CUDA-core
//     FMAs at ~26 and ~18 TFLOP/s, 16-row blocks reading the 256 KB of
//     weights from L2 at every k step, fp32 scratch, a weight-gradient pass
//     of scalar loads at ~10 TFLOP/s, per-call transposed weight copies and
//     a full-T memset of dskip):
//     - persistent blocks (one per SM) of 16 consumer warps walk tiles of
//       TP = 64 window rows; relu(skip) is loaded as fp32 with 16-byte
//       loads and rounded to bf16 on its way into shared memory; 16 warps,
//       not 8, because the products are latency-bound (PERF.md, Findings);
//     - every row product is mma.sync m16n8k16 bf16 -> fp32, one mma from
//       zero per 16-deep k-step added in fp32 in k-step order, the order
//       train_stack.py `tc_mm` reproduces (the plain versions sum so on
//       this route on the card); a warp owns all 64 rows of one 16-column
//       tile of a 256-column block, so the logits of a tile stay in
//       registers (Q <= 256);
//     - the weights do not fit in shared memory (w1 + w2 are 256 KB at
//       WaveNet-30): packed once per weight set in mma-fragment order
//       (ar_tc.py `pack_mma`, 256-column blocks; w2^T and w1^T packed too
//       for the backward, so no transposed copy per call), they stream
//       through a ring of NSLOT shared-memory slots fed by a producer warp
//       with cp.async.bulk on mbarriers, as csrc/ar_tc.cuh feeds the
//       sampling kernels; a consumer reads its B fragments with one
//       16-byte load per 16 x 16 tile;
//     - forward (`fwd_tc`, then `post_sum`: 2 launches): u = A w1 + b1, h1
//       = relu(u) in bf16 in shared memory, v = h1 w2 + b2 in registers,
//       the row's logsumexp across the warps, CE * mask, one partial per
//       tile added in row order;
//     - backward (`bwd_rows_tc`, `wgrad_tc`, `reduce_tc`: 3 launches):
//       the row pass recomputes u, h1 and v, forms g = (p - onehot) * mask *
//       gbar, dh1 = gr w2^T, du = (u > 0) dh1, da = dur w1^T and dskip =
//       (skip > 0) da, writes the head rows' zeros itself, adds the column
//       sums of the unrounded g and du (db2, db1) per block in a fixed
//       order, and writes the products' operands rnd(A), rnd(h1), gr, dur
//       as bf16 (half the first version's fp32 scratch); `wgrad_tc` sums
//       dw1 = rnd(A)^T dur and dw2 = rnd(h1)^T gr over fixed position
//       chunks on tensor cores (128 x 128 output tiles, cp.async stages,
//       the sum inside the mma: the plain version's weight gradients are
//       one fp32 sum whose order moves them by rounding only); `reduce_tc`
//       adds the chunks' and the blocks' partials in order. No float
//       atomics: a rerun is bit-identical.
#include "ar_tc.cuh"
#include "tc_tile.cuh"
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

// ---- the tensor-core route (bf16) ---------------------------------------------

namespace ptc {

using namespace tct;
constexpr int TP = 64;        // window rows per tile
constexpr int RG = TP / 16;   // 16-row groups of a tile
constexpr int PAD = 8;        // bf16 elements of row padding
constexpr int NB = 256;       // columns per product block
constexpr int NSLOT = 4;      // weight ring slots
constexpr int PSLOT = 16384;  // bytes per slot
constexpr int NCW = 16;       // consumer warps
constexpr int NC = NCW * 32;  // consumer threads
constexpr int NTH = NC + 32;  // plus the producer warp
constexpr int NTW = NB / 16 / NCW;         // 16-column tiles of a block per warp
constexpr int UW = NTW * RG * 2 * 4 / 32;  // words of u > 0 flags per thread and block
constexpr int FRAG = tc::FRAG;
static_assert(PSLOT >= (NB / 16) * FRAG, "a slot holds one k-step of a column block");
static_assert(NTW >= 1 && UW >= 1, "a warp owns whole 16-column tiles");

// Named barrier of the consumer warps (the producer warp never joins it).
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory"); }

// Shared memory of the row kernels, carved alike on the host (base null:
// sizes only) and the device; post_loss.py `tc_smem` reckons the same bytes.
struct Lay {
  char* slots;      // [NSLOT][PSLOT] the weight ring
  uint64_t* full;   // [NSLOT]
  uint64_t* empty;  // [NSLOT]
  bf16* X;          // [TP][S + PAD] rounded relu(skip); backward: then dur
  bf16* Y;          // [TP][max(S, Q) + PAD] rounded h1; backward: then gr
  float* redm;      // [NCW][TP] each warp's row maxima
  float* reds;      // [NCW][TP] each warp's row sums of exp
  float* rowv;      // [TP] forward: each row's CE * mask
  float* mask_s;    // [TP]
  int* tgt_s;       // [TP] -1 past the window's end
  uint32_t* ubits;  // [S blocks][UW][NC] backward: u > 0 per thread and output
  float* db;        // [S + Q] backward: the block's db1 | db2
  size_t bytes;
};

__host__ __device__ inline Lay carve(void* base, int S, int Q) {
  tc::Carve c{static_cast<char*>(base), 0};
  Lay l;
  const int wide = S > Q ? S : Q;
  l.slots = c.take<char>((size_t)NSLOT * PSLOT);
  l.full = c.take<uint64_t>(NSLOT);
  l.empty = c.take<uint64_t>(NSLOT);
  l.X = c.take<bf16>((size_t)TP * (S + PAD));
  l.Y = c.take<bf16>((size_t)TP * (wide + PAD));
  l.redm = c.take<float>(NCW * TP);
  l.reds = c.take<float>(NCW * TP);
  l.rowv = c.take<float>(TP);
  l.mask_s = c.take<float>(TP);
  l.tgt_s = c.take<int>(TP);
  l.ubits = c.take<uint32_t>((size_t)((S + NB - 1) / NB) * UW * NC);
  l.db = c.take<float>(S + Q);
  l.bytes = c.off;
  return l;
}

// The products a row kernel streams, in order: product p is (K[p], N[p]),
// packed as column blocks of NB (the last may be narrower) of K / 16
// k-steps each.
struct Stream {
  int n, K[4], N[4];
};

// k-steps per ring piece of a column block of ntb 16-column tiles.
__device__ __forceinline__ int kgroup(int ntb, int ks) {
  const int kg = PSLOT / (ntb * FRAG);
  return kg < ks ? kg : ks;
}

// The consumers' walk of the ring: every consumer thread takes the same
// piece index i.
struct Ring {
  char* slots;
  uint64_t* full;
  uint64_t* empty;
  int i;
  __device__ __forceinline__ const char* acquire() {
    const int s = i % NSLOT;
    tc::mbar_wait(full + s, (i / NSLOT) & 1);
    return slots + (size_t)s * PSLOT;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) tc::mbar_arrive(empty + i % NSLOT);
    ++i;
  }
};

// The producer warp's one thread: the stream `w` once per tile of the block.
__device__ __forceinline__ void produce(const Lay& l, const char* w, const Stream& st,
                                        int tiles) {
  int i = 0;
  for (int t = 0; t < tiles; ++t) {
    const char* src = w;
    for (int p = 0; p < st.n; ++p)
      for (int c0 = 0; c0 < st.N[p]; c0 += NB) {
        const int ntb = min(NB, st.N[p] - c0) / 16, ks = st.K[p] / 16, kg = kgroup(ntb, ks);
        for (int k0 = 0; k0 < ks; k0 += kg, ++i) {
          const uint32_t bytes = (uint32_t)(min(kg, ks - k0) * ntb * FRAG);
          const int s = i % NSLOT;
          tc::mbar_wait(l.empty + s, ((i / NSLOT) & 1) ^ 1);
          tc::mbar_expect_tx(l.full + s, bytes);
          tc::bulk_load(l.slots + (size_t)s * PSLOT, src, bytes, l.full + s);
          src += bytes;
        }
      }
  }
}

// A warp's sums of one column block: acc[i][rg][j] is the 16 x 8 tile of
// rows rg * 16.., columns c0 + (warp + NCW i) * 16 + j * 8.., for the i with
// warp + NCW i below the block's count of 16-column tiles.
using Acc = float[NTW][RG][2][4];

// out = X W for the next (K x N) product of the stream, X bf16 [TP][ldx] in
// shared memory; epi(c0, ntb, acc) consumes each column block's sums. A
// k-step's B fragments are one 16-byte load per lane and 16-column tile
// (the stream is packed in fragment order).
template <typename Epi>
__device__ __forceinline__ void product(Ring& r, const bf16* X, int ldx, int K, int N,
                                        Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ks = K / 16;
  for (int c0 = 0; c0 < N; c0 += NB) {
    const int ntb = min(NB, N - c0) / 16, kg = kgroup(ntb, ks);
    Acc acc;
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int rg = 0; rg < RG; ++rg)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][rg][j][v] = 0.f;
    for (int k0 = 0; k0 < ks; k0 += kg) {
      const char* slot = r.acquire();
      const int kn = min(kg, ks - k0);
      for (int kk = 0; kk < kn; ++kk) {
        uint32_t a[RG][4];
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) lda_rm(a[rg], X, ldx, rg * 16, (k0 + kk) * 16);
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const int nt = warp + NCW * i;
          if (nt >= ntb) continue;
          const uint4 b =
              *reinterpret_cast<const uint4*>(slot + (size_t)(kk * ntb + nt) * FRAG + lane * 16);
#pragma unroll
          for (int rg = 0; rg < RG; ++rg) {
            mma_add(acc[i][rg][0], a[rg], b.x, b.z);
            mma_add(acc[i][rg][1], a[rg], b.y, b.w);
          }
        }
      }
      r.release();
    }
    epi(c0, ntb, acc);
  }
}

// f(i, rg, j, h, row, col, v0, v1) over a warp's sums of a column block:
// the pair at (row, col), (row, col + 1) (v0, v1 may be taken by reference).
template <typename F>
__device__ __forceinline__ void each(Acc& acc, int c0, int ntb, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int nt = warp + NCW * i;
    if (nt >= ntb) continue;
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(i, rg, j, h, rg * 16 + g + 8 * h, c0 + nt * 16 + j * 8 + cq, acc[i][rg][j][2 * h],
            acc[i][rg][j][2 * h + 1]);
  }
}

// db[c0 + column] += the column sums over the tile's rows of a warp's
// values, in a fixed order (the thread's 8 rows, then across lanes by xor);
// each column has one owner.
__device__ __forceinline__ void add_colsums(Acc& val, int c0, int ntb, float* db) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int nt = warp + NCW * i;
    if (nt >= ntb) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f;
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) s += val[i][rg][j][e] + val[i][rg][j][2 + e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane < 4) db[c0 + nt * 16 + j * 8 + cq + e] += s;
      }
  }
}

struct PostTc {
  const float* skip;  // (B, T, S)
  const int* tgt;     // (B, W)
  const float* mask;  // (B, W)
  const char* wpk;    // packed stream: w1 | w2 | w2^T | w1^T
  const float* b1;    // (S,)
  const float* b2;    // (Q,)
  const float* gbar;  // () backward: the numerator's cotangent
  float* partial;     // forward: (tiles,) each tile's numerator
  float* dskip;       // (B, T, S) backward out
  bf16* a_bf;         // (B * W, S) backward out: rnd(relu(skip)) of the window
  bf16* h1_bf;        // (B * W, S) rnd(h1)
  bf16* gr_bf;        // (B * W, Q) rnd(g)
  bf16* du_bf;        // (B * W, S) rnd(du)
  float* dbp;         // (gridDim.x, S + Q) backward: each block's db1 | db2
  int B, T, W, S, Q;
};

// Tile setup: rows of relu(skip) rounded into X (and out to a_bf when
// given), the targets and mask of the tile's rows; past the window's end
// zeros, target -1, mask 0. Each thread has U 16-byte loads in flight.
__device__ __forceinline__ void stage_tile(const Lay& l, const PostTc& a, int b, int w0,
                                           bf16* a_bf) {
  constexpr int U = 4;
  const int S = a.S, ldx = S + PAD, head = a.T - a.W, kq = S / 4, n = TP * kq;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * NC) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NC, r = i / kq, k = (i % kq) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && w0 + r < a.W)
        v[u] = *reinterpret_cast<const float4*>(a.skip + ((size_t)b * a.T + head + w0 + r) * S + k);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NC, r = i / kq, k = (i % kq) * 4;
      if (i >= n) break;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(v[u].x, 0.f), fmaxf(v[u].y, 0.f));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf(v[u].z, 0.f), fmaxf(v[u].w, 0.f));
      uint2 p;
      p.x = *reinterpret_cast<const uint32_t*>(&lo);
      p.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(l.X + r * ldx + k) = p;
      if (a_bf != nullptr && w0 + r < a.W)
        *reinterpret_cast<uint2*>(a_bf + ((size_t)b * a.W + w0 + r) * S + k) = p;
    }
  }
  for (int r = threadIdx.x; r < TP; r += NC) {
    const bool ok = w0 + r < a.W;
    l.tgt_s[r] = ok ? a.tgt[(size_t)b * a.W + w0 + r] : -1;
    l.mask_s[r] = ok ? a.mask[(size_t)b * a.W + w0 + r] : 0.f;
  }
}

// The valid rows of a bf16 [TP][ldy] tile out to a (B * W, N) tensor.
__device__ __forceinline__ void store_tile(bf16* out, const bf16* Y, int ldy, int N, int b,
                                           int w0, int W) {
  const int kq = N / 8;
  for (int i = threadIdx.x; i < TP * kq; i += NC) {
    const int r = i / kq, k = (i % kq) * 8;
    if (w0 + r < W)
      *reinterpret_cast<uint4*>(out + ((size_t)b * W + w0 + r) * N + k) =
          *reinterpret_cast<const uint4*>(Y + r * ldy + k);
  }
}

// u = rnd(A) w1 + b1 of the tile (X holds rnd(A)); rnd(relu(u)) into Y;
// with ubits, each thread's flags u > 0 of its outputs.
__device__ __forceinline__ void hidden(Ring& r, const Lay& l, const PostTc& a,
                                       uint32_t* ubits) {
  const int S = a.S, ldy = (S > a.Q ? S : a.Q) + PAD;
  product(r, l.X, S + PAD, S, S, [&](int c0, int ntb, Acc& acc) {
    uint32_t bits[UW] = {};
    each(acc, c0, ntb, [&](int i, int rg, int j, int h, int row, int n, float v0, float v1) {
      const float u0 = v0 + a.b1[n], u1 = v1 + a.b1[n + 1];
      const int bit = ((i * RG + rg) * 2 + j) * 4 + 2 * h;
      bits[bit >> 5] |= (u0 > 0.f ? 1u : 0u) << (bit & 31);
      bits[bit >> 5] |= (u1 > 0.f ? 1u : 0u) << ((bit + 1) & 31);
      *reinterpret_cast<__nv_bfloat162*>(l.Y + row * ldy + n) =
          __floats2bfloat162_rn(fmaxf(u0, 0.f), fmaxf(u1, 0.f));
    });
    if (ubits != nullptr)
#pragma unroll
      for (int k = 0; k < UW; ++k) ubits[((c0 / NB) * UW + k) * NC + threadIdx.x] = bits[k];
  });
}

// Logits v = rnd(h1) w2 + b2 of the tile (Y holds rnd(h1)) in registers,
// then each row's max and sum of exp across the warps: m[rg][h], tot[rg][h]
// of the thread's rows rg * 16 + g + 8 h.
__device__ __forceinline__ void logits_lse(Ring& r, const Lay& l, const PostTc& a, Acc& v,
                                           float (&m)[RG][2], float (&tot)[RG][2]) {
  const int S = a.S, Q = a.Q, ntb = Q / 16;
  product(r, l.Y, (S > Q ? S : Q) + PAD, S, Q, [&](int c0, int nb, Acc& acc) {
    each(acc, c0, nb, [&](int i, int rg, int j, int h, int, int n, float v0, float v1) {
      v[i][rg][j][2 * h] = v0 + a.b2[n];
      v[i][rg][j][2 * h + 1] = v1 + a.b2[n + 1];
    });
  });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
#pragma unroll
  for (int rg = 0; rg < RG; ++rg)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NTW; ++i)
        if (warp + NCW * i < ntb)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mx = fmaxf(mx, fmaxf(v[i][rg][j][2 * h], v[i][rg][j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if ((lane & 3) == 0) l.redm[warp * TP + rg * 16 + g + 8 * h] = mx;
    }
  csync();
#pragma unroll
  for (int rg = 0; rg < RG; ++rg)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 16 + g + 8 * h;
      float mx = l.redm[row];
      for (int w = 1; w < NCW; ++w) mx = fmaxf(mx, l.redm[w * TP + row]);
      m[rg][h] = mx;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NTW; ++i)
        if (warp + NCW * i < ntb)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            s += expf(v[i][rg][j][2 * h] - mx) + expf(v[i][rg][j][2 * h + 1] - mx);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((lane & 3) == 0) l.reds[warp * TP + row] = s;
    }
  csync();
#pragma unroll
  for (int rg = 0; rg < RG; ++rg)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 16 + g + 8 * h;
      float s = 0.f;
      for (int w = 0; w < NCW; ++w) s += l.reds[w * TP + row];
      tot[rg][h] = s;
    }
}

__device__ __forceinline__ int block_tiles(int tiles) {
  return (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
}

// The ring's barriers (thread 0), then the whole block syncs.
__device__ __forceinline__ Ring ring_init(const Lay& l) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      tc::mbar_init(l.full + s, 1);
      tc::mbar_init(l.empty + s, NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return Ring{l.slots, l.full, l.empty, 0};
}

// Forward: partial[tile] = the sum over the tile's rows, in order, of
// (logsumexp(v) - v[target]) * mask.
__global__ void __launch_bounds__(NTH, 1) fwd_tc(PostTc a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const Lay l = carve(smraw, a.S, a.Q);
  const int per_b = (a.W + TP - 1) / TP, tiles = a.B * per_b;
  Ring r = ring_init(l);
  if (threadIdx.x >= NC) {
    if (threadIdx.x == NC)
      produce(l, a.wpk, Stream{2, {a.S, a.S}, {a.S, a.Q}}, block_tiles(tiles));
    return;
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_b, w0 = (tile % per_b) * TP;
    csync();
    stage_tile(l, a, b, w0, nullptr);
    csync();
    hidden(r, l, a, nullptr);
    csync();
    Acc v;
    float m[RG][2], tot[RG][2];
    logits_lse(r, l, a, v, m, tot);
    // The owner of the row's target logit writes the row's value.
    each(v, 0, a.Q / 16, [&](int, int rg, int, int h, int row, int n, float v0, float v1) {
      const int t = l.tgt_s[row];
      if (t == n || t == n + 1)
        l.rowv[row] = ((logf(tot[rg][h]) + m[rg][h]) - (t == n ? v0 : v1)) * l.mask_s[row];
    });
    csync();
    if (threadIdx.x < 32) {  // rows lane and lane + 32, then a fixed xor tree
      float s = 0.f;
      for (int row = threadIdx.x; row < TP; row += 32) s += l.tgt_s[row] >= 0 ? l.rowv[row] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (threadIdx.x == 0) a.partial[tile] = s;
    }
  }
}

// Backward row pass (the note at the top): dskip, the bf16 operands of the
// weight gradients and the block's db1 | db2 slot.
__global__ void __launch_bounds__(NTH, 1) bwd_rows_tc(PostTc a) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int S = a.S, Q = a.Q, head = a.T - a.W, ldy = (S > Q ? S : Q) + PAD;
  const Lay l = carve(smraw, S, Q);
  const int per_b = (a.W + TP - 1) / TP, tiles = a.B * per_b;
  Ring r = ring_init(l);
  if (threadIdx.x >= NC) {
    if (threadIdx.x == NC)
      produce(l, a.wpk, Stream{4, {S, S, Q, S}, {S, Q, S, S}}, block_tiles(tiles));
    return;
  }
  // dskip's head rows are exactly 0: a share of them per block.
  const size_t per = (size_t)head * S / 4, nz = (size_t)a.B * per;
  for (size_t i = (size_t)blockIdx.x * NC + threadIdx.x; i < nz; i += (size_t)gridDim.x * NC)
    reinterpret_cast<float4*>(a.dskip + (i / per) * a.T * S)[i % per] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < S + Q; i += NC) l.db[i] = 0.f;
  const float gbar = *a.gbar;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_b, w0 = (tile % per_b) * TP;
    csync();
    stage_tile(l, a, b, w0, a.a_bf);
    csync();
    hidden(r, l, a, l.ubits);
    csync();
    store_tile(a.h1_bf, l.Y, ldy, S, b, w0, a.W);
    Acc v;
    float m[RG][2], tot[RG][2];
    logits_lse(r, l, a, v, m, tot);  // its barriers end every read of h1 in Y
    // g = (softmax - onehot) * mask * gbar in place of v; gr into Y; db2.
    each(v, 0, Q / 16, [&](int, int rg, int, int h, int row, int n, float& v0, float& v1) {
      const int t = l.tgt_s[row];
      const float sc = l.mask_s[row] * gbar;
      v0 = (expf(v0 - m[rg][h]) / tot[rg][h] - (t == n ? 1.f : 0.f)) * sc;
      v1 = (expf(v1 - m[rg][h]) / tot[rg][h] - (t == n + 1 ? 1.f : 0.f)) * sc;
      *reinterpret_cast<__nv_bfloat162*>(l.Y + row * ldy + n) = __floats2bfloat162_rn(v0, v1);
    });
    add_colsums(v, S, Q / 16, l.db);
    csync();
    store_tile(a.gr_bf, l.Y, ldy, Q, b, w0, a.W);
    // du = (u > 0) (gr w2^T), rounded into X; db1 from du unrounded.
    product(r, l.Y, ldy, Q, S, [&](int c0, int ntb, Acc& acc) {
      uint32_t w[UW];
#pragma unroll
      for (int k = 0; k < UW; ++k) w[k] = l.ubits[((c0 / NB) * UW + k) * NC + threadIdx.x];
      each(acc, c0, ntb, [&](int i, int rg, int j, int h, int row, int n, float& v0, float& v1) {
        const int bit = ((i * RG + rg) * 2 + j) * 4 + 2 * h;
        if (!((w[bit >> 5] >> (bit & 31)) & 1u)) v0 = 0.f;
        if (!((w[bit >> 5] >> ((bit + 1) & 31)) & 1u)) v1 = 0.f;
        *reinterpret_cast<__nv_bfloat162*>(l.X + row * (S + PAD) + n) =
            __floats2bfloat162_rn(v0, v1);
      });
      add_colsums(acc, c0, ntb, l.db);
    });
    csync();
    store_tile(a.du_bf, l.X, S + PAD, S, b, w0, a.W);
    // dskip = (skip > 0) (dur w1^T) on the valid rows.
    product(r, l.X, S + PAD, S, S, [&](int c0, int ntb, Acc& acc) {
      each(acc, c0, ntb, [&](int, int, int, int, int row, int n, float v0, float v1) {
        if (w0 + row >= a.W) return;
        const size_t at = ((size_t)b * a.T + head + w0 + row) * S + n;
        const float2 sk = *reinterpret_cast<const float2*>(a.skip + at);
        *reinterpret_cast<float2*>(a.dskip + at) =
            make_float2(sk.x > 0.f ? v0 : 0.f, sk.y > 0.f ? v1 : 0.f);
      });
    });
  }
  csync();
  for (int i = threadIdx.x; i < S + Q; i += NC) a.dbp[(size_t)blockIdx.x * (S + Q) + i] = l.db[i];
}

// ---- weight gradients: split-K over position chunks on tensor cores ---------

constexpr int WT = 128;   // output tile edge
constexpr int WKP = 64;   // positions per stage
constexpr int WST = 3;    // stages in flight
constexpr int WTH = 256;  // threads: 8 warps of 64 rows x 32 columns
constexpr int WLD = WT + PAD;

inline size_t wgrad_smem() { return (size_t)WST * 2 * WKP * WLD * sizeof(bf16); }

// part[chunk][o + m * N + n] = the sum over the chunk's positions p of
// A[p][m] Bm[p][n], for the 128 x 128 output tiles of dw1 = rnd(A)^T dur
// (o = 0, blocks first) and dw2 = rnd(h1)^T gr (o = S * S).
__global__ void __launch_bounds__(WTH, 2)
wgrad_tc(const bf16* __restrict__ a_bf, const bf16* __restrict__ du_bf,
         const bf16* __restrict__ h1_bf, const bf16* __restrict__ gr_bf, float* __restrict__ part,
         int n_pos, int S, int Q, int chunk) {
  extern __shared__ __align__(128) unsigned char smraw[];
  bf16* sm = reinterpret_cast<bf16*>(smraw);  // WST x ([WKP][WLD] A, [WKP][WLD] B)
  const int tm = (S + WT - 1) / WT;
  int tile = blockIdx.x;
  const bool second = tile >= tm * tm;
  if (second) tile -= tm * tm;
  const int N = second ? Q : S, tn = (N + WT - 1) / WT;
  const bf16* A = second ? h1_bf : a_bf;
  const bf16* Bm = second ? gr_bf : du_bf;
  const int m0 = (tile / tn) * WT, n0 = (tile % tn) * WT;
  const int p0 = blockIdx.y * chunk, p1 = min(n_pos, p0 + chunk);
  const int nit = p1 > p0 ? (p1 - p0 + WKP - 1) / WKP : 0;
  constexpr int CQ = WT / 8;  // 16-byte pieces per staged row
  auto stage = [&](int it) {
    if (it < nit) {
      bf16* as = sm + (size_t)(it % WST) * 2 * WKP * WLD;
      for (int i = threadIdx.x; i < 2 * WKP * CQ; i += WTH) {
        const bool isb = i >= WKP * CQ;
        const int j = isb ? i - WKP * CQ : i, rr = j / CQ, c = (j % CQ) * 8;
        const int p = p0 + it * WKP + rr, col = (isb ? n0 : m0) + c, ld = isb ? N : S;
        const bool ok = p < p1 && col < ld;
        const bf16* src = isb ? Bm : A;
        cp16(as + (isb ? WKP * WLD : 0) + rr * WLD + c, ok ? src + (size_t)p * ld + col : src, ok);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  for (int s = 0; s < WST - 1; ++s) stage(s);
  for (int it = 0; it < nit; ++it) {
    asm volatile("cp.async.wait_group %0;" ::"n"(WST - 2) : "memory");
    __syncthreads();  // stage it is in; stage it - 1's readers are done
    stage(it + WST - 1);
    const bf16* as = sm + (size_t)(it % WST) * 2 * WKP * WLD;
    const bf16* bs = as + WKP * WLD;
#pragma unroll
    for (int ks = 0; ks < WKP / 16; ++ks) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lda_km(af[i], as, WLD, wm + i * 16, ks * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) ldb_kn(bfr[j], bs, WLD, wn + j * 16, ks * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          mma(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
  }
  float* out = part + (size_t)blockIdx.y * ((size_t)S * S + (size_t)S * Q) +
               (second ? (size_t)S * S : 0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = m0 + wm + i * 16 + g + 8 * h, n = n0 + wn + j * 8 + cq;
        if (mm < S && n < N)
          *reinterpret_cast<float2*>(out + (size_t)mm * N + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// grads = dw1 | db1 | dw2 | db2: each dw element the sum of the chunks'
// partials, each db element the sum of the row blocks' slots, in order.
__global__ void __launch_bounds__(NT) reduce_tc(const float* __restrict__ part, int chunks,
                                                const float* __restrict__ dbp, int blocks,
                                                float* __restrict__ grads, int S, int Q) {
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t ss = (size_t)S * S, nwd = ss + (size_t)S * Q;
  if (idx >= nwd + S + Q) return;
  const float* p;
  size_t stride;
  int n;
  if (idx < ss || (idx >= ss + S && idx < nwd + S)) {  // dw1, dw2
    p = part + (idx < ss ? idx : idx - S);
    stride = nwd;
    n = chunks;
  } else {  // db1, db2
    p = dbp + (idx < ss + S ? idx - ss : S + (idx - nwd - S));
    stride = S + Q;
    n = blocks;
  }
  float s = 0.f;
  for (int c = 0; c < n; ++c) s += p[(size_t)c * stride];
  grads[idx] = s;
}

}  // namespace ptc

struct PostTcArgs {
  ptc::PostTc k;
  float* num;    // () forward out
  float* wpart;  // (chunks, S * S + S * Q) backward scratch
  float* grads;  // (S * S + S + S * Q + Q,) backward out
  int blocks;    // row-kernel blocks: one per SM at most (the backward's db slots)
  int chunks;    // position chunks of wgrad_tc
};

static cudaError_t tc_prepare(const PostTcArgs& a, size_t* bytes) {
  *bytes = ptc::carve(nullptr, a.k.S, a.k.Q).bytes;
  if (a.blocks < 1) return cudaErrorInvalidValue;
  WN_TRY(cudaFuncSetAttribute(ptc::fwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes));
  WN_TRY(cudaFuncSetAttribute(ptc::bwd_rows_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes));
  return cudaFuncSetAttribute(ptc::wgrad_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)ptc::wgrad_smem());
}

static cudaError_t forward_tc(const PostTcArgs& a, cudaStream_t s, int* launches) {
  size_t bytes;
  WN_TRY(tc_prepare(a, &bytes));
  ptc::fwd_tc<<<a.blocks, ptc::NTH, bytes, s>>>(a.k);
  WN_TRY(cudaGetLastError());
  post_sum<<<1, NT, 0, s>>>(a.k.partial, a.k.B * ((a.k.W + ptc::TP - 1) / ptc::TP), a.num);
  WN_TRY(cudaGetLastError());
  *launches += 2;
  return cudaSuccess;
}

static cudaError_t backward_tc(const PostTcArgs& a, cudaStream_t s, int* launches) {
  const int S = a.k.S, Q = a.k.Q, n_pos = a.k.B * a.k.W, tm = (S + ptc::WT - 1) / ptc::WT;
  size_t bytes;
  WN_TRY(tc_prepare(a, &bytes));
  if (a.chunks < 1) return cudaErrorInvalidValue;
  ptc::bwd_rows_tc<<<a.blocks, ptc::NTH, bytes, s>>>(a.k);
  WN_TRY(cudaGetLastError());
  const int jobs = tm * tm + tm * ((Q + ptc::WT - 1) / ptc::WT);
  ptc::wgrad_tc<<<dim3(jobs, a.chunks), ptc::WTH, ptc::wgrad_smem(), s>>>(
      a.k.a_bf, a.k.du_bf, a.k.h1_bf, a.k.gr_bf, a.wpart, n_pos, S, Q,
      (n_pos + a.chunks - 1) / a.chunks);
  WN_TRY(cudaGetLastError());
  const size_t nw = (size_t)S * S + S + (size_t)S * Q + Q;
  ptc::reduce_tc<<<(unsigned)((nw + NT - 1) / NT), NT, 0, s>>>(a.wpart, a.chunks, a.k.dbp,
                                                               a.blocks, a.grads, S, Q);
  WN_TRY(cudaGetLastError());
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

// Bytes of dynamic shared memory of the tensor-core row kernels at these
// widths (post_loss.py `tc_smem` must agree).
extern "C" long long wn_post_loss_tc_smem(int S, int Q) {
  return (long long)wn::ptc::carve(nullptr, S, Q).bytes;
}

extern "C" int wn_post_loss_fwd_tc(const wn::PostTcArgs* a, void* stream, int* launches) {
  return (int)wn::forward_tc(*a, static_cast<cudaStream_t>(stream), launches);
}

extern "C" int wn_post_loss_bwd_tc(const wn::PostTcArgs* a, void* stream, int* launches) {
  return (int)wn::backward_tc(*a, static_cast<cudaStream_t>(stream), launches);
}
