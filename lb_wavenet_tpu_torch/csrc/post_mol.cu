// The mixture-of-logistics head of Tacotron 2's WaveNet vocoder and its
// masked NLL, forward and backward, over the scored window of the training
// step (ops/mol.py has the equations; ops/cuda/post_mol.py the wrapper).
//
// Replaces no TPU kernel: the JAX package has no mixture output. It is
// post_loss.cu's counterpart for arch.output_dist == "mol": the head is one
// projection y = relu(skip) w + b of the skip sum (S = 256) to the
// mixture's 3 M = 30 parameters, and the loss the discretised MoL NLL of
// the 16-bit target sample. Only the scored rows [T - W, T) are read; the
// head rows of dskip are written as zeros.
//
// Bound on an H100 at the Tacotron 2 config, B = 8, W = 7200, S = 256
// (utils/profiling.py `mol_post_cost`): the products are 2 B W S 3M = 0.88
// GFLOP forward and twice that backward, under a microsecond at the bf16
// peak; the bytes bound both passes: the scored skip rows in (59 MB,
// 17.6 us) forward, and backward those again plus all of dskip out
// (84 MB), 43 us. The design keeps everything but skip, dskip and the
// per-block partials on chip:
//   * persistent blocks of 4 warps walk tiles of TM = 64 scored rows (rows
//     of the flattened (B, W) window, across batch rows); the head's
//     weight is staged once per block, rounded to the compute dtype, as
//     [S][NP] (both passes' B operand), 3 M padded to NP = 32 with zeros;
//   * relu(skip) is read as fp32 with 16-byte loads and rounded on its way
//     into shared memory; the head outputs of a tile go to shared memory,
//     and one thread a row forms the NLL (and, backward, its gradient dy in
//     closed form, ops/mol.py `mol_nll_bwd`'s expressions);
//   * bf16 (with S a multiple of 16): every product is mma.sync m16n8k16
//     bf16 -> fp32, one mma from zero per 16-deep k-step added in k-step
//     order (tc_tile.cuh `mma_add`, the order train_stack.py `tc_mm`
//     reproduces): y = A w (16 k-steps), da = rnd(dy) w^T (2 k-steps over
//     the padded 32) and the tile's dw = A^T rnd(dy) (4 k-steps over its
//     rows); fp32: the same products as in-order FMA chains on CUDA cores;
//   * forward (`fwd_rows`, `sum_partials`: 2 launches): mask * NLL summed
//     over each tile's rows in row order into one partial per tile, the
//     partials in tile order;
//   * backward (`bwd_rows`, `reduce_grads`: 2 launches): dskip = (skip > 0)
//     da for the scored rows, zeros for the head rows; each block adds its
//     tiles' dw into an [S][NP] sum in shared memory (each element one
//     thread's) and the unrounded dy's column sums (db) in a register, in
//     tile order; `reduce_grads` adds the blocks' partials in block order.
// No float atomics: a rerun is bit-identical.
#include "common.cuh"
#include "tc_tile.cuh"

namespace wn {
namespace mol {

using tct::bf16;

constexpr int TM = 64;           // scored rows per tile
constexpr int NWARP = 4;         // warps per block, 16 rows of a tile each
constexpr int THREADS = 32 * NWARP;
constexpr int NP = 32;           // head outputs padded: 3 n_mix <= NP
constexpr int MAXM = NP / 3;     // components
constexpr int PADK = 8;          // row padding (elements) of the shared tiles
constexpr float LOG_SCALE_MIN = -7.f;
constexpr float HALF_BIN = 1.f / 65535.f;   // 1 / (n_bins - 1), 16-bit bins
constexpr float EDGE = 0.999f;
constexpr float DELTA_MIN = 1e-5f;
constexpr float LOG_HALF_BINS = 10.397192001342773f;   // f32(log((n_bins - 1) / 2))

struct MolArgs {
  const float* skip;   // (B, T, S)
  const float* tgt;    // (B, W) target samples in [-1, 1)
  const float* mask;   // (B, W)
  const float* w;      // (S, 3M) the head's weight, fp32 (rounded when staged)
  const float* bias;   // (3M,)
  const float* gbar;   // () cotangent of the numerator (backward)
  float* partial;      // forward: (tiles,); backward: (blocks, S * NP + NP)
  float* num;          // () forward out
  float* dskip;        // (B, T, S) backward out, every row
  float* grads;        // (S * 3M + 3M) backward out: dw | db
  int B, T, W, S, M, tc, blocks;
};

struct Smem {
  size_t wn, a, d, y, dw, red, bytes;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Dynamic shared memory of the forward (bwd 0) or backward (bwd 1) row
// kernel at width S with tiles of `esize`-byte elements (2: bf16, tensor
// cores; 4: fp32): the weight [S][NP + PADK], the rows A [TM][S + PADK],
// the head outputs Y [TM][NP + 1]; forward the rows' terms red [TM];
// backward the rounded dy D [TM][NP + PADK] and the block's dw [S][NP].
__host__ __device__ inline Smem carve(int S, int esize, int bwd) {
  Smem m;
  size_t off = 0;
  m.wn = off;
  off = align16(off + (size_t)esize * S * (NP + PADK));
  m.a = off;
  off = align16(off + (size_t)esize * TM * (S + PADK));
  m.y = off;
  off = align16(off + sizeof(float) * TM * (NP + 1));
  m.red = m.d = m.dw = off;
  if (bwd) {
    off = align16(off + (size_t)esize * TM * (NP + PADK));
    m.dw = off;
    off = align16(off + sizeof(float) * S * NP);
  } else {
    off = align16(off + sizeof(float) * TM);
  }
  m.bytes = off;
  return m;
}

template <typename E> __device__ __forceinline__ E to_e(float v);
template <> __device__ __forceinline__ float to_e<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_e<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }
// torch.nn.functional.softplus (threshold 20).
__device__ __forceinline__ float softplusf(float v) { return v > 20.f ? v : log1pf(expf(v)); }

// The head's weight, rounded, as wn [S][NP + PADK] (columns past 3M zero).
template <typename E>
__device__ void stage_weights(const MolArgs& a, E* wn) {
  const int n3 = 3 * a.M;
  for (int i = threadIdx.x; i < a.S * NP; i += THREADS) {
    const int s = i / NP, j = i % NP;
    wn[s * (NP + PADK) + j] = to_e<E>(j < n3 ? a.w[(size_t)s * n3 + j] : 0.f);
  }
}

// rnd(relu(skip)) of the tile's TM scored rows from row r0 into A [TM][S +
// PADK]; rows past the window are zeros.
template <typename E>
__device__ void stage_rows(const MolArgs& a, long r0, E* A) {
  const int q4 = a.S / 4;
  const long nrows = (long)a.B * a.W;
  for (int i = threadIdx.x; i < TM * q4; i += THREADS) {
    const int r = i / q4, c = (i % q4) * 4;
    const long row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nrows) {
      const long b = row / a.W, w = row % a.W;
      v = *reinterpret_cast<const float4*>(a.skip + ((size_t)b * a.T + (a.T - a.W) + w) * a.S + c);
    }
    E* dst = A + r * (a.S + PADK) + c;
    dst[0] = to_e<E>(fmaxf(v.x, 0.f));
    dst[1] = to_e<E>(fmaxf(v.y, 0.f));
    dst[2] = to_e<E>(fmaxf(v.z, 0.f));
    dst[3] = to_e<E>(fmaxf(v.w, 0.f));
  }
}

// Y [TM][NP + 1] = A w (no bias) on tensor cores: warp w's 16 rows, 4
// 8-column tiles.
__device__ void head_tc(const MolArgs& a, const bf16* A, const bf16* wn, float* Y) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16, g = lane >> 2, q = lane & 3;
  const int ld = a.S + PADK;
  float acc[4][4];
  tct::zero(acc);
  for (int k0 = 0; k0 < a.S; k0 += 16) {
    uint32_t af[4];
    tct::lda_rm(af, A, ld, r0, k0);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t bf[4];
      tct::ldb_kn(bf, wn, NP + PADK, p * 16, k0);
      tct::mma_add(acc[2 * p], af, bf[0], bf[1]);
      tct::mma_add(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = t * 8 + 2 * q;
    Y[(r0 + g) * (NP + 1) + j] = acc[t][0];
    Y[(r0 + g) * (NP + 1) + j + 1] = acc[t][1];
    Y[(r0 + g + 8) * (NP + 1) + j] = acc[t][2];
    Y[(r0 + g + 8) * (NP + 1) + j + 1] = acc[t][3];
  }
}

// The same on CUDA cores (fp32): one in-order FMA chain per output.
__device__ void head_fma(const MolArgs& a, const float* A, const float* wn, float* Y) {
  const int n3 = 3 * a.M, ld = a.S + PADK;
  for (int i = threadIdx.x; i < TM * n3; i += THREADS) {
    const int r = i / n3, j = i % n3;
    const float* x = A + r * ld;
    float acc = 0.f;
    for (int s = 0; s < a.S; ++s) acc = fmaf(x[s], wn[s * (NP + PADK) + j], acc);
    Y[r * (NP + 1) + j] = acc;
  }
}

// The NLL of sample x under the mixture of one row's head outputs (y, the
// products without bias, plus bias); with dy, d(wgt * NLL) / dy of the 3M
// outputs too (ops/mol.py `mol_nll_bwd`).
__device__ float row_nll(const float* y, const float* bias, float x, int M, float* dy,
                         float wgt) {
  float logit[MAXM], raw[MAXM], ls[MAXM], plus[MAXM], minus[MAXM], mid[MAXM];
  float cp[MAXM], cm[MAXM], delta[MAXM], z[MAXM];
  const bool low = x < -EDGE, high = x > EDGE;
  float lmax = 0.f;
  for (int i = 0; i < M; ++i) {
    logit[i] = y[i] + bias[i];
    const float mean = y[M + i] + bias[M + i];
    raw[i] = y[2 * M + i] + bias[2 * M + i];
    ls[i] = fmaxf(raw[i], LOG_SCALE_MIN);
    const float inv = expf(-ls[i]);
    const float c = x - mean;
    plus[i] = inv * (c + HALF_BIN);
    minus[i] = inv * (c - HALF_BIN);
    mid[i] = inv * c;
    cp[i] = sigm(plus[i]);
    cm[i] = sigm(minus[i]);
    delta[i] = cp[i] - cm[i];
    float lp;
    if (low) {
      lp = plus[i] - softplusf(plus[i]);
    } else if (high) {
      lp = -softplusf(minus[i]);
    } else if (delta[i] > DELTA_MIN) {
      lp = logf(fmaxf(delta[i], 1e-12f));
    } else {
      lp = mid[i] - ls[i] - 2.f * softplusf(mid[i]) - LOG_HALF_BINS;
    }
    z[i] = lp;
    lmax = i == 0 ? logit[i] : fmaxf(lmax, logit[i]);
  }
  float se = 0.f;
  for (int i = 0; i < M; ++i) se += expf(logit[i] - lmax);
  const float lse_a = lmax + logf(se);
  float zmax = 0.f;
  for (int i = 0; i < M; ++i) {
    z[i] += logit[i] - lse_a;
    zmax = i == 0 ? z[i] : fmaxf(zmax, z[i]);
  }
  float sz = 0.f;
  for (int i = 0; i < M; ++i) sz += expf(z[i] - zmax);
  const float lse_z = zmax + logf(sz);
  if (dy != nullptr) {
    for (int i = 0; i < M; ++i) {
      const float resp = expf(z[i] - lse_z);
      const float pi = expf(logit[i] - lse_a);
      float gp = 0.f, gm = 0.f, gd = 0.f, gl = 0.f;
      if (low) {
        gp = sigm(-plus[i]);
      } else if (high) {
        gm = -sigm(minus[i]);
      } else if (delta[i] > DELTA_MIN) {
        const float safe = fmaxf(delta[i], 1e-12f);
        gp = cp[i] * sigm(-plus[i]) / safe;
        gm = -cm[i] * (1.f - cm[i]) / safe;
      } else {
        gd = 1.f - 2.f * sigm(mid[i]);
        gl = -1.f;
      }
      const float inv = expf(-ls[i]);
      const float dlp_mean = -inv * (gp + gm + gd);
      const float dlp_ls = gl - (plus[i] * gp + minus[i] * gm + mid[i] * gd);
      dy[i] = (pi - resp) * wgt;
      dy[M + i] = (-resp * dlp_mean) * wgt;
      dy[2 * M + i] = (raw[i] >= LOG_SCALE_MIN ? -resp * dlp_ls : 0.f) * wgt;
    }
  }
  return -lse_z;
}

template <bool TC>
struct Route {
  using E = float;
};
template <>
struct Route<true> {
  using E = bf16;
};

template <bool TC>
__device__ __forceinline__ void head(const MolArgs& a, const typename Route<TC>::E* A,
                                     const typename Route<TC>::E* wn, float* Y) {
  if constexpr (TC) head_tc(a, A, wn, Y);
  else head_fma(a, A, wn, Y);
}

template <bool TC>
__global__ void __launch_bounds__(THREADS) fwd_rows(MolArgs a) {
  using E = typename Route<TC>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = carve(a.S, sizeof(E), 0);
  E* wn = reinterpret_cast<E*>(smem + m.wn);
  E* A = reinterpret_cast<E*>(smem + m.a);
  float* Y = reinterpret_cast<float*>(smem + m.y);
  float* red = reinterpret_cast<float*>(smem + m.red);
  stage_weights<E>(a, wn);
  const long nrows = (long)a.B * a.W;
  const long tiles = (nrows + TM - 1) / TM;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();   // the weights are staged; the last tile's readers are done
    stage_rows<E>(a, tile * TM, A);
    __syncthreads();
    head<TC>(a, A, wn, Y);
    __syncthreads();
    if (threadIdx.x < TM) {
      const long row = tile * TM + threadIdx.x;
      float v = 0.f;
      if (row < nrows)
        v = a.mask[row] * row_nll(Y + threadIdx.x * (NP + 1), a.bias, a.tgt[row], a.M,
                                  nullptr, 0.f);
      red[threadIdx.x] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s += red[r];
      a.partial[tile] = s;
    }
  }
}

// out = sum of partial[0 .. n) in a fixed order (one block).
__global__ void sum_partials(const float* partial, int n, float* out) {
  __shared__ float acc[256];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) s += partial[i];
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int h = 128; h > 0; h >>= 1) {
    if (threadIdx.x < h) acc[threadIdx.x] += acc[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = acc[0];
}

// dws [S][NP] += A^T D for the tile on tensor cores: warp w takes the
// 16-row strips mt = w, w + 4, ... of dw; 4 k-steps over the tile's rows.
__device__ void wgrad_tc(const MolArgs& a, const bf16* A, const bf16* D, float* dws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int mt = warp; mt < a.S / 16; mt += NWARP) {
    float acc[4][4];
    tct::zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < TM; k0 += 16) {
      uint32_t af[4];
      tct::lda_km(af, A, a.S + PADK, mt * 16, k0);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];
        tct::ldb_kn(bf, D, NP + PADK, p * 16, k0);
        tct::mma_add(acc[2 * p], af, bf[0], bf[1]);
        tct::mma_add(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    const int s = mt * 16 + g;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = t * 8 + 2 * q;
      dws[s * NP + j] += acc[t][0];
      dws[s * NP + j + 1] += acc[t][1];
      dws[(s + 8) * NP + j] += acc[t][2];
      dws[(s + 8) * NP + j + 1] += acc[t][3];
    }
  }
}

__device__ void wgrad_fma(const MolArgs& a, const float* A, const float* D, float* dws) {
  const int n3 = 3 * a.M;
  for (int i = threadIdx.x; i < a.S * n3; i += THREADS) {
    const int s = i / n3, j = i % n3;
    float acc = 0.f;
    for (int r = 0; r < TM; ++r) acc = fmaf(A[r * (a.S + PADK) + s], D[r * (NP + PADK) + j], acc);
    dws[s * NP + j] += acc;
  }
}

// dskip of the tile's rows: (skip > 0) * (D w^T), D's padded columns zero.
__device__ __forceinline__ size_t skip_offset(const MolArgs& a, long row) {
  const long b = row / a.W, w = row % a.W;
  return ((size_t)b * a.T + (a.T - a.W) + w) * a.S;
}

__device__ void dskip_tc(const MolArgs& a, long r0, const bf16* D, const bf16* wn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp * 16, g = lane >> 2, q = lane & 3;
  const long nrows = (long)a.B * a.W;
  for (int n0 = 0; n0 < a.S; n0 += 16) {
    float acc[2][4];
    tct::zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < NP; k0 += 16) {
      uint32_t af[4], bf[4];
      tct::lda_rm(af, D, NP + PADK, rw, k0);
      tct::ldb_nk(bf, wn, NP + PADK, n0, k0);
      tct::mma_add(acc[0], af, bf[0], bf[1]);
      tct::mma_add(acc[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = r0 + rw + g + 8 * h;
      if (row >= nrows) continue;
      const size_t base = skip_offset(a, row);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = n0 + t * 8 + 2 * q;
        const float2 sk = *reinterpret_cast<const float2*>(a.skip + base + col);
        *reinterpret_cast<float2*>(a.dskip + base + col) =
            make_float2(sk.x > 0.f ? acc[t][2 * h] : 0.f, sk.y > 0.f ? acc[t][2 * h + 1] : 0.f);
      }
    }
  }
}

__device__ void dskip_fma(const MolArgs& a, long r0, const float* D, const float* wn) {
  const int n3 = 3 * a.M;
  const long nrows = (long)a.B * a.W;
  for (int i = threadIdx.x; i < TM * a.S; i += THREADS) {
    const int r = i / a.S, s = i % a.S;
    const long row = r0 + r;
    if (row >= nrows) continue;
    float acc = 0.f;
    for (int j = 0; j < n3; ++j) acc = fmaf(D[r * (NP + PADK) + j], wn[s * (NP + PADK) + j], acc);
    const size_t at = skip_offset(a, row) + s;
    a.dskip[at] = a.skip[at] > 0.f ? acc : 0.f;
  }
}

template <bool TC>
__global__ void __launch_bounds__(THREADS) bwd_rows(MolArgs a) {
  using E = typename Route<TC>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = carve(a.S, sizeof(E), 1);
  E* wn = reinterpret_cast<E*>(smem + m.wn);
  E* A = reinterpret_cast<E*>(smem + m.a);
  E* D = reinterpret_cast<E*>(smem + m.d);
  float* Y = reinterpret_cast<float*>(smem + m.y);
  float* dws = reinterpret_cast<float*>(smem + m.dw);
  stage_weights<E>(a, wn);
  for (int i = threadIdx.x; i < a.S * NP; i += THREADS) dws[i] = 0.f;
  // The head rows of dskip get zeros (no memset of the whole tensor).
  const size_t head4 = (size_t)(a.T - a.W) * a.S / 4;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < (size_t)a.B * head4;
       i += (size_t)gridDim.x * THREADS) {
    const size_t b = i / head4, k = i % head4;
    reinterpret_cast<float4*>(a.dskip + b * a.T * a.S)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float gbar = *a.gbar;
  const int n3 = 3 * a.M;
  const long nrows = (long)a.B * a.W;
  const long tiles = (nrows + TM - 1) / TM;
  float db = 0.f;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();
    stage_rows<E>(a, tile * TM, A);
    __syncthreads();
    head<TC>(a, A, wn, Y);
    __syncthreads();
    if (threadIdx.x < TM) {
      const long row = tile * TM + threadIdx.x;
      float dy[NP];
      for (int j = 0; j < NP; ++j) dy[j] = 0.f;
      if (row < nrows)
        row_nll(Y + threadIdx.x * (NP + 1), a.bias, a.tgt[row], a.M, dy, a.mask[row] * gbar);
      for (int j = 0; j < NP; ++j) {
        const float v = j < n3 ? dy[j] : 0.f;
        Y[threadIdx.x * (NP + 1) + j] = v;
        D[threadIdx.x * (NP + PADK) + j] = to_e<E>(v);
      }
    }
    __syncthreads();
    if (threadIdx.x < NP)
      for (int r = 0; r < TM; ++r) db += Y[r * (NP + 1) + threadIdx.x];
    if constexpr (TC) {
      wgrad_tc(a, A, D, dws);
      dskip_tc(a, tile * TM, D, wn);
    } else {
      wgrad_fma(a, A, D, dws);
      dskip_fma(a, tile * TM, D, wn);
    }
  }
  __syncthreads();
  float* part = a.partial + (size_t)blockIdx.x * (a.S * NP + NP);
  for (int i = threadIdx.x; i < a.S * NP; i += THREADS) part[i] = dws[i];
  if (threadIdx.x < NP) part[a.S * NP + threadIdx.x] = db;
}

// grads = dw (S, 3M) | db (3M): each the sum of the blocks' partials in
// block order.
__global__ void reduce_grads(const float* partial, int blocks, int S, int M, float* grads) {
  const int n3 = 3 * M, total = S * n3 + n3;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const size_t src = i < S * n3 ? (size_t)(i / n3) * NP + i % n3 : (size_t)S * NP + (i - S * n3);
    float acc = 0.f;
    for (int b = 0; b < blocks; ++b) acc += partial[(size_t)b * (S * NP + NP) + src];
    grads[i] = acc;
  }
}

#define WN_TRY(expr)                  \
  do {                                \
    cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <bool TC>
static cudaError_t forward(const MolArgs& a, cudaStream_t s, int* launches) {
  const size_t bytes = carve(a.S, TC ? 2 : 4, 0).bytes;
  const long tiles = ((long)a.B * a.W + TM - 1) / TM;
  if (a.blocks < 1 || 3 * a.M > NP) return cudaErrorInvalidValue;
  WN_TRY(cudaFuncSetAttribute(fwd_rows<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes));
  fwd_rows<TC><<<a.blocks, THREADS, bytes, s>>>(a);
  WN_TRY(cudaGetLastError());
  ++*launches;
  sum_partials<<<1, 256, 0, s>>>(a.partial, (int)tiles, a.num);
  WN_TRY(cudaGetLastError());
  ++*launches;
  return cudaSuccess;
}

template <bool TC>
static cudaError_t backward(const MolArgs& a, cudaStream_t s, int* launches) {
  const size_t bytes = carve(a.S, TC ? 2 : 4, 1).bytes;
  if (a.blocks < 1 || 3 * a.M > NP) return cudaErrorInvalidValue;
  WN_TRY(cudaFuncSetAttribute(bwd_rows<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes));
  bwd_rows<TC><<<a.blocks, THREADS, bytes, s>>>(a);
  WN_TRY(cudaGetLastError());
  ++*launches;
  const int total = a.S * 3 * a.M + 3 * a.M;
  reduce_grads<<<(total + 255) / 256, 256, 0, s>>>(a.partial, a.blocks, a.S, a.M, a.grads);
  WN_TRY(cudaGetLastError());
  ++*launches;
  return cudaSuccess;
}

}  // namespace mol
}  // namespace wn

// Bytes of dynamic shared memory of a row kernel (post_mol.py `smem` must
// agree), the padded head width and the rows of a tile.
extern "C" long long wn_post_mol_smem(int S, int tc, int bwd) {
  return (long long)wn::mol::carve(S, tc ? 2 : 4, bwd).bytes;
}
extern "C" int wn_post_mol_np() { return wn::mol::NP; }
extern "C" int wn_post_mol_tile() { return wn::mol::TM; }

// Each returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_post_mol_fwd(const wn::mol::MolArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->tc ? wn::mol::forward<true>(*a, s, launches)
                     : wn::mol::forward<false>(*a, s, launches));
}

extern "C" int wn_post_mol_bwd(const wn::mol::MolArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->tc ? wn::mol::backward<true>(*a, s, launches)
                     : wn::mol::backward<false>(*a, s, launches));
}
