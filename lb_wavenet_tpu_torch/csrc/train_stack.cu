// Training stack: the L gated dilated layers over whole rows, forward and
// backward (the teacher-forced training step's dilated stack).
//
// Replaces the Pallas kernels of lb_wavenet_tpu/ops/pallas/train_stack.py:
// `_fwd_call` (bodies `_fwd_kernel`, `_fwd_kernel_tc`) and `_bwd_call`
// (bodies `_bwd_kernel`, `_bwd_kernel_tc`). The TPU grid step keeps a whole
// (T, C) row in VMEM across the layers, because layer l reads layer l-1 at
// t - d with d up to 512. At T = 13310 that row is 3.4 MB, more than one
// SM's shared memory, so here a device-wide barrier separates the layers:
// one launch per layer over (time tiles, batch), with the residual stream
// of every layer kept in global memory (x_all, L x B x T x C fp32), where
// the next launch reads its taps at t and t - d.
//
// Forward, per layer l (launch `fwd_layer`): pre = x(t) w_cur + x(t-d) w_prev
// + b (two sums added, or one 2C-deep sum with tapcat), z = tanh * sigmoid,
// stored in the compute dtype (z_all, L x B x T x G), and x_{l+1} = (x + z
// w_res) + b_res. Then one launch `fwd_skip` sums the skip projections of
// all layers per position in registers (skip = c_0 + c_1 + ..., c_l = z_l
// w_skip_l + b_skip_l, the TPU kernel's order): the (B, T, S) accumulator is
// written once instead of read and written per layer. L + 1 launches.
//
// Backward, layers in reverse: the layer inputs are READ from x_all (the TPU
// kernel reconstructs them backwards, x_l = x_{l+1} - z w_res - b_res; here
// storing them costs 0.8 GB at B = 8 and takes no rounding). Per layer:
// `bwd_dpre` recomputes pre and forms dpre from dz = g_skip w_skip^T +
// dx_{l+1} w_res^T; `bwd_dx` forms dx_l = (dx_{l+1} + dpre(t) w_cur^T) +
// dpre(t+d) w_prev^T (the adjoint shift reads another tile's dpre, hence its
// own launch); `wgrad_kernel` adds this layer's weight and bias gradients
// per position chunk. One `reduce_partials` at the end: 3 L + 1 launches.
// Operands of every product are rounded to the compute dtype, sums in fp32,
// as the TPU kernels' `mm`.
//
// Bound on an H100 at WaveNet-30, B = 8, T = 13310 (chip_smoke.py
// `train_stack_cost`, the function's own bytes and operations): 0.238 ms
// forward and 0.582 ms backward, set by the products (0.24 and 0.58 TFLOP
// at the bf16 tensor-core peak). What the port's design must also move (it
// keeps x_all, per-layer dpre and dx in device memory): ~2.6 GB forward
// (~0.77 ms at 3.35 TB/s) and ~7.8 GB backward (~2.3 ms).
//
// Two routes, chosen on the host before the launch from dtype and widths
// (ops/cuda/train_stack.py `route`; not a fallback):
//   * fp32 (tensor cores would be TF32, another function), and bf16 with a
//     width that is not a multiple of 16: the first-version kernels above,
//     CUDA-core FMAs in 4x4 register tiles, weights read through L1/L2.
//   * bf16 with C, G, S multiples of 16 (WaveNet-30): the tensor-core
//     kernels of namespace `tsc` below, for what held the first version
//     back (fp32 FMAs at ~15 and ~10 TFLOP/s, weight gradients in a third
//     launch per layer that read their operands again element by element,
//     g_skip read in fp32 three times a layer, dpre in fp32, transposed
//     weight copies each call):
//     - every product an mma.sync m16n8k16 bf16 -> fp32 on 64-position
//       tiles (mma.sync, not wgmma: the pair is bound by bytes, ~0.8 ms of
//       products against ~3 ms of bytes), one mma from zero per 16-deep
//       k-step added in fp32, so that the plain versions reproduce the sums
//       bit for bit on the card (train_stack.py `tc_mm`);
//     - a layer's weights staged once per block in shared memory (natural
//       layouts; ldmatrix reads them plain or transposed, so the backward
//       needs no transposed copies), persistent blocks walking tiles;
//     - forward: L launches `fwd_layer_tc` (pre, z, x_{l+1}) and one
//       `fwd_skip_tc` (the skip sum in registers over the layers on items
//       of 128 positions x 128 skip columns, the next two layers' w_skip,
//       z and b_skip loading while one multiplies): L + 1;
//     - backward: `gskip_prep` rounds g_skip to bf16 and sums db_skip once
//       per call; per layer `bwd_layer_tc` (pre, dz, dpre stored in bf16, db
//       from the unrounded dpre, and all the layer's weight gradients from
//       the tiles it holds, into a fixed slot per block; g_skip and w_skip
//       in passes of 256 skip columns, so any S fits) and `bwd_dx_tc` (the
//       adjoint shift); one ordered reduction `reduce_tc`, which also puts
//       the call's db_skip in every layer's slot: 2 L + 3 launches, no float
//       atomics, a rerun bit-identical;
//     - each launch after a tsc kernel is a programmatic dependent launch:
//       it stages its weights while the one before finishes (tsc::pdl).
//     ptxas and the measured times: PERF.md (chip_smoke.py prints both).
//
// Conditioning (the TPU kernels' `has_cond`: mel and/or speaker rows, cond
// (B, T, Cc') against w_cond (L, Cc', 2G)), on both routes, with no launch
// of its own:
//   * tensor cores: cond's k-steps extend the gate product, [x(t) | x(t-d)
//     | cond] @ [w_cur ; w_prev ; w_cond] (one chain with tapcat; else
//     cond continues the tap's chain), as the sampling kernels sum it; the
//     cond tile is staged beside the tap pair, w_cond's rows beside the
//     tap weights. The backward recomputes pre the same way, takes d w_cond
//     with d w_cur | d w_prev as one (2C + Cc') x 2G product into the
//     block's slot, and adds rnd(dpre) w_cond^T to an fp32 (B, T, Cc') d
//     cond straight from the mma fragments (read, add, write; the layers in
//     launch order, each element one owner per launch: no atomics);
//   * CUDA cores: the forward layer and bwd_dpre add cond w_cond after the
//     bias (the JAX order), d w_cond is one more weight-gradient job, and
//     bwd_dx adds rnd(dpre) w_cond^T to d cond.
// The extra work at Cc' = 64 and the mel recipe (B = 8, T = 9213): ~36
// GFLOP forward, ~72 backward (d w_cond and d cond; ~36 more to recompute
// pre), and d cond's fp32 read and write per layer.
//
// The sequence-parallel halo mask (the TPU kernels' `has_mask`: m (B, T)
// fp32, 0/1, parallel/halo.py), on both routes, as a nullable pointer (no
// launch and no instantiation of its own): the forward writes x_{l+1} =
// ((x + z w_res) + b_res) * m, so masked rows of the residual stream stay
// exactly 0 and x_all holds masked layer inputs (h0 arrives masked from the
// masked frontend, the TPU kernels' contract). The backward masks dx_{l+1}
// where the layer pass above WRITES it (bwd_dx, bwd_dx_tc for l > 0): every
// reader of dx_{l+1} (dz, d w_res, d b_res, dx_l) then takes dx_{l+1} * m,
// the TPU kernel's "dx_next * mask" on read, while dh0 leaves unmasked as
// there. The TPU kernel's re-mask of the reconstructed x_cur is the identity
// on x_all's masked rows. Multiplying by 1.0 is exact, so an all-ones mask
// gives the unmasked kernels' bits.
#include "tc_tile.cuh"
#include "tile.cuh"

namespace wn {

constexpr int TT = 32;  // time rows per block

// Stage rows [t0, t0 + TT) of a (B, n_t, K) fp32 tensor, shifted by `shift`
// (row t reads t - shift; zero outside [0, n_t)), feature-major into dst,
// rounded to T when RND.
template <typename T, bool RND>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int b, int t0,
                                      int n_t, int K, int shift) {
  for (int i = threadIdx.x; i < K * TT; i += NT) {
    const int k = i % K, r = i / K, t = t0 + r - shift;
    float v = 0.f;
    if (t >= 0 && t < n_t && t0 + r < n_t) v = src[((size_t)b * n_t + t) * K + k];
    dst[k * TT + r] = RND ? rnd<T>(v) : v;
  }
}

// Conditioned (wcd non-null), cond (B, T, Cc) fp32 adds cond w_cond to pre
// after the bias, the JAX order: ((tap sums) + b) + cond-sum.
template <typename T, bool TAPCAT>
__global__ void __launch_bounds__(NT)
fwd_layer(const float* __restrict__ x, float* __restrict__ x_next, T* __restrict__ z,
          const T* __restrict__ wc, const T* __restrict__ wp, const float* __restrict__ bias,
          const T* __restrict__ wr, const float* __restrict__ br, int n_t, int C, int G, int d,
          const float* __restrict__ cond, const T* __restrict__ wcd, int Cc,
          const float* __restrict__ mask) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;               // [C][TT] x(t)
  float* xr = xs + C * TT;      // [C][TT] rounded x(t)
  float* xp = xr + C * TT;      // [C][TT] rounded x(t - d)
  float* pre = xp + C * TT;     // [2G][TT]
  float* zr = pre + 2 * G * TT; // [G][TT] z in the compute dtype
  float* cs = zr + G * TT;      // [Cc][TT] rounded cond (conditioned)
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  stage<T, false>(xs, x, b, t0, n_t, C, 0);
  stage<T, true>(xp, x, b, t0, n_t, C, d);
  if (wcd) stage<T, true>(cs, cond, b, t0, n_t, Cc, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < C * TT; i += NT) xr[i] = rnd<T>(xs[i]);
  __syncthreads();
  tile_mm2<TT, TAPCAT>(xr, wc, C, xp, wp, C, 2 * G, [&](int t, int n, float s1, float s2) {
    pre[n * TT + t] = (s1 + s2) + bias[n];
  });
  if (wcd) {  // same N: each (t, n) stays with its thread
    tile_mm2<TT, false>(cs, wcd, Cc, cs, (const T*)nullptr, 0, 2 * G,
                        [&](int t, int n, float s, float) { pre[n * TT + t] += s; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * TT; i += NT) {
    const int g = i / TT, t = i % TT;
    const float v = rnd<T>(tanhf(pre[i]) * sigmoidf(pre[G * TT + i]));
    zr[i] = v;
    if (t0 + t < n_t) z[((size_t)b * n_t + t0 + t) * G + g] = T(v);
  }
  __syncthreads();
  if (x_next == nullptr) return;  // the last layer's output feeds nothing
  tile_mm2<TT, false>(zr, wr, G, zr, (const T*)nullptr, 0, C, [&](int t, int c, float s, float) {
    if (t0 + t >= n_t) return;
    const size_t row = (size_t)b * n_t + t0 + t;
    const float v = (xs[c * TT + t] + s) + br[c];
    x_next[row * C + c] = mask ? v * mask[row] : v;
  });
}

constexpr int SKIP_J = 4;  // register tiles per thread: S <= 4 * NT * 4 / TT = 512

template <typename T>
__global__ void __launch_bounds__(NT)
fwd_skip(const T* __restrict__ z_all, const T* __restrict__ ws, const float* __restrict__ bs,
         float* __restrict__ skip, int n_t, int B, int L, int G, int S) {
  extern __shared__ __align__(16) float sm[];
  float* zs = sm;  // [G][TT]
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int nq = S / 4, items = (TT / 4) * nq;
  float acc[SKIP_J][4][4];
  for (int l = 0; l < L; ++l) {
    const T* z = z_all + (size_t)l * B * n_t * G;
    __syncthreads();
    for (int i = threadIdx.x; i < G * TT; i += NT) {
      const int g = i % G, r = i / G;
      zs[g * TT + r] = t0 + r < n_t ? to_f(z[((size_t)b * n_t + t0 + r) * G + g]) : 0.f;
    }
    __syncthreads();
    const T* w = ws + (size_t)l * G * S;
#pragma unroll
    for (int j = 0; j < SKIP_J; ++j) {
      const int item = threadIdx.x + j * NT;
      if (item >= items) break;
      const int n0 = (item % nq) * 4, r0 = (item / nq) * 4;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[i][k] = 0.f;
#pragma unroll 4
      for (int g = 0; g < G; ++g)
        fma16(s, *reinterpret_cast<const float4*>(zs + g * TT + r0), load4(w + (size_t)g * S + n0));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float c = s[i][k] + bs[l * S + n0 + k];
          acc[j][i][k] = l == 0 ? c : acc[j][i][k] + c;
        }
    }
  }
#pragma unroll
  for (int j = 0; j < SKIP_J; ++j) {
    const int item = threadIdx.x + j * NT;
    if (item >= items) break;
    const int n0 = (item % nq) * 4, r0 = (item / nq) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + r0 + i < n_t)
        *reinterpret_cast<float4*>(skip + ((size_t)b * n_t + t0 + r0 + i) * S + n0) =
            make_float4(acc[j][i][0], acc[j][i][1], acc[j][i][2], acc[j][i][3]);
  }
}

template <typename T, bool TAPCAT>
__global__ void __launch_bounds__(NT)
bwd_dpre(const float* __restrict__ x, const float* __restrict__ g_skip,
         const float* __restrict__ dx_next, float* __restrict__ dpre, const T* __restrict__ wc,
         const T* __restrict__ wp, const float* __restrict__ bias, const T* __restrict__ wsT,
         const T* __restrict__ wrT, int n_t, int C, int G, int S, int d,
         const float* __restrict__ cond, const T* __restrict__ wcd, int Cc) {
  extern __shared__ __align__(16) float sm[];
  float* xr = sm;               // [C][TT] rounded x(t)
  float* xp = xr + C * TT;      // [C][TT] rounded x(t - d)
  float* act = xp + C * TT;     // [2G][TT] pre, then tanh | sigmoid
  float* gs = act + 2 * G * TT; // [S][TT] rounded g_skip
  float* dn = gs + S * TT;      // [C][TT] rounded dx_{l+1}
  float* cs = dn + C * TT;      // [Cc][TT] rounded cond (conditioned)
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  stage<T, true>(xr, x, b, t0, n_t, C, 0);
  stage<T, true>(xp, x, b, t0, n_t, C, d);
  stage<T, true>(gs, g_skip, b, t0, n_t, S, 0);
  stage<T, true>(dn, dx_next, b, t0, n_t, C, 0);
  if (wcd) stage<T, true>(cs, cond, b, t0, n_t, Cc, 0);
  __syncthreads();
  tile_mm2<TT, TAPCAT>(xr, wc, C, xp, wp, C, 2 * G, [&](int t, int n, float s1, float s2) {
    act[n * TT + t] = (s1 + s2) + bias[n];
  });
  if (wcd) {  // pre as the forward layer forms it
    tile_mm2<TT, false>(cs, wcd, Cc, cs, (const T*)nullptr, 0, 2 * G,
                        [&](int t, int n, float s, float) { act[n * TT + t] += s; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * TT; i += NT) {
    act[i] = tanhf(act[i]);
    act[G * TT + i] = sigmoidf(act[G * TT + i]);
  }
  __syncthreads();
  tile_mm2<TT, false>(gs, wsT, S, dn, wrT, C, G, [&](int t, int g, float s1, float s2) {
    if (t0 + t >= n_t) return;
    const float dz = s1 + s2, th = act[g * TT + t], sg = act[(G + g) * TT + t];
    float* out = dpre + ((size_t)b * n_t + t0 + t) * 2 * G;
    out[g] = __fmul_rn(__fmul_rn(dz, sg), __fsub_rn(1.f, __fmul_rn(th, th)));
    out[G + g] = __fmul_rn(__fmul_rn(__fmul_rn(dz, th), sg), __fsub_rn(1.f, sg));
  });
}

// Conditioned (dcond non-null) it also adds the layer's rnd(dpre) w_cond^T to
// d cond (B, T, Cc), summed over the layers in launch order. Masked (mask
// non-null: every layer but the first) dx_l is written times m.
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_dx(const float* __restrict__ dpre, const float* __restrict__ dx_next,
       float* __restrict__ dx, const T* __restrict__ wcT, const T* __restrict__ wpT, int n_t,
       int C, int G, int d, float* __restrict__ dcond, const T* __restrict__ wcdT, int Cc,
       const float* __restrict__ mask) {
  extern __shared__ __align__(16) float sm[];
  float* dc = sm;               // [2G][TT] rounded dpre(t)
  float* dl = dc + 2 * G * TT;  // [2G][TT] rounded dpre(t + d)
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  stage<T, true>(dc, dpre, b, t0, n_t, 2 * G, 0);
  stage<T, true>(dl, dpre, b, t0, n_t, 2 * G, -d);
  __syncthreads();
  tile_mm2<TT, false>(dc, wcT, 2 * G, dl, wpT, 2 * G, C, [&](int t, int c, float s1, float s2) {
    if (t0 + t >= n_t) return;
    const size_t row = (size_t)b * n_t + t0 + t, at = row * C + c;
    const float v = (dx_next[at] + s1) + s2;
    dx[at] = mask ? v * mask[row] : v;
  });
  if (dcond == nullptr) return;
  tile_mm2<TT, false>(dc, wcdT, 2 * G, dc, (const T*)nullptr, 0, Cc,
                      [&](int t, int n, float s, float) {
                        if (t0 + t >= n_t) return;
                        const size_t at = ((size_t)b * n_t + t0 + t) * Cc + n;
                        dcond[at] = dcond[at] + s;
                      });
}

// ---- bf16 on tensor cores ---------------------------------------------------
//
// The route of bf16 archs whose C, G and S are multiples of 16 and whose
// tiles fit in shared memory (ops/cuda/train_stack.py `route`). Same function
// and roundings as the kernels above: operands rounded to bf16, z stored in
// bf16, fp32 sums, tapcat as one 2C-deep sum. Every product is an
// mma.sync.m16n8k16 bf16 -> fp32 (within a 16-deep step the tensor core's
// sum, across steps fp32 in order). A block of 8 warps walks tiles of TP = 64
// positions of one batch row (persistent: tile i on block i mod grid); a
// layer's weights are staged in shared memory once per block, in their
// natural layouts with rows padded by 8 elements, and read by ldmatrix, plain
// for one operand order and .trans for the other, so the transposed products
// of the backward read the same staged tiles. Activations are position-major
// bf16 tiles [TP][width + 8], loaded by cp.async (fp32 ones through
// registers, rounded on the way). The backward layer pass, one block per SM
// for its ~184 KB of shared memory, runs 16 warps.
namespace tsc {

using bf16 = __nv_bfloat16;
constexpr int TP = 64;           // positions per tile
constexpr int NW = 8;            // warps per block
constexpr int NTC = NW * 32;     // threads per block
constexpr int RG = TP / 16;      // 16-row groups of a tile
constexpr int PAD = 8;           // bf16 elements of row padding
constexpr int SC = 256;          // skip columns per pass of fwd_skip_tc
constexpr int NWB = 16;          // warps per block of the backward layer pass and skip pass
constexpr int NTB = NWB * 32;

using namespace tct;

// Programmatic dependent launch: let the next launch on the stream start
// (and stage its weights) now; wait until the launch before this one has
// finished and its writes are visible. Every tsc kernel reads and writes
// activations only after pdl().
__device__ __forceinline__ void pdl() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The same for 4 bytes.
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sa(dst)), "l"(src) : "memory");
}
// Wait for this thread's copies, then for the block.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// The rounded tap pair of a tile: rows [t0, t0 + TP) of batch row b of an
// fp32 (B, T, C) tensor at t (columns 0..C-1 of dst [TP][ld]) and at t - d
// (columns C..2C-1), 0 outside [0, T), in bf16. Each thread has U loads in
// flight before it stores.
__device__ __forceinline__ void stage_pair(bf16* dst, int ld, const float* src, int b, int t0,
                                           int T, int C, int d) {
  constexpr int U = 4;
  const int kq = C / 4, n = TP * kq;
  for (int i0 = threadIdx.x; i0 < 2 * n; i0 += U * blockDim.x) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x, j = i % n, r = j / kq, k = (j % kq) * 4;
      const int t = t0 + r - (i < n ? 0 : d);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < 2 * n && t0 + r < T && t >= 0 && t < T)
        v[u] = *reinterpret_cast<const float4*>(src + ((size_t)b * T + t) * C + k);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x, j = i % n, r = j / kq, k = (j % kq) * 4;
      if (i >= 2 * n) break;
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(dst + r * ld + (i < n ? 0 : C) + k);
      o[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
      o[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
    }
  }
}

// ROWS rows of a (B, T, K) tensor (as stage_pair's, row t read from t -
// shift, no rounding), columns k0..k0+n-1 (all if n = 0), into dst
// [ROWS][ld] by asynchronous 16-byte copies.
template <typename E, int ROWS = TP>
__device__ __forceinline__ void stage_rows(E* dst, int ld, const E* src, int b, int t0, int T,
                                           int K, int shift, int k0 = 0, int n = 0) {
  constexpr int V = 16 / sizeof(E);
  const int kq = (n ? n : K) / V;
  for (int i = threadIdx.x; i < ROWS * kq; i += blockDim.x) {
    const int r = i / kq, k = (i % kq) * V, t = t0 + r - shift;
    const bool ok = t0 + r < T && t >= 0 && t < T;
    cp16(dst + r * ld + k, ok ? src + ((size_t)b * T + t) * K + k0 + k : src, ok);
  }
}

// A rows x cols block of a bf16 matrix (row stride src_ld) into dst [rows][ld]
// by asynchronous copies.
__device__ __forceinline__ void stage_w(bf16* dst, int ld, const bf16* src, int rows, int cols,
                                        int src_ld) {
  const int cq = cols / 8;
  for (int i = threadIdx.x; i < rows * cq; i += blockDim.x) {
    const int r = i / cq, c = (i % cq) * 8;
    cp16(dst + r * ld + c, src + (size_t)r * src_ld + c, true);
  }
}

// The valid rows of a [TP][ld] bf16 tile out to a (B, T, K) tensor.
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* s, int ld, int b, int t0,
                                           int T, int K) {
  const int kq = K / 8;
  for (int i = threadIdx.x; i < TP * kq; i += blockDim.x) {
    const int r = i / kq, k = (i % kq) * 8;
    if (t0 + r < T)
      *reinterpret_cast<uint4*>(dst + ((size_t)b * T + t0 + r) * K + k) =
          *reinterpret_cast<const uint4*>(s + r * ld + k);
  }
}

// pre = [x(t) | x(t-d) | cond] @ [w_cur ; w_prev ; w_cond] + b of a 16-row
// strip at the tanh columns n0..n0+15 (p[0], p[1]) and the sigmoid columns
// G + n0.. (p[2], p[3]), bias added: one (2C + Cc)-deep sum with TAPCAT,
// else (x(t) w_cur + [x(t-d) | cond] [w_prev ; w_cond]) + b (Cc = 0:
// unconditioned). cond's k-steps continue the chain, as in the sampling
// kernels (ar_tc.cuh).
template <bool TAPCAT>
__device__ __forceinline__ void gate_pre(float (&p)[4][4], const bf16* xa, int lda,
                                         const bf16* wa, int ldw, const float* bias, int r0,
                                         int n0, int C, int G, int Cc) {
  float q[4][4];
  zero(p);
  zero(q);
  auto step = [&](float (&d)[4][4], int ks) {
    uint32_t a[4], bt[4], bs[4];
    lda_rm(a, xa, lda, r0, ks * 16);
    ldb_kn(bt, wa, ldw, n0, ks * 16);
    ldb_kn(bs, wa, ldw, G + n0, ks * 16);
    mma_add(d[0], a, bt[0], bt[1]);
    mma_add(d[1], a, bt[2], bt[3]);
    mma_add(d[2], a, bs[0], bs[1]);
    mma_add(d[3], a, bs[2], bs[3]);
  };
  for (int ks = 0; ks < C / 16; ++ks) step(p, ks);
  for (int ks = C / 16; ks < (2 * C + Cc) / 16; ++ks) step(TAPCAT ? p : q, ks);
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = (j < 2 ? n0 : G + n0) + (j & 1) * 8 + cq + (v & 1);
      p[j][v] = (TAPCAT ? p[j][v] : p[j][v] + q[j][v]) + bias[n];
    }
}

struct FwdTc {
  const float* x;  // (B, T, C) layer input
  float* x_next;   // (B, T, C), or null for the last layer
  bf16* z;         // (B, T, G) out
  const bf16 *wc, *wp, *wr;
  const float *bias, *br;
  int B, T, C, G, d;
  const bf16* cond;  // (B, T, Cc) rounded, or null: unconditioned
  const bf16* wcd;   // (Cc, 2G) this layer's w_cond
  int Cc;
  const float* mask; // (B, T) halo mask, or null: unmasked
};

inline size_t fwd_tc_smem(int C, int G, int Cc) {
  const size_t K = 2 * C + Cc;
  return 2 * (K * (2 * G + PAD) + (size_t)G * (C + PAD) + TP * (K + PAD) + TP * (G + PAD));
}

// One layer: z = tanh(pre_t) sigmoid(pre_s) stored in bf16, x_{l+1} = (x +
// z w_res) + b_res (times m[b, t], masked).
template <bool TAPCAT>
__global__ void __launch_bounds__(NTC) fwd_layer_tc(FwdTc a) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int C = a.C, G = a.G, T = a.T, K = 2 * C + a.Cc;
  const int ldw = 2 * G + PAD, ldr = C + PAD, lda = K + PAD, ldz = G + PAD;
  bf16* wa = reinterpret_cast<bf16*>(smraw);  // [K][2G] [w_cur ; w_prev (; w_cond)]
  bf16* wr = wa + K * ldw;                     // [G][C]
  bf16* xa = wr + G * ldr;                     // [TP][K] rounded x(t) | x(t-d) (| cond)
  bf16* zs = xa + TP * lda;                    // [TP][G] z
  stage_w(wa, ldw, a.wc, C, 2 * G, 2 * G);
  stage_w(wa + C * ldw, ldw, a.wp, C, 2 * G, 2 * G);
  if (a.Cc) stage_w(wa + 2 * C * ldw, ldw, a.wcd, a.Cc, 2 * G, 2 * G);
  if (a.x_next) stage_w(wr, ldr, a.wr, G, C, C);
  pdl();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  const int r0 = (warp % RG) * 16, half = warp / RG;
  const int per_b = (T + TP - 1) / TP;
  for (int tile = blockIdx.x; tile < a.B * per_b; tile += gridDim.x) {
    const int b = tile / per_b, t0 = (tile % per_b) * TP;
    __syncthreads();
    stage_pair(xa, lda, a.x, b, t0, T, C, a.d);
    if (a.Cc) stage_rows(xa + 2 * C, lda, a.cond, b, t0, T, a.Cc, 0);
    staged();
    for (int gc = half; gc < G / 16; gc += NW / RG) {
      float p[4][4];
      gate_pre<TAPCAT>(p, xa, lda, wa, ldw, a.bias, r0, gc * 16, C, G, a.Cc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = r0 + g + (v >> 1) * 8, n = gc * 16 + j * 8 + cq + (v & 1);
          const float zv = tanhf(p[j][v]) * sigmoidf(p[2 + j][v]);
          zs[r * ldz + n] = __float2bfloat16_rn(t0 + r < T ? zv : 0.f);
        }
    }
    __syncthreads();
    store_rows(a.z, zs, ldz, b, t0, T, G);
    if (a.x_next == nullptr) continue;
    for (int cc = half; cc < C / 16; cc += NW / RG) {
      float2 xv[2][2];  // x(t), in flight over the product
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = t0 + r0 + g + h * 8 < T ? r0 + g + h * 8 : 0;
          xv[j][h] = *reinterpret_cast<const float2*>(
              a.x + ((size_t)b * T + t0 + r) * C + cc * 16 + j * 8 + cq);
        }
      float acc[2][4];
      zero(acc);
      for (int ks = 0; ks < G / 16; ++ks) {
        uint32_t av[4], bv[4];
        lda_rm(av, zs, ldz, r0, ks * 16);
        ldb_kn(bv, wr, ldr, cc * 16, ks * 16);
        mma2(acc, av, bv);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + g + h * 8, n = cc * 16 + j * 8 + cq;
          if (t0 + r >= T) continue;
          const size_t row = (size_t)b * T + t0 + r;
          float2 v = make_float2((xv[j][h].x + acc[j][2 * h]) + a.br[n],
                                 (xv[j][h].y + acc[j][2 * h + 1]) + a.br[n + 1]);
          if (a.mask) {
            const float m = a.mask[row];
            v = make_float2(v.x * m, v.y * m);
          }
          *reinterpret_cast<float2*>(a.x_next + row * C + n) = v;
        }
    }
  }
}

// The skip pass's items: TPS positions x SCS skip columns; STAGES layers'
// operands in flight.
constexpr int TPS = 128, SCS = 128, RGS = TPS / 16, STAGES = 3;
constexpr int SKIP_ITEMS = RGS * (SCS / 16) / NWB;  // 16 x 16 output blocks per warp
static_assert(NWB % RGS == 0, "a warp's skip blocks share one row group");

inline size_t skip_tc_smem(int G, int S) {
  const int sc = S < SCS ? S : SCS;
  return STAGES * (2 * ((size_t)G * (sc + PAD) + TPS * (G + PAD)) + 4 * (size_t)sc);
}

// Work items of the skip pass: position tiles x column passes.
inline int skip_tc_items(int B, int T, int S) {
  return B * ((T + TPS - 1) / TPS) * ((S + SCS - 1) / SCS);
}

// skip = c_0 + c_1 + ..., c_l = z_l w_skip_l + b_skip_l, per item of TPS
// positions and SCS skip columns (any S that is a multiple of 16). The
// running sum stays in registers, each element with the same thread at
// every layer; the operands of layers l + 1 .. l + STAGES - 1 (w_skip
// columns, z tile, b_skip columns) load by cp.async while layer l
// multiplies. 16 warps, SKIP_ITEMS sums each (at 8 warps of twice the sums,
// 221 registers held one block of 8 warps per SM).
__global__ void __launch_bounds__(NTB)
fwd_skip_tc(const bf16* __restrict__ z_all, const bf16* __restrict__ ws,
            const float* __restrict__ bs, float* __restrict__ skip, int B, int T, int L, int G,
            int S) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int scs = S < SCS ? S : SCS, ldk = scs + PAD, ldz = G + PAD;
  // Buffer i: w_skip columns [G][SCS], z tile [TPS][G], b_skip columns [SCS].
  const size_t stage_bytes = 2 * ((size_t)G * ldk + TPS * ldz) + 4 * (size_t)scs;
  auto wsm = [&](int i) { return reinterpret_cast<bf16*>(smraw + i * stage_bytes); };
  auto zsm = [&](int i) { return wsm(i) + G * ldk; };
  auto bsm = [&](int i) { return reinterpret_cast<float*>(zsm(i) + TPS * ldz); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  // A warp's SKIP_ITEMS output blocks share its row group (NWB % RGS == 0),
  // so each k-step loads their z rows once.
  const int r0 = (warp % RGS) * 16;
  const int per_b = (T + TPS - 1) / TPS, passes = (S + SCS - 1) / SCS;
  pdl();
  for (int it = blockIdx.x; it < B * per_b * passes; it += gridDim.x) {
    const int tile = it / passes, b = tile / per_b, t0 = (tile % per_b) * TPS;
    const int s0 = (it % passes) * SCS;
    const int sc = S - s0 < SCS ? S - s0 : SCS;
    // Layer l's operands into buffer l % STAGES, one commit group per layer
    // (empty past the last layer, so that the wait below counts alike).
    auto stage = [&](int l) {
      if (l < L) {
        const int i = l % STAGES;
        stage_w(wsm(i), ldk, ws + (size_t)l * G * S + s0, G, sc, S);
        stage_rows<bf16, TPS>(zsm(i), ldz, z_all + (size_t)l * B * T * G, b, t0, T, G, 0);
        for (int c = threadIdx.x; c < sc; c += NTB) cp4(bsm(i) + c, bs + l * S + s0 + c);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    float tot[SKIP_ITEMS][2][4];
    __syncthreads();  // the last item's readers are done with the buffers
    for (int l = 0; l < STAGES - 1; ++l) stage(l);
    for (int l = 0; l < L; ++l) {
      stage(l + STAGES - 1);
      asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 1) : "memory");
      __syncthreads();
      const bf16* w = wsm(l % STAGES);
      const bf16* z = zsm(l % STAGES);
      const float* bl = bsm(l % STAGES);
      float acc[SKIP_ITEMS][2][4];
#pragma unroll
      for (int k = 0; k < SKIP_ITEMS; ++k) zero(acc[k]);
      for (int ks = 0; ks < G / 16; ++ks) {
        uint32_t av[4];
        lda_rm(av, z, ldz, r0, ks * 16);
#pragma unroll
        for (int k = 0; k < SKIP_ITEMS; ++k) {
          const int n0 = (warp / RGS + k * (NWB / RGS)) * 16;
          if (n0 >= sc) break;
          uint32_t bv[4];
          ldb_kn(bv, w, ldk, n0, ks * 16);
          mma2(acc[k], av, bv);
        }
      }
#pragma unroll
      for (int k = 0; k < SKIP_ITEMS; ++k) {
        const int n0 = (warp / RGS + k * (NWB / RGS)) * 16;
        if (n0 >= sc) break;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float c = acc[k][j][v] + bl[n0 + j * 8 + cq + (v & 1)];
            tot[k][j][v] = l == 0 ? c : tot[k][j][v] + c;
          }
      }
      __syncthreads();  // buffer l % STAGES is free for layer l + STAGES
    }
#pragma unroll
    for (int k = 0; k < SKIP_ITEMS; ++k) {
      const int n0 = (warp / RGS + k * (NWB / RGS)) * 16;
      if (n0 >= sc) break;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + g + h * 8;
          if (t0 + r < T)
            *reinterpret_cast<float2*>(skip + ((size_t)b * T + t0 + r) * S + s0 + n0 + j * 8 +
                                       cq) = make_float2(tot[k][j][2 * h], tot[k][j][2 * h + 1]);
        }
    }
  }
}

struct BwdTc {
  const float* x;    // (B, T, C) layer input
  const bf16* z;     // (B, T, G)
  const bf16* gs;    // (B, T, S) g_skip rounded
  const float* dxn;  // (B, T, C) dx_{l+1}
  bf16* dpre;        // (B, T, 2G) out, rounded
  float* part;       // (grid, nw) this layer's gradient pack, one slot per block
  const bf16 *wc, *wp, *wr, *ws;
  const float* bias;
  int B, T, C, G, S, d, nw;
  const bf16* cond;  // (B, T, Cc) rounded, or null: unconditioned
  const bf16* wcd;   // (Cc, 2G) this layer's w_cond
  float* dcond;      // (B, T, Cc) d cond, added to (read, add, write)
  int Cc;
};

inline size_t bwd_tc_smem(int C, int G, int S, int Cc) {
  const int sc = S < SC ? S : SC;
  const size_t K = 2 * C + Cc;
  return 2 * (K * (2 * G + PAD) + (size_t)G * (C + PAD) + (size_t)G * (sc + PAD) +
              (size_t)TP * (K + G + C + sc + 2 * G + 5 * PAD)) +
         4 * ((size_t)TP * (C + (S > SC ? G : 0)) + RG * 2 * G + 2 * G + C);
}

// out[m][n] (row stride ldo) of a block's gradient slot += A^T B for the 16 x
// 16 block (m0, n0) over the tile's TP positions (A [TP][la] and B [TP][lb]
// position-major in shared memory); a block's first tile stores.
__device__ __forceinline__ void wgrad_item(float* out, int ldo, const bf16* A, int la,
                                           const bf16* Bm, int lb, int m0, int n0, bool first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  float2* q[2][2];
  float2 w[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q[j][h] = reinterpret_cast<float2*>(out + (size_t)(m0 + g + h * 8) * ldo + n0 + j * 8 + cq);
      w[j][h] = first ? make_float2(0.f, 0.f) : *q[j][h];  // in flight over the mma
    }
  float acc[2][4];
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < TP / 16; ++ks) {
    uint32_t av[4], bv[4];
    lda_km(av, A, la, m0, ks * 16);
    ldb_kn(bv, Bm, lb, n0, ks * 16);
    mma2(acc, av, bv);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *q[j][h] = first ? make_float2(acc[j][2 * h], acc[j][2 * h + 1])
                       : make_float2(w[j][h].x + acc[j][2 * h], w[j][h].y + acc[j][2 * h + 1]);
}

// One layer of the backward but the adjoint shift: per tile, pre again, dz =
// gs w_skip^T + rnd(dx_{l+1}) w_res^T (two sums added), dpre (stored
// rounded), and the layer's weight and bias gradients from the same staged
// tiles: [x(t) | x(t-d) | cond]^T dpre (dw_cur | dw_prev | dw_cond as one
// (2C + Cc) x 2G product), z^T rnd(dx_{l+1}), z^T gs, db = colsum(dpre)
// unrounded, db_res = colsum(dx_{l+1}). Block i adds its tiles in order
// into its own slot part[i] (its first tile stores): no atomics, a rerun is
// bit-identical. Conditioned, pre takes cond's k-steps (gate_pre) and the
// tile's rnd(dpre) w_cond^T is added to d cond straight from the mma
// fragments (read, add, write: one owner per element and launch, the
// layers in launch order; an fp32 tile of it would not fit in shared
// memory beside the others).
// PASSES (for S > SC) takes gs and w_skip in passes of SC skip columns
// (w_skip then staged per pass and tile): gs w_skip^T goes on over the
// passes in k-step order in an fp32 tile, z^T gs is taken pass by pass. The
// one-pass instantiation keeps that sum in registers (the passes' code costs
// it registers it has not got at 512 threads). COND instantiates the
// conditioned pass apart, so that the unconditioned one keeps its
// registers (the d cond items' live values cost it spills).
template <bool TAPCAT, bool PASSES, bool COND>
__global__ void __launch_bounds__(NTB) bwd_layer_tc(BwdTc a) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int Cc = COND ? a.Cc : 0;
  const int C = a.C, G = a.G, S = a.S, T = a.T, K = 2 * C + Cc;
  constexpr bool one_pass = !PASSES;
  const int scp = one_pass ? S : SC;  // skip columns per pass
  const int ldw = 2 * G + PAD, ldr = C + PAD, ldk = scp + PAD;
  const int lda = K + PAD, ldz = G + PAD, ldn = C + PAD, ldg = scp + PAD, ldp = 2 * G + PAD;
  bf16* wa = reinterpret_cast<bf16*>(smraw);  // [K][2G] [w_cur ; w_prev (; w_cond)]
  bf16* wr = wa + K * ldw;                     // [G][C]
  bf16* wsk = wr + G * ldr;                    // [G][scp] a pass's w_skip columns
  bf16* xa = wsk + G * ldk;                    // [TP][K] rounded x(t) | x(t-d) (| cond)
  bf16* zs = xa + TP * lda;                    // [TP][G]
  bf16* dn = zs + TP * ldz;                    // [TP][C] rounded dx_{l+1}
  bf16* gsm = dn + TP * ldn;                   // [TP][scp] a pass's gs columns
  bf16* dp = gsm + TP * ldg;                   // [TP][2G] rounded dpre
  float* dnf = reinterpret_cast<float*>(dp + TP * ldp);  // [TP][C] dx_{l+1}
  float* dzf = dnf + TP * C;                   // [TP][G] gs w_skip^T over passes (S > SC)
  float* dbt = dzf + (one_pass ? 0 : TP * G);  // [RG][2G] row-group sums
  float* db = dbt + RG * 2 * G;                // [2G] the block's db
  float* dbr = db + 2 * G;                     // [C] the block's db_res
  stage_w(wa, ldw, a.wc, C, 2 * G, 2 * G);
  stage_w(wa + C * ldw, ldw, a.wp, C, 2 * G, 2 * G);
  if (COND) stage_w(wa + 2 * C * ldw, ldw, a.wcd, Cc, 2 * G, 2 * G);
  stage_w(wr, ldr, a.wr, G, C, C);
  if (one_pass) stage_w(wsk, ldk, a.ws, G, S, S);
  for (int i = threadIdx.x; i < 2 * G + C; i += NTB) db[i] = 0.f;  // db and dbr
  pdl();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  const int rg = warp % RG, r0 = rg * 16, half = warp / RG;
  const int o_db = K * 2 * G, o_dwr = o_db + 2 * G, o_dbr = o_dwr + G * C;
  const int o_dws = o_dbr + C;
  float* part = a.part + (size_t)blockIdx.x * a.nw;
  const int per_b = (T + TP - 1) / TP;
  for (int tile = blockIdx.x; tile < a.B * per_b; tile += gridDim.x) {
    const int b = tile / per_b, t0 = (tile % per_b) * TP;
    const bool first = tile == (int)blockIdx.x;
    __syncthreads();
    stage_rows(zs, ldz, a.z, b, t0, T, G, 0);
    stage_rows(dnf, C, a.dxn, b, t0, T, C, 0);
    stage_pair(xa, lda, a.x, b, t0, T, C, a.d);
    if (COND) stage_rows(xa + 2 * C, lda, a.cond, b, t0, T, Cc, 0);
    // The skip columns in passes; the last pass's gs stays staged for the
    // gate pass (one pass) and the weight gradients below.
    int s0 = 0, sc = scp;
    for (;; s0 += scp) {
      sc = S - s0 < scp ? S - s0 : scp;
      if (s0 > 0) __syncthreads();  // the last pass's readers are done
      if (!one_pass) stage_w(wsk, ldk, a.ws + s0, G, sc, S);
      stage_rows(gsm, ldg, a.gs, b, t0, T, S, 0, s0, sc);
      staged();
      if (one_pass) break;
      // dzf += gs w_skip^T of the pass, each element with the thread that
      // reads it in the gate pass.
      for (int gc = half; gc < G / 16; gc += NWB / RG) {
        const int n0 = gc * 16;
        float acc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[j][v] = s0 ? dzf[(r0 + g + (v >> 1) * 8) * G + n0 + j * 8 + cq + (v & 1)] : 0.f;
        for (int ks = 0; ks < sc / 16; ++ks) {
          uint32_t av[4], bv[4];
          lda_rm(av, gsm, ldg, r0, ks * 16);
          ldb_nk(bv, wsk, ldk, n0, ks * 16);
          mma2(acc, av, bv);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            dzf[(r0 + g + (v >> 1) * 8) * G + n0 + j * 8 + cq + (v & 1)] = acc[j][v];
      }
      if (s0 + sc == S) break;
      for (int item = warp; item < (G / 16) * (sc / 16); item += NWB)
        wgrad_item(part + o_dws + s0, S, zs, ldz, gsm, ldg, (item / (sc / 16)) * 16,
                   (item % (sc / 16)) * 16, first);
    }
    // dx_{l+1} rounded for the products; db_res from it unrounded (rows past
    // T were staged as 0).
    for (int i = threadIdx.x; i < TP * C / 2; i += NTB) {
      const int r = i / (C / 2), c = (i % (C / 2)) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dn + r * ldn + c) =
          __floats2bfloat162_rn(dnf[r * C + c], dnf[r * C + c + 1]);
    }
    for (int c = threadIdx.x; c < C; c += NTB) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < TP; ++r) s += dnf[r * C + c];
      dbr[c] += s;
    }
    __syncthreads();
    for (int gc = half; gc < G / 16; gc += NWB / RG) {
      const int n0 = gc * 16;
      float p[4][4], dzs[2][4], dzc[2][4];
      gate_pre<TAPCAT>(p, xa, lda, wa, ldw, a.bias, r0, n0, C, G, Cc);
      if (one_pass) {
        zero(dzs);
        for (int ks = 0; ks < S / 16; ++ks) {
          uint32_t av[4], bv[4];
          lda_rm(av, gsm, ldg, r0, ks * 16);
          ldb_nk(bv, wsk, ldk, n0, ks * 16);
          mma2(dzs, av, bv);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            dzs[j][v] = dzf[(r0 + g + (v >> 1) * 8) * G + n0 + j * 8 + cq + (v & 1)];
      }
      zero(dzc);
      for (int ks = 0; ks < C / 16; ++ks) {
        uint32_t av[4], bv[4];
        lda_rm(av, dn, ldn, r0, ks * 16);
        ldb_nk(bv, wr, ldr, n0, ks * 16);
        mma2(dzc, av, bv);
      }
      float st[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, ss[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = r0 + g + (v >> 1) * 8, n = n0 + j * 8 + cq + (v & 1);
          const float th = tanhf(p[j][v]), sg = sigmoidf(p[2 + j][v]);
          const float dz = dzs[j][v] + dzc[j][v];
          float dt = __fmul_rn(__fmul_rn(dz, sg), __fsub_rn(1.f, __fmul_rn(th, th)));
          float ds = __fmul_rn(__fmul_rn(__fmul_rn(dz, th), sg), __fsub_rn(1.f, sg));
          if (t0 + r >= T) dt = ds = 0.f;
          dp[r * ldp + n] = __float2bfloat16_rn(dt);
          dp[r * ldp + G + n] = __float2bfloat16_rn(ds);
          st[j][v & 1] += dt;
          ss[j][v & 1] += ds;
        }
      // db: the strip's column sums of the unrounded dpre over its 16 rows.
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float vt = st[j][e], vs = ss[j][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            vt += __shfl_xor_sync(0xffffffffu, vt, o);
            vs += __shfl_xor_sync(0xffffffffu, vs, o);
          }
          if (g == 0) {
            dbt[rg * 2 * G + n0 + j * 8 + cq + e] = vt;
            dbt[rg * 2 * G + G + n0 + j * 8 + cq + e] = vs;
          }
        }
    }
    __syncthreads();
    store_rows(a.dpre, dp, ldp, b, t0, T, 2 * G);
    for (int n = threadIdx.x; n < 2 * G; n += NTB) {
      float s = dbt[n];
      for (int i = 1; i < RG; ++i) s += dbt[i * 2 * G + n];
      db[n] += s;
    }
    // d cond += rnd(dpre) w_cond^T of the tile (w_cond's staged rows as
    // the output-major operand), from the fragments to global memory.
    for (int item = warp; COND && item < RG * (Cc / 16); item += NWB) {
      const int rc = (item % RG) * 16, n0 = (item / RG) * 16;
      float2* q[2][2];
      float2 o[2][2];  // the sum so far, in flight over the mma
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = t0 + rc + g + h * 8 < T ? rc + g + h * 8 : 0;
          q[j][h] = reinterpret_cast<float2*>(a.dcond + ((size_t)b * T + t0 + r) * Cc + n0 +
                                              j * 8 + cq);
          o[j][h] = *q[j][h];
        }
      float acc[2][4];
      zero(acc);
      for (int ks = 0; ks < 2 * G / 16; ++ks) {
        uint32_t av[4], bv[4];
        lda_rm(av, dp, ldp, rc, ks * 16);
        ldb_nk(bv, wa + 2 * C * ldw, ldw, n0, ks * 16);
        mma2(acc, av, bv);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (t0 + rc + g + h * 8 < T)
            *q[j][h] = make_float2(o[j][h].x + acc[j][2 * h], o[j][h].y + acc[j][2 * h + 1]);
    }
    // dw_cur | dw_prev (| dw_cond), dw_res and the last pass's dw_skip
    // columns of the tile into the block's slot; item -> warp, and so each
    // element's owner, is fixed.
    const int it0 = (K / 16) * (2 * G / 16), it1 = it0 + (G / 16) * (C / 16);
    for (int item = warp; item < it1 + (G / 16) * (sc / 16); item += NWB) {
      const bf16 *A = zs, *Bm = gsm;
      float* out = part + o_dws + s0;
      int la = ldz, lb = ldg, ldo = S, n = sc, i = item - it1;
      if (item < it0) {
        A = xa; la = lda; Bm = dp; lb = ldp; out = part; ldo = n = 2 * G; i = item;
      } else if (item < it1) {
        Bm = dn; lb = ldn; out = part + o_dwr; ldo = n = C; i = item - it0;
      }
      wgrad_item(out, ldo, A, la, Bm, lb, (i / (n / 16)) * 16, (i % (n / 16)) * 16, first);
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < 2 * G; n += NTB) part[o_db + n] = db[n];
  for (int c = threadIdx.x; c < C; c += NTB) part[o_dbr + c] = dbr[c];
}

inline size_t dx_tc_smem(int C, int G) {
  return 2 * ((size_t)2 * C * (2 * G + PAD) + (size_t)2 * TP * (2 * G + PAD));
}

// dx_l = (dx_{l+1} + rnd(dpre)(t) w_cur^T) + rnd(dpre)(t + d) w_prev^T, times
// m[b, t] where mask is non-null (every layer but the first, masked).
__global__ void __launch_bounds__(NTC) bwd_dx_tc(const bf16* __restrict__ dpre,
                                                 const float* __restrict__ dxn,
                                                 float* __restrict__ dx, const bf16* wc,
                                                 const bf16* wp, int B, int T, int C, int G,
                                                 int d, const float* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int ldp = 2 * G + PAD;
  bf16* wcs = reinterpret_cast<bf16*>(smraw);  // [C][2G] w_cur
  bf16* wps = wcs + C * ldp;                    // [C][2G] w_prev
  bf16* dc = wps + C * ldp;                     // [TP][2G] dpre(t)
  bf16* dl = dc + TP * ldp;                     // [TP][2G] dpre(t + d)
  stage_w(wcs, ldp, wc, C, 2 * G, 2 * G);
  stage_w(wps, ldp, wp, C, 2 * G, 2 * G);
  pdl();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  const int per_b = (T + TP - 1) / TP;
  for (int tile = blockIdx.x; tile < B * per_b; tile += gridDim.x) {
    const int b = tile / per_b, t0 = (tile % per_b) * TP;
    __syncthreads();
    stage_rows(dc, ldp, dpre, b, t0, T, 2 * G, 0);
    stage_rows(dl, ldp, dpre, b, t0, T, 2 * G, -d);
    staged();
    for (int item = warp; item < RG * (C / 16); item += NW) {
      const int r0 = (item % RG) * 16, n0 = (item / RG) * 16;
      float2 v[2][2];  // dx_{l+1}, in flight over the products
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = t0 + r0 + g + h * 8 < T ? r0 + g + h * 8 : 0;
          v[j][h] = *reinterpret_cast<const float2*>(dxn + ((size_t)b * T + t0 + r) * C + n0 +
                                                     j * 8 + cq);
        }
      float s1[2][4], s2[2][4];
      zero(s1);
      zero(s2);
      for (int ks = 0; ks < 2 * G / 16; ++ks) {
        uint32_t av[4], bv[4];
        lda_rm(av, dc, ldp, r0, ks * 16);
        ldb_nk(bv, wcs, ldp, n0, ks * 16);
        mma2(s1, av, bv);
        lda_rm(av, dl, ldp, r0, ks * 16);
        ldb_nk(bv, wps, ldp, n0, ks * 16);
        mma2(s2, av, bv);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + g + h * 8, n = n0 + j * 8 + cq;
          if (t0 + r >= T) continue;
          const size_t row = (size_t)b * T + t0 + r;
          float2 o = make_float2((v[j][h].x + s1[j][2 * h]) + s2[j][2 * h],
                                 (v[j][h].y + s1[j][2 * h + 1]) + s2[j][2 * h + 1]);
          if (mask) {
            const float m = mask[row];
            o = make_float2(o.x * m, o.y * m);
          }
          *reinterpret_cast<float2*>(dx + row * C + n) = o;
        }
    }
  }
}

// gs = rnd(g_skip), once per call, and each position chunk's column sums of
// the unrounded g_skip (db_skip: the same for every layer).
__global__ void __launch_bounds__(NTC) gskip_prep(const float* __restrict__ g,
                                                  bf16* __restrict__ gs, float* __restrict__ part,
                                                  int n_pos, int S, int chunk) {
  const int p0 = blockIdx.x * chunk, p1 = min(n_pos, p0 + chunk);
  for (int s = threadIdx.x; s < S; s += NTC) {
    float acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      const float v = g[(size_t)p * S + s];
      acc += v;
      gs[(size_t)p * S + s] = __float2bfloat16_rn(v);
    }
    part[(size_t)blockIdx.x * S + s] = acc;
  }
}

// grads[l] = layer l's block slots summed in slot order (as reduce_partials),
// but for the db_skip columns (the last S), which no layer pass writes: the
// call's one db_skip there.
__global__ void __launch_bounds__(NTC) reduce_tc(const float* __restrict__ partial,
                                                 const float* __restrict__ dbs,
                                                 float* __restrict__ grads, int L, int chunks,
                                                 int nw, int S) {
  const size_t idx = (size_t)blockIdx.x * NTC + threadIdx.x;
  if (idx >= (size_t)L * nw) return;
  const size_t l = idx / nw;
  const int i = (int)(idx % nw);
  if (i >= nw - S) {
    grads[idx] = dbs[i - (nw - S)];
    return;
  }
  const float* p = partial + l * chunks * nw + i;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += p[(size_t)c * nw];
  grads[idx] = s;
}

// Dynamic shared memory of the largest kernel of the route at these widths
// (Cc conditioning channels, 0: unconditioned).
inline size_t max_smem(int C, int G, int S, int Cc) {
  const size_t f = fwd_tc_smem(C, G, Cc), k = skip_tc_smem(G, S), b = bwd_tc_smem(C, G, S, Cc),
               x = dx_tc_smem(C, G);
  const size_t fk = f > k ? f : k, bx = b > x ? b : x;
  return fk > bx ? fk : bx;
}

}  // namespace tsc

struct FwdArgs {
  const float* h0;     // (B, T, C)
  float* x_all;        // (L, B, T, C) out: each layer's input
  void* z_all;         // (L, B, T, G) out, compute dtype
  float* skip;         // (B, T, S) out
  const void* w_cur;   // (L, C, 2G) compute dtype
  const void* w_prev;  // (L, C, 2G)
  const float* b;      // (L, 2G)
  const void* w_res;   // (L, G, C)
  const float* b_res;  // (L, C)
  const void* w_skip;  // (L, G, S)
  const float* b_skip; // (L, S)
  const int* dils;     // (L,) host memory
  int B, T, L, C, G, S, bf16, tapcat;
  int tc;              // bf16: 1 the tensor-core kernels (tsc), 0 the CUDA-core ones
  const void* cond;    // (B, T, Cc): bf16 (tc) or fp32, or null: unconditioned
  const void* w_cond;  // (L, Cc, 2G) compute dtype
  int Cc;
  const float* mask;   // (B, T) halo mask, or null: unmasked
};

struct BwdArgs {
  const float* x_all;  // (L, B, T, C)
  const void* z_all;   // (L, B, T, G) compute dtype
  const float* g_skip; // (B, T, S)
  float* dx;           // (2, B, T, C) scratch; dh0 ends in dx[(L % 2)]
  float* dpre;         // (B, T, 2G) scratch
  float* partial;      // (L, chunks, nw) scratch
  float* grads;        // (L, nw) out
  const void* w_cur;   // (L, C, 2G)
  const void* w_prev;  // (L, C, 2G)
  const float* b;      // (L, 2G)
  const void* wcT;     // (L, 2G, C)
  const void* wpT;     // (L, 2G, C)
  const void* wrT;     // (L, C, G)
  const void* wsT;     // (L, S, G)
  const int* dils;     // (L,) host memory
  int B, T, L, C, G, S, bf16, tapcat, chunks;
  const float* cond;   // (B, T, Cc) fp32, or null: unconditioned
  const void* w_cond;  // (L, Cc, 2G)
  const void* wcdT;    // (L, 2G, Cc)
  float* dcond;        // (B, T, Cc) out: d cond
  int Cc;
  const float* mask;   // (B, T) halo mask, or null: unmasked
};

template <typename K>
static cudaError_t smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

#define WN_TRY(expr)                          \
  do {                                        \
    cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

template <typename T, bool TAPCAT>
static cudaError_t forward(const FwdArgs& a, cudaStream_t s, int* launches) {
  const size_t btc = (size_t)a.B * a.T * a.C, btg = (size_t)a.B * a.T * a.G;
  const T* wc = static_cast<const T*>(a.w_cur);
  const T* wp = static_cast<const T*>(a.w_prev);
  const T* wr = static_cast<const T*>(a.w_res);
  T* z = static_cast<T*>(a.z_all);
  const dim3 grid((a.T + TT - 1) / TT, a.B);
  const T* wcd = static_cast<const T*>(a.w_cond);
  const size_t lsm = sizeof(float) * TT * (3 * a.C + 3 * a.G + (wcd ? a.Cc : 0));
  WN_TRY(smem(fwd_layer<T, TAPCAT>, lsm));
  WN_TRY(cudaMemcpyAsync(a.x_all, a.h0, btc * sizeof(float), cudaMemcpyDeviceToDevice, s));
  for (int l = 0; l < a.L; ++l) {
    float* next = l + 1 < a.L ? a.x_all + (l + 1) * btc : nullptr;
    fwd_layer<T, TAPCAT><<<grid, NT, lsm, s>>>(
        a.x_all + l * btc, next, z + l * btg, wc + (size_t)l * a.C * 2 * a.G,
        wp + (size_t)l * a.C * 2 * a.G, a.b + l * 2 * a.G, wr + (size_t)l * a.G * a.C,
        a.b_res + l * a.C, a.T, a.C, a.G, a.dils[l], static_cast<const float*>(a.cond),
        wcd ? wcd + (size_t)l * a.Cc * 2 * a.G : nullptr, a.Cc, a.mask);
    WN_TRY(cudaGetLastError());
    ++*launches;
  }
  const size_t ssm = sizeof(float) * TT * a.G;
  WN_TRY(smem(fwd_skip<T>, ssm));
  fwd_skip<T><<<grid, NT, ssm, s>>>(z, static_cast<const T*>(a.w_skip), a.b_skip, a.skip, a.T,
                                    a.B, a.L, a.G, a.S);
  WN_TRY(cudaGetLastError());
  ++*launches;
  return cudaSuccess;
}

template <typename T, bool TAPCAT>
static cudaError_t backward(const BwdArgs& a, cudaStream_t s, int* launches) {
  const int C = a.C, G = a.G, S = a.S, bf = a.bf16, Cc = a.w_cond ? a.Cc : 0;
  const size_t btc = (size_t)a.B * a.T * C, btg = (size_t)a.B * a.T * G;
  const int nw = (2 * C + Cc) * 2 * G + 2 * G + G * C + C + G * S + S;
  const dim3 grid((a.T + TT - 1) / TT, a.B);
  const size_t psm = sizeof(float) * TT * (2 * C + 2 * G + S + C + Cc);
  const size_t xsm = sizeof(float) * TT * 4 * G;
  const T* wcd = static_cast<const T*>(a.w_cond);
  const T* wcdT = static_cast<const T*>(a.wcdT);
  WN_TRY(smem(bwd_dpre<T, TAPCAT>, psm));
  WN_TRY(smem(bwd_dx<T>, xsm));
  WN_TRY(cudaMemsetAsync(a.dx, 0, btc * sizeof(float), s));
  if (Cc) WN_TRY(cudaMemsetAsync(a.dcond, 0, (size_t)a.B * a.T * Cc * sizeof(float), s));
  const int chunk = (a.B * a.T + a.chunks - 1) / a.chunks;
  for (int l = a.L - 1, k = 0; l >= 0; --l, ++k) {
    const int d = a.dils[l];
    const float* x = a.x_all + l * btc;
    const void* z = static_cast<const T*>(a.z_all) + l * btg;
    const float* dxn = a.dx + (k % 2) * btc;
    float* dxo = a.dx + ((k + 1) % 2) * btc;
    const size_t wo = (size_t)l * C * 2 * G;
    bwd_dpre<T, TAPCAT><<<grid, NT, psm, s>>>(
        x, a.g_skip, dxn, a.dpre, static_cast<const T*>(a.w_cur) + wo,
        static_cast<const T*>(a.w_prev) + wo, a.b + l * 2 * G,
        static_cast<const T*>(a.wsT) + (size_t)l * S * G,
        static_cast<const T*>(a.wrT) + (size_t)l * C * G, a.T, C, G, S, d, a.cond,
        Cc ? wcd + (size_t)l * Cc * 2 * G : nullptr, Cc);
    WN_TRY(cudaGetLastError());
    bwd_dx<T><<<grid, NT, xsm, s>>>(a.dpre, dxn, dxo, static_cast<const T*>(a.wcT) + wo,
                                    static_cast<const T*>(a.wpT) + wo, a.T, C, G, d,
                                    Cc ? a.dcond : nullptr,
                                    Cc ? wcdT + (size_t)l * 2 * G * Cc : nullptr, Cc,
                                    l > 0 ? a.mask : nullptr);
    WN_TRY(cudaGetLastError());
    // Gradient pack of a layer: dwc | dwp (C x 2G each) | dwcd (Cc x 2G,
    // conditioned) | db | dwr (G x C) | dbr | dws (G x S) | dbs.
    WGrad w;
    const int o_db = (2 * C + Cc) * 2 * G, o_dwr = o_db + 2 * G, o_dbr = o_dwr + G * C;
    const int o_dws = o_dbr + C, o_dbs = o_dws + G * S;
    const WOp xo = wop(x, 0, C, a.T), xs = wop(x, 0, C, a.T, 0, d);
    const WOp po = wop(a.dpre, 0, 2 * G, a.T), zo = wop(z, bf, G, a.T);
    const WOp dno = wop(dxn, 0, C, a.T), go = wop(a.g_skip, 0, S, a.T);
    w.job[0] = outer(xo, po, C, 2 * G, 0);
    w.job[1] = outer(xs, po, C, 2 * G, C * 2 * G);
    w.job[2] = colsum(po, 2 * G, o_db);
    w.job[3] = outer(zo, dno, G, C, o_dwr);
    w.job[4] = colsum(dno, C, o_dbr);
    w.job[5] = outer(zo, go, G, S, o_dws);
    w.job[6] = colsum(go, S, o_dbs);
    w.n_jobs = 7;
    if (Cc) w.job[w.n_jobs++] = outer(wop(a.cond, 0, Cc, a.T), po, Cc, 2 * G, 2 * C * 2 * G);
    w.n_pos_b = a.T;
    w.B = a.B;
    w.chunk = chunk;
    w.nw = nw;
    w.round_bf16 = bf;
    w.partial = a.partial + (size_t)l * a.chunks * nw;
    WN_TRY(launch_wgrad(w, a.chunks, s));
    *launches += 3;
  }
  WN_TRY(launch_reduce(a.partial, a.grads, a.L, a.chunks, nw, s));
  ++*launches;
  return cudaSuccess;
}

// ---- the tensor-core route's host side ---------------------------------------

struct BwdTcArgs {
  const float* x_all;  // (L, B, T, C)
  const void* z_all;   // (L, B, T, G) bf16
  const float* g_skip; // (B, T, S)
  void* gs;            // (B, T, S) bf16 scratch: rnd(g_skip)
  float* dx;           // (2, B, T, C) scratch; dh0 ends in dx[(L % 2)]
  void* dpre;          // (B, T, 2G) bf16 scratch
  float* partial;      // (L, chunks, nw) scratch: one slot per layer and block
  float* grads;        // (L, nw) out
  float* part_s;       // (s_chunks, S) scratch
  float* dbs;          // (S,) scratch: db_skip
  const void* w_cur;   // (L, C, 2G) bf16
  const void* w_prev;  // (L, C, 2G)
  const float* b;      // (L, 2G)
  const void* w_res;   // (L, G, C)
  const void* w_skip;  // (L, G, S)
  const int* dils;     // (L,) host memory
  int B, T, L, C, G, S, tapcat, chunks, s_chunks;
  const void* cond;    // (B, T, Cc) bf16, or null: unconditioned
  const void* w_cond;  // (L, Cc, 2G) bf16
  float* dcond;        // (B, T, Cc) out: d cond
  int Cc;
  const float* mask;   // (B, T) halo mask, or null: unmasked
};

// Blocks of a persistent launch over `tiles`: as many as fit on the card at
// once, at most one per tile; 0 if one block does not fit.
template <typename K>
static int tc_grid(K kernel, size_t bytes, int tiles, int threads = tsc::NTC) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, bytes) !=
          cudaSuccess || per < 1)
    return 0;
  return sms * per < tiles ? sms * per : tiles;
}

// Launch k<<<grid, block, smem, s>>>(args...), with programmatic dependent
// launch if `pdl` (the launch before it on s is a tsc kernel: see tsc::pdl).
template <typename... P, typename... A>
static cudaError_t launch_tc(void (*k)(P...), int grid, int block, size_t smem, cudaStream_t s,
                             bool pdl, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  WN_TRY(cudaLaunchKernelEx(&cfg, k, args...));
  return cudaGetLastError();
}

template <bool TAPCAT>
static cudaError_t forward_tc(const FwdArgs& a, cudaStream_t s, int* launches) {
  using tsc::bf16;
  const size_t btc = (size_t)a.B * a.T * a.C, btg = (size_t)a.B * a.T * a.G;
  const int tiles = a.B * ((a.T + tsc::TP - 1) / tsc::TP);
  const int Cc = a.w_cond ? a.Cc : 0;
  const size_t lsm = tsc::fwd_tc_smem(a.C, a.G, Cc), ssm = tsc::skip_tc_smem(a.G, a.S);
  WN_TRY(smem(tsc::fwd_layer_tc<TAPCAT>, lsm));
  WN_TRY(smem(tsc::fwd_skip_tc, ssm));
  const int lg = tc_grid(tsc::fwd_layer_tc<TAPCAT>, lsm, tiles);
  const int sg = tc_grid(tsc::fwd_skip_tc, ssm, tsc::skip_tc_items(a.B, a.T, a.S), tsc::NTB);
  if (lg < 1 || sg < 1) return cudaErrorInvalidValue;
  const bf16* wc = static_cast<const bf16*>(a.w_cur);
  const bf16* wp = static_cast<const bf16*>(a.w_prev);
  const bf16* wr = static_cast<const bf16*>(a.w_res);
  bf16* z = static_cast<bf16*>(a.z_all);
  const bf16* wcd = static_cast<const bf16*>(a.w_cond);
  WN_TRY(cudaMemcpyAsync(a.x_all, a.h0, btc * sizeof(float), cudaMemcpyDeviceToDevice, s));
  for (int l = 0; l < a.L; ++l) {
    const size_t wo = (size_t)l * a.C * 2 * a.G;
    const tsc::FwdTc p{a.x_all + l * btc, l + 1 < a.L ? a.x_all + (l + 1) * btc : nullptr,
                       z + l * btg, wc + wo, wp + wo, wr + (size_t)l * a.G * a.C,
                       a.b + l * 2 * a.G, a.b_res + l * a.C, a.B, a.T, a.C, a.G, a.dils[l],
                       static_cast<const bf16*>(a.cond),
                       Cc ? wcd + (size_t)l * Cc * 2 * a.G : nullptr, Cc, a.mask};
    WN_TRY(launch_tc(tsc::fwd_layer_tc<TAPCAT>, lg, tsc::NTC, lsm, s, l > 0, p));
    ++*launches;
  }
  WN_TRY(launch_tc(tsc::fwd_skip_tc, sg, tsc::NTB, ssm, s, a.L > 0, (const bf16*)z,
                   static_cast<const bf16*>(a.w_skip), a.b_skip, a.skip, a.B, a.T, a.L, a.G,
                   a.S));
  ++*launches;
  return cudaSuccess;
}

template <bool TAPCAT>
static cudaError_t backward_tc(const BwdTcArgs& a, cudaStream_t s, int* launches) {
  using tsc::bf16;
  const int C = a.C, G = a.G, S = a.S, Cc = a.w_cond ? a.Cc : 0;
  const size_t btc = (size_t)a.B * a.T * C, btg = (size_t)a.B * a.T * G;
  const int nw = (2 * C + Cc) * 2 * G + 2 * G + G * C + C + G * S + S;
  const int n_pos = a.B * a.T, tiles = a.B * ((a.T + tsc::TP - 1) / tsc::TP);
  const size_t bsm = tsc::bwd_tc_smem(C, G, S, Cc), xsm = tsc::dx_tc_smem(C, G);
  void (*layer)(tsc::BwdTc) =
      Cc ? (S > tsc::SC ? tsc::bwd_layer_tc<TAPCAT, true, true>
                        : tsc::bwd_layer_tc<TAPCAT, false, true>)
         : (S > tsc::SC ? tsc::bwd_layer_tc<TAPCAT, true, false>
                        : tsc::bwd_layer_tc<TAPCAT, false, false>);
  WN_TRY(smem(layer, bsm));
  WN_TRY(smem(tsc::bwd_dx_tc, xsm));
  const int xg = tc_grid(tsc::bwd_dx_tc, xsm, tiles);
  if (a.chunks < 1 || a.chunks > tiles || a.s_chunks < 1 || xg < 1 ||
      tc_grid(layer, bsm, tiles, tsc::NTB) < 1)
    return cudaErrorInvalidValue;
  const bf16* z_all = static_cast<const bf16*>(a.z_all);
  const bf16* wc = static_cast<const bf16*>(a.w_cur);
  const bf16* wp = static_cast<const bf16*>(a.w_prev);
  const bf16* wr = static_cast<const bf16*>(a.w_res);
  const bf16* ws = static_cast<const bf16*>(a.w_skip);
  bf16* gs = static_cast<bf16*>(a.gs);
  bf16* dpre = static_cast<bf16*>(a.dpre);
  const bf16* wcd = static_cast<const bf16*>(a.w_cond);
  tsc::gskip_prep<<<a.s_chunks, tsc::NTC, 0, s>>>(a.g_skip, gs, a.part_s, n_pos, S,
                                                 (n_pos + a.s_chunks - 1) / a.s_chunks);
  WN_TRY(cudaGetLastError());
  WN_TRY(launch_reduce(a.part_s, a.dbs, 1, a.s_chunks, S, s));
  *launches += 2;
  WN_TRY(cudaMemsetAsync(a.dx, 0, btc * sizeof(float), s));
  if (Cc) WN_TRY(cudaMemsetAsync(a.dcond, 0, (size_t)n_pos * Cc * sizeof(float), s));
  for (int l = a.L - 1, k = 0; l >= 0; --l, ++k) {
    const int d = a.dils[l];
    const float* dxn = a.dx + (k % 2) * btc;
    float* dxo = a.dx + ((k + 1) % 2) * btc;
    const size_t wo = (size_t)l * C * 2 * G;
    const tsc::BwdTc p{a.x_all + l * btc, z_all + l * btg, gs, dxn, dpre,
                       a.partial + (size_t)l * a.chunks * nw, wc + wo, wp + wo,
                       wr + (size_t)l * G * C, ws + (size_t)l * G * S, a.b + l * 2 * G,
                       a.B, a.T, C, G, S, d, nw, static_cast<const bf16*>(a.cond),
                       Cc ? wcd + (size_t)l * Cc * 2 * G : nullptr, a.dcond, Cc};
    // The first layer pass follows memsets: launched plainly.
    WN_TRY(launch_tc(layer, a.chunks, tsc::NTB, bsm, s, k > 0, p));
    WN_TRY(launch_tc(tsc::bwd_dx_tc, xg, tsc::NTC, xsm, s, true, (const bf16*)dpre, dxn, dxo,
                     wc + wo, wp + wo, a.B, a.T, C, G, d, l > 0 ? a.mask : nullptr));
    *launches += 2;
  }
  const size_t n = (size_t)a.L * nw;
  tsc::reduce_tc<<<(unsigned)((n + tsc::NTC - 1) / tsc::NTC), tsc::NTC, 0, s>>>(
      a.partial, a.dbs, a.grads, a.L, a.chunks, nw, S);
  WN_TRY(cudaGetLastError());
  ++*launches;
  return cudaSuccess;
}

}  // namespace wn

// Each returns a CUDA error code and adds the kernels it launched to *launches.
// cond and w_cond come together, with Cc > 0 (and d cond for a backward).
static bool cond_ok(const void* cond, const void* w_cond, int Cc) {
  return (cond != nullptr) == (w_cond != nullptr) && (cond ? Cc > 0 : Cc == 0);
}

extern "C" int wn_train_stack_fwd(const wn::FwdArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cond_ok(a->cond, a->w_cond, a->Cc)) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (a->bf16 && a->tc)
    e = a->tapcat ? wn::forward_tc<true>(*a, s, launches)
                  : wn::forward_tc<false>(*a, s, launches);
  else if (a->bf16)
    e = a->tapcat ? wn::forward<__nv_bfloat16, true>(*a, s, launches)
                  : wn::forward<__nv_bfloat16, false>(*a, s, launches);
  else
    e = a->tapcat ? wn::forward<float, true>(*a, s, launches)
                  : wn::forward<float, false>(*a, s, launches);
  return (int)e;
}

extern "C" int wn_train_stack_bwd(const wn::BwdArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cond_ok(a->cond, a->w_cond, a->Cc) || (a->cond && (!a->wcdT || !a->dcond)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (a->bf16)
    e = a->tapcat ? wn::backward<__nv_bfloat16, true>(*a, s, launches)
                  : wn::backward<__nv_bfloat16, false>(*a, s, launches);
  else
    e = a->tapcat ? wn::backward<float, true>(*a, s, launches)
                  : wn::backward<float, false>(*a, s, launches);
  return (int)e;
}

// Bytes of dynamic shared memory of the tensor-core route's largest kernel
// at these widths, Cc conditioning channels (train_stack.py `tc_smem` must
// agree).
extern "C" long long wn_train_stack_tc_smem(int C, int G, int S, int Cc) {
  return (long long)wn::tsc::max_smem(C, G, S, Cc);
}

extern "C" int wn_train_stack_bwd_tc(const wn::BwdTcArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cond_ok(a->cond, a->w_cond, a->Cc) || (a->cond && !a->dcond))
    return (int)cudaErrorInvalidValue;
  return (int)(a->tapcat ? wn::backward_tc<true>(*a, s, launches)
                         : wn::backward_tc<false>(*a, s, launches));
}
