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
// Bound on an H100 at WaveNet-30, B = 8, T = 13310: the products are
// ~0.24 TFLOP forward and ~0.55 TFLOP backward (0.8 ms at the bf16
// tensor-core peak); the forward moves ~1.5 GB, the backward ~3 GB (x_all,
// z_all, per-layer dpre/dx). These kernels use CUDA-core FMAs with weights
// read through L1/L2: a simple first version, far from that bound.
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

template <typename T, bool TAPCAT>
__global__ void __launch_bounds__(NT)
fwd_layer(const float* __restrict__ x, float* __restrict__ x_next, T* __restrict__ z,
          const T* __restrict__ wc, const T* __restrict__ wp, const float* __restrict__ bias,
          const T* __restrict__ wr, const float* __restrict__ br, int n_t, int C, int G, int d) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;               // [C][TT] x(t)
  float* xr = xs + C * TT;      // [C][TT] rounded x(t)
  float* xp = xr + C * TT;      // [C][TT] rounded x(t - d)
  float* pre = xp + C * TT;     // [2G][TT]
  float* zr = pre + 2 * G * TT; // [G][TT] z in the compute dtype
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  stage<T, false>(xs, x, b, t0, n_t, C, 0);
  stage<T, true>(xp, x, b, t0, n_t, C, d);
  __syncthreads();
  for (int i = threadIdx.x; i < C * TT; i += NT) xr[i] = rnd<T>(xs[i]);
  __syncthreads();
  tile_mm2<TT, TAPCAT>(xr, wc, C, xp, wp, C, 2 * G, [&](int t, int n, float s1, float s2) {
    pre[n * TT + t] = (s1 + s2) + bias[n];
  });
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
    if (t0 + t < n_t) x_next[((size_t)b * n_t + t0 + t) * C + c] = (xs[c * TT + t] + s) + br[c];
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
         const T* __restrict__ wrT, int n_t, int C, int G, int S, int d) {
  extern __shared__ __align__(16) float sm[];
  float* xr = sm;               // [C][TT] rounded x(t)
  float* xp = xr + C * TT;      // [C][TT] rounded x(t - d)
  float* act = xp + C * TT;     // [2G][TT] pre, then tanh | sigmoid
  float* gs = act + 2 * G * TT; // [S][TT] rounded g_skip
  float* dn = gs + S * TT;      // [C][TT] rounded dx_{l+1}
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  stage<T, true>(xr, x, b, t0, n_t, C, 0);
  stage<T, true>(xp, x, b, t0, n_t, C, d);
  stage<T, true>(gs, g_skip, b, t0, n_t, S, 0);
  stage<T, true>(dn, dx_next, b, t0, n_t, C, 0);
  __syncthreads();
  tile_mm2<TT, TAPCAT>(xr, wc, C, xp, wp, C, 2 * G, [&](int t, int n, float s1, float s2) {
    act[n * TT + t] = (s1 + s2) + bias[n];
  });
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

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_dx(const float* __restrict__ dpre, const float* __restrict__ dx_next,
       float* __restrict__ dx, const T* __restrict__ wcT, const T* __restrict__ wpT, int n_t,
       int C, int G, int d) {
  extern __shared__ __align__(16) float sm[];
  float* dc = sm;               // [2G][TT] rounded dpre(t)
  float* dl = dc + 2 * G * TT;  // [2G][TT] rounded dpre(t + d)
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  stage<T, true>(dc, dpre, b, t0, n_t, 2 * G, 0);
  stage<T, true>(dl, dpre, b, t0, n_t, 2 * G, -d);
  __syncthreads();
  tile_mm2<TT, false>(dc, wcT, 2 * G, dl, wpT, 2 * G, C, [&](int t, int c, float s1, float s2) {
    if (t0 + t >= n_t) return;
    const size_t at = ((size_t)b * n_t + t0 + t) * C + c;
    dx[at] = (dx_next[at] + s1) + s2;
  });
}

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
  const size_t lsm = sizeof(float) * TT * (3 * a.C + 3 * a.G);
  WN_TRY(smem(fwd_layer<T, TAPCAT>, lsm));
  WN_TRY(cudaMemcpyAsync(a.x_all, a.h0, btc * sizeof(float), cudaMemcpyDeviceToDevice, s));
  for (int l = 0; l < a.L; ++l) {
    float* next = l + 1 < a.L ? a.x_all + (l + 1) * btc : nullptr;
    fwd_layer<T, TAPCAT><<<grid, NT, lsm, s>>>(
        a.x_all + l * btc, next, z + l * btg, wc + (size_t)l * a.C * 2 * a.G,
        wp + (size_t)l * a.C * 2 * a.G, a.b + l * 2 * a.G, wr + (size_t)l * a.G * a.C,
        a.b_res + l * a.C, a.T, a.C, a.G, a.dils[l]);
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
  const int C = a.C, G = a.G, S = a.S, bf = a.bf16;
  const size_t btc = (size_t)a.B * a.T * C, btg = (size_t)a.B * a.T * G;
  const int nw = 2 * C * 2 * G + 2 * G + G * C + C + G * S + S;
  const dim3 grid((a.T + TT - 1) / TT, a.B);
  const size_t psm = sizeof(float) * TT * (2 * C + 2 * G + S + C);
  const size_t xsm = sizeof(float) * TT * 4 * G;
  WN_TRY(smem(bwd_dpre<T, TAPCAT>, psm));
  WN_TRY(smem(bwd_dx<T>, xsm));
  WN_TRY(cudaMemsetAsync(a.dx, 0, btc * sizeof(float), s));
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
        static_cast<const T*>(a.wrT) + (size_t)l * C * G, a.T, C, G, S, d);
    WN_TRY(cudaGetLastError());
    bwd_dx<T><<<grid, NT, xsm, s>>>(a.dpre, dxn, dxo, static_cast<const T*>(a.wcT) + wo,
                                    static_cast<const T*>(a.wpT) + wo, a.T, C, G, d);
    WN_TRY(cudaGetLastError());
    // Gradient pack of a layer: dwc | dwp (C x 2G each) | db | dwr (G x C)
    // | dbr | dws (G x S) | dbs.
    WGrad w;
    const int o_db = 2 * C * 2 * G, o_dwr = o_db + 2 * G, o_dbr = o_dwr + G * C;
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

}  // namespace wn

// Each returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_train_stack_fwd(const wn::FwdArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a->bf16)
    e = a->tapcat ? wn::forward<__nv_bfloat16, true>(*a, s, launches)
                  : wn::forward<__nv_bfloat16, false>(*a, s, launches);
  else
    e = a->tapcat ? wn::forward<float, true>(*a, s, launches)
                  : wn::forward<float, false>(*a, s, launches);
  return (int)e;
}

extern "C" int wn_train_stack_bwd(const wn::BwdArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a->bf16)
    e = a->tapcat ? wn::backward<__nv_bfloat16, true>(*a, s, launches)
                  : wn::backward<__nv_bfloat16, false>(*a, s, launches);
  else
    e = a->tapcat ? wn::backward<float, true>(*a, s, launches)
                  : wn::backward<float, false>(*a, s, launches);
  return (int)e;
}
