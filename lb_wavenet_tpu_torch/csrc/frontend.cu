// The input frontend of the training step, forward and backward: the
// embedding of the input classes and the width-K causal input conv,
//   h0[b, t] = bias + sum_k rnd(embed[x[b, t - (K-1) + k]]) @ rnd(w[k]).
//
// Replaces the Pallas kernels of lb_wavenet_tpu/ops/pallas/frontend.py
// (`_fwd_kernel`, `_bwd_kernel`, both under `fused_frontend`). The TPU version
// builds a one-hot of each time tile and contracts it with the table on the
// MXU (a gather written as a matrix product), and carries the three gradients
// in VMEM scratch across its sequential grid. Here two facts do the work:
//   * a tap's product depends on a position only through its class, so the
//     forward computes the K (Q, C) products of the classes once (the tap
//     table P[k] = rnd(embed) @ rnd(w[k])) and then gathers;
//   * the weight gradients regroup by class: with G[k][q] = the sum of
//     dh[s + K-1-k] over the positions s of class q, d_w[k] = embed^T G[k],
//     so the backward scatters dh rows into K tables beside the d_embed
//     table and multiplies once at the end.
//
// Bound on an H100 at the training shapes (WaveNet-30, B = 8, T = 13310,
// C = 64, Q = 256, K = 2; chip_smoke.py `frontend_cost`): the forward writes
// h0 (27 MB fp32), the backward reads dh (27 MB); both are set by bytes
// (~8 us each at 3.35 TB/s).
//
// Forward, every dtype and width (2 launches):
//   `table_tc` (bf16, C a multiple of 16: one warp per 16 classes x 8
//   outputs, mma.sync m16n8k16 with one mma from zero per 16-deep k-step
//   added in fp32 in k order, the order train_stack.py `tc_mm` models) or
//   `table_fma` (else: one thread per entry, an fp32 FMA chain over C in
//   order) writes P (K, Q, C) fp32; `gather_add` (a grid-stride loop, 16
//   bytes a thread where C % 4 == 0, a programmatic dependent launch) writes
//   h0 = bias + ((P[0][x_0] + P[1][x_1]) + ...), the JAX kernel's order,
//   with streaming stores; the table stays in L1/L2. Positions before t = 0
//   and classes outside [0, Q) give a zero tap. The taps look back along
//   their own batch row only.
//
// Backward, two routes chosen on the host before the launch from (dtype,
// Q, C, K) (ops/cuda/frontend.py `route`; not a fallback):
//   * bf16 with C a multiple of 16 up to 64 whose tables and staging fit in
//     a block's shared memory (every config in configs/): namespace `ftc`,
//     one pass over dh and one ordered reduction (3 launches):
//     - `bwd_pass`: persistent blocks (one per SM, 16 warps) walk tiles of
//       TP = 32 positions of one batch row. A tile's dh rows plus the K-1
//       after it come by one bulk copy (cp.async.bulk on an mbarrier) two
//       tiles ahead, and are split into bf16 hi + lo tiles. Warps 0-7 run
//       d_e[s] = sum_k rnd(dh[s + K-1-k] @ rnd(w[k])^T) on the tensor cores
//       as two exact products (hi and lo) summed in fp32, which carry dh to
//       ~2^-17 (a piece is rnd(sum_hi + sum_lo), each sum one mma from zero
//       per k-step in k order); d_e stays in shared memory. Meanwhile warps
//       8-15 group the tile's positions by class (__match_any_sync), add dh
//       into d_b, and scatter dh into the G[k] tables by x[s - (K-1-k)]:
//       each class group's rows are summed in position order and added to
//       the class's row, all groups at once (distinct rows). Then warps 0-7
//       scatter d_e by x[s] into the d_embed table the same way while warps
//       8-15 land the next tile. No float atomics: a table entry takes the
//       block's tiles in order and each tile's positions in order. The
//       (K+1) (Q, C) tables and d_b stay in shared memory (196,864 bytes at
//       WaveNet-30) and go to the block's slot once at the end.
//     - `reduce_slots`: each entry summed over the slots in slot order,
//       d_embed and d_b written, the G totals kept;
//     - `dw_from_g`: d_w[k] = embed^T G[k], fp32, q in order.
//     The last two are programmatic dependent launches. Slots: one per
//     block, (K+1) Q C + C floats each (132 x 196,864 bytes = 26.0 MB
//     written and read back at WaveNet-30; it fits in L2).
//     The sequence-parallel input mask (below) has its place here: a
//     masked position gets class -1 in the staged classes (it drops out of
//     every scatter and group), and its dh row is multiplied by m in the
//     landing tile before anything reads it.
//   * fp32, and shapes whose tables do not fit (e.g. K = 3 at C = 64): the
//     first-version kernels (4 launches): `front_de` (one thread per
//     (position, c)) writes d_e and the unrounded gathered embedding e;
//     `front_scatter` gives one block a chunk of SCATTER positions and one
//     thread each column, which walks the chunk in position order adding
//     d_e into a (Q, C) partial by class; `wgrad_kernel` (tile.cuh) forms
//     d_w[k] = sum_s e[s - (K-1-k)]^T dh[s] and d_b over the same chunks;
//     `reduce_partials` adds every chunk's partial in chunk order.
//
// The sequence-parallel halo mask (the TPU kernels' `input_mask`: m (B, T)
// fp32, 0/1, parallel/halo.py), on every route with no launch of its own.
// The TPU kernels multiply the embedded rows by m and then h0's rows by m
// after the bias. Here a masked position's class reads as invalid: its
// embedding row is 0 in the forward, and in the backward it scatters
// nothing into d_embed or the G tables (d_w); h0 = (bias + taps) * m; the
// backward takes dh * m (the mask's own cotangent is 0, as in JAX): in the
// landing tile of the one-pass route, in `front_de`'s staged rows and its
// copy `dhm` that the d_w and d_b sums of the first-version route read.
// Each kernel is instantiated with and without the mask (MASK, chosen on
// the host from the pointer): read at run time, the checks cost the
// unmasked kernels 3-13% of their card time (tools/kernel_ab.py on an H100).
// An all-ones mask gives the unmasked kernels' bits.
#include "ar_tc.cuh"
#include "tc_tile.cuh"
#include "tile.cuh"

namespace wn {

constexpr int FT = 32;         // time rows per d_e block (first-version backward)
constexpr int SCATTER = 256;   // positions per scatter chunk (first-version backward)

struct FrontArgs {
  const int* x;        // (B, T) classes
  const float* emb;    // (Q, C) fp32
  const void* w;       // (K, C, C) compute dtype
  const void* wT;      // (K, C, C) w[k] transposed, compute dtype
  const float* bias;   // (C,)
  float* h;            // (B, T, C) out (forward)
  const float* dh;     // (B, T, C) cotangent of h (backward)
  float* de;           // (B, T, C) scratch: d_e (first-version backward)
  float* e;            // (B, T, C) scratch: unrounded embedding rows (first version)
  float* partial;      // per-chunk / per-slot gradients
  float* grads;        // (Q C + K C C + C) out: d_embed | d_w | d_b
  float* table;        // (K, Q, C) fp32: the forward's tap table; the G totals (ftc)
  int B, T, Q, C, K, bf16, tc;
  int blocks;          // the gather's grid; the tensor-core pass's blocks (its slots)
  const float* mask;   // (B, T) halo mask, or null: unmasked
  float* dhm;          // (B, T, C) scratch: dh * m (first-version backward, masked)
};

__device__ __forceinline__ bool valid_class(int v, int Q) { return v >= 0 && v < Q; }

// Whether flat position pos (b T + t) is masked.
template <bool MASK>
__device__ __forceinline__ bool masked(const FrontArgs& a, size_t pos) {
  return MASK && __ldg(a.mask + pos) == 0.f;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- forward ---------------------------------------------------------------

// P[k] = rnd(emb) @ w[k] on tensor cores; w arrives in bf16, transposed
// ([k][n][c]), so a B fragment is one 32-bit load.
__global__ void __launch_bounds__(NT) table_tc(FrontArgs a) {
  const int C = a.C, Q = a.Q, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = (Q + 15) / 16, nn = C / 8;
  const int warp = (blockIdx.x * NT + threadIdx.x) >> 5;
  if (warp >= a.K * nq * nn) return;
  const int n0 = (warp % nn) * 8, q0 = (warp / nn % nq) * 16, k = warp / (nn * nq);
  const __nv_bfloat16* wT =
      static_cast<const __nv_bfloat16*>(a.wT) + ((size_t)k * C + n0 + g) * C;
  auto arow = [&](int q, int c) -> uint32_t {
    if (q >= Q) return 0u;
    const float2 v = *reinterpret_cast<const float2*>(a.emb + (size_t)q * C + c);
    return bf2_bits(__floats2bfloat162_rn(v.x, v.y));
  };
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < C; c0 += 16) {
    const uint32_t af[4] = {arow(q0 + g, c0 + 2 * t), arow(q0 + g + 8, c0 + 2 * t),
                            arow(q0 + g, c0 + 2 * t + 8), arow(q0 + g + 8, c0 + 2 * t + 8)};
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wT + c0 + 2 * t);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wT + c0 + 2 * t + 8);
    tct::mma_add(acc, af, b0, b1);
  }
  float* P = a.table + (size_t)k * Q * C + n0 + 2 * t;
  if (q0 + g < Q) *reinterpret_cast<float2*>(P + (size_t)(q0 + g) * C) = make_float2(acc[0], acc[1]);
  if (q0 + g + 8 < Q)
    *reinterpret_cast<float2*>(P + (size_t)(q0 + g + 8) * C) = make_float2(acc[2], acc[3]);
}

// P[k][q][n] = sum_c rnd(emb[q][c]) * w[k][c][n], one fp32 FMA chain in c order.
template <typename T>
__global__ void __launch_bounds__(NT) table_fma(FrontArgs a) {
  const int C = a.C, Q = a.Q;
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= a.K * Q * C) return;
  const int n = idx % C, q = idx / C % Q, k = idx / (C * Q);
  const T* w = static_cast<const T*>(a.w) + (size_t)k * C * C + n;
  const float* e = a.emb + (size_t)q * C;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s = fmaf(rnd<T>(e[c]), to_f(w[(size_t)c * C]), s);
  a.table[idx] = s;
}

template <int V> struct Vec;
template <> struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ void store_streaming(float* p) const {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Vec<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = __ldg(p); }
  __device__ __forceinline__ void store_streaming(float* p) const { __stcs(p, v[0]); }
};

// h0[b, t, c..c+V) = bias + ((tap_0 + tap_1) + ...), tap_k = P[k][x[b, t-(K-1)+k]]
// (times m[b, t], MASK).
template <int V, bool MASK>
__global__ void __launch_bounds__(NT) gather_add(FrontArgs a) {
  const int C = a.C, Q = a.Q, K = a.K, T = a.T, per_row = C / V;
  const size_t items = (size_t)a.B * T * per_row;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the table is written
  for (size_t it = (size_t)blockIdx.x * NT + threadIdx.x; it < items;
       it += (size_t)gridDim.x * NT) {
    const size_t row = it / per_row;
    const int c = (int)(it % per_row) * V, t = (int)(row % T);
    const int* xr = a.x + (row - t);
    Vec<V> acc, tap;
    for (int k = 0; k < K; ++k) {
      const int p = t - (K - 1) + k;
      const int cls = p >= 0 && !masked<MASK>(a, row - t + p) ? __ldg(xr + p) : -1;
      if (valid_class(cls, Q)) {
        tap.load(a.table + ((size_t)k * Q + cls) * C + c);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) tap.v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] = k == 0 ? tap.v[j] : acc.v[j] + tap.v[j];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc.v[j] = __ldg(a.bias + c + j) + acc.v[j];
    if (MASK) {
      const float m = __ldg(a.mask + row);
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] *= m;
    }
    acc.store_streaming(a.h + row * C + c);
  }
}

// ---- backward, first version (fp32, and shapes whose tables do not fit) ----

template <typename T, bool MASK>
__global__ void __launch_bounds__(NT) front_de(FrontArgs a) {
  extern __shared__ __align__(16) float D[];  // [FT + K - 1][C] dh rows t0 .. t0+FT+K-2
  const int C = a.C, K = a.K, rows = FT + K - 1;
  const int b = blockIdx.y, t0 = blockIdx.x * FT;
  for (int i = threadIdx.x; i < rows * C; i += NT) {
    const int r = i / C, t = t0 + r;
    const size_t row = (size_t)b * a.T + t;
    const float v = t < a.T ? a.dh[row * C + i % C] : 0.f;
    D[i] = MASK && t < a.T ? v * a.mask[row] : v;
  }
  __syncthreads();
  const T* wT = static_cast<const T*>(a.wT);
  for (int item = threadIdx.x; item < FT * C; item += NT) {
    const int r = item / C, c = item % C, s = t0 + r;
    if (s >= a.T) continue;
    // d_e[s] takes tap k's piece of output position s + K-1-k, each piece
    // rounded to the compute dtype before the fp32 tap-sum.
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int t = s + K - 1 - k;
      if (t >= a.T) continue;
      const float* dr = D + (r + K - 1 - k) * C;
      const T* wk = wT + (size_t)k * C * C + c;
      float p = 0.f;
      for (int n = 0; n < C; ++n) p = fmaf(dr[n], to_f(wk[(size_t)n * C]), p);
      acc += rnd<T>(p);
    }
    const size_t at = ((size_t)b * a.T + s) * C + c;
    a.de[at] = acc;
    const int cls = masked<MASK>(a, (size_t)b * a.T + s) ? -1 : a.x[(size_t)b * a.T + s];
    a.e[at] = valid_class(cls, a.Q) ? a.emb[(size_t)cls * C + c] : 0.f;
    if (MASK) a.dhm[at] = D[r * C + c];
  }
}

// Block = one chunk of SCATTER positions; thread c owns column c of the
// chunk's (Q, C) partial and adds d_e in position order.
template <bool MASK>
__global__ void front_scatter(FrontArgs a) {
  extern __shared__ __align__(16) float P[];  // [Q][C]
  const int C = a.C, Q = a.Q, c = threadIdx.x;
  for (int i = threadIdx.x; i < Q * C; i += blockDim.x) P[i] = 0.f;
  __syncthreads();
  const int n_pos = a.B * a.T;
  const int p0 = blockIdx.x * SCATTER, p1 = min(n_pos, p0 + SCATTER);
  if (c < C) {
    for (int p = p0; p < p1; ++p) {
      const int cls = masked<MASK>(a, p) ? -1 : a.x[p];
      if (valid_class(cls, Q)) P[cls * C + c] += a.de[(size_t)p * C + c];
    }
  }
  __syncthreads();
  float* out = a.partial + (size_t)blockIdx.x * (Q * C + a.K * C * C + C);
  for (int i = threadIdx.x; i < Q * C; i += blockDim.x) out[i] = P[i];
}

// ---- backward, tensor-core route -------------------------------------------

namespace ftc {

constexpr int TP = 32;          // positions per tile (one warp's lanes)
constexpr int PAD = 8;          // bf16 row padding of the hi and lo tiles (conflict-free ldmatrix)
constexpr int NTP = 512;        // threads of the pass: 16 warps
constexpr int NWP = NTP / 32;
constexpr int MAX_PAIRS = 8;    // (tap, k-step) B fragments a warp keeps in registers
static_assert(NTP / 64 == TP / 16 * 4,
              "the first half's warps: 16-row strips x 4 groups of 16 columns");

// Floats of each shared-memory region, in order: the d_embed and G tables
// with d_b after them; the tile's dh rows split into bf16 hi and lo tiles
// (padded rows, for conflict-free ldmatrix); two landing tiles of fp32 dh
// rows as they come from device memory; the d_e tile; two class rows; per
// table the tile's group masks; the d_embed table's classes; the landing
// tiles' mbarriers. Each is a multiple of 4 floats when C % 16 == 0, so
// every region starts 16-byte aligned.
struct Carve {
  int tables, split, land, etile, xrow, groups;
  __host__ __device__ Carve(int Q, int C, int K)
      : tables((K + 1) * Q * C + C), split((TP + K - 1) * (C + PAD)), land((TP + K - 1) * C),
        etile(TP * C), xrow((TP + K - 1 + 3) / 4 * 4), groups((K + 1) * TP + TP) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)tables + split + 2 * land + etile + 2 * xrow + groups + 4);
  }
};

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(tct::sa(dst)), "l"(src)
               : "memory");
}

// Named barrier of the block's second half (warps 8-15).
__device__ __forceinline__ void half_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NTP / 2) : "memory");
}

// The class groups of a table: for the first position i of each class in
// the tile, grp[i] is the mask of the tile's positions of that class; else
// grp[i] = 0.
__device__ __forceinline__ void class_groups(const int* cls, int n_valid, unsigned* grp) {
  const int lane = threadIdx.x & 31;
  const int q = lane < n_valid ? cls[lane] : -1;
  const unsigned same = __match_any_sync(~0u, q);
  grp[lane] = q >= 0 && (same & ((1u << lane) - 1u)) == 0u ? same : 0u;
}

// tab[cls[i] * C + c..c+1] += the sum, in position order, of src[p][c..c+1]
// (src rows C apart) over the positions p of group i, for the groups i =
// it0 + u * step < TP (u < NB). The groups' rows are distinct, so the NB
// updates are independent: their loads are issued together (addresses of
// empty groups fall back to row 0 and are not stored), then a group's
// further positions are added, then the stores.
template <int C, int NB>
__device__ __forceinline__ void add_groups(float* tab, const int* cls, const unsigned* grp,
                                           const float* src, int c, int it0, int step) {
  unsigned m[NB];
  int at[NB];
  float2 tv[NB], sv[NB];
#pragma unroll
  for (int u = 0; u < NB; ++u) m[u] = c < C ? grp[it0 + u * step] : 0u;
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int i = m[u] ? it0 + u * step : 0;
    at[u] = (m[u] ? cls[i] : 0) * C + c;
    tv[u] = *reinterpret_cast<const float2*>(tab + at[u]);
    sv[u] = *reinterpret_cast<const float2*>(src + i * C + c);
  }
#pragma unroll
  for (int u = 0; u < NB; ++u)
    for (unsigned r = m[u] & (m[u] - 1u); r; r &= r - 1u) {
      const float2 v = *reinterpret_cast<const float2*>(src + (__ffs(r) - 1) * C + c);
      sv[u] = make_float2(sv[u].x + v.x, sv[u].y + v.y);
    }
#pragma unroll
  for (int u = 0; u < NB; ++u)
    if (m[u])
      *reinterpret_cast<float2*>(tab + at[u]) = make_float2(tv[u].x + sv[u].x, tv[u].y + sv[u].y);
}

// Producer-consumer barrier: the second half's group warps (one per table)
// arrive when the tile's groups are written; the first half waits for them.
__device__ __forceinline__ void groups_arrive(int K) {
  asm volatile("bar.arrive 2, %0;" ::"r"(NTP / 2 + 32 * (K + 1)) : "memory");
}
__device__ __forceinline__ void groups_wait(int K) {
  asm volatile("bar.sync 2, %0;" ::"r"(NTP / 2 + 32 * (K + 1)) : "memory");
}

// One persistent block per SM walks its tiles n = 0, 1, ... (tile blockIdx.x
// + n gridDim.x) in two halves of 8 warps that work at once.
//   Phase 1: warps 0-7 run the d_e products from the tile's bf16 hi and lo
//   tiles (ldmatrix), a warp per (16-row strip, 16 columns), with the
//   warp's B fragments of rnd(w) loaded once per launch, into E, then add
//   dh (its fp32 landing tile) into d_b. Warps 8-15 group the tile's
//   classes per table (d_embed by x[s], G_k by x[s-(K-1-k)]) by a warp's
//   __match_any_sync over the tile's 32 positions. Both halves then scatter
//   dh into the G tables, half of the (table, group) items each: each class
//   group's rows summed in position order and added to the class's table
//   row, all groups at once (distinct rows).
//   Phase 2: warps 0-7 scatter E into the d_embed table the same way, then
//   wait for tile n+1 and split its rows into the hi and lo tiles; warps
//   8-15 send tile n+2 to the landing tile tile n used and check tile n+1's
//   classes.
// dh rows come by one bulk copy per tile (the tile's rows plus the K-1
// after it, within the batch row) on an mbarrier; the classes by cp.async.
// A table entry takes the block's tiles in order, each tile's positions
// summed in order: the order is fixed, with no atomics. KS = C / 16; MASK:
// the halo mask (masked classes -1, dh rows times m in the landing tile).
template <int KS, bool MASK>
__global__ void __launch_bounds__(NTP, 1) bwd_pass(FrontArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int C = KS * 16, ld = C + PAD, HALF = NTP / 2, HW = HALF / 32, NB = 4;
  extern __shared__ __align__(16) float sm[];
  const int Q = a.Q, K = a.K, T = a.T, rows = TP + K - 1;
  const Carve cv(Q, C, K);
  float* tab = sm;  // [K + 1][Q][C] (d_embed, G_0 .. G_{K-1}), then d_b [C]
  bf16* hi = reinterpret_cast<bf16*>(sm + cv.tables);   // [rows][ld]
  bf16* lo = hi + rows * ld;                            // [rows][ld]
  float* L0 = sm + cv.tables + cv.split;                // two landing tiles [rows][C]
  float* E = L0 + 2 * cv.land;                          // [TP][C]
  int* xs0 = reinterpret_cast<int*>(E + cv.etile);      // two class rows
  unsigned* grps = reinterpret_cast<unsigned*>(xs0 + 2 * cv.xrow);  // [K + 1][TP]
  int* cls0 = reinterpret_cast<int*>(grps + (K + 1) * TP);          // [TP]
  uint64_t* full = reinterpret_cast<uint64_t*>(cls0 + TP);          // [2]
  const int per_row = (T + TP - 1) / TP, n_tiles = a.B * per_row;
  const int mine = n_tiles > (int)blockIdx.x ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                                             : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool aux = warp >= HW;
  const int lt = threadIdx.x - HALF;   // thread index within the second half
  const int np = K * KS;
  const int strip = warp / 4, n0 = warp % 4 * 16;
  const bool mma_warp = !aux && n0 < C;
  // G items it < K TP: (table 1 + it / TP, group it % TP); the second half
  // takes those below g_split, the first half the rest.
  const int g_items = K * TP, g_split = g_items / 2 / NB * NB;

  // B fragments of rnd(w[k]) for (tap, k-step) pair p and 8-column group h.
  uint32_t bf[MAX_PAIRS][2][2];
#pragma unroll
  for (int p = 0; p < MAX_PAIRS; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf[p][h][0] = bf[p][h][1] = 0u;
      if (mma_warp && p < np) {
        const bf16* wk = static_cast<const bf16*>(a.w) +
                         ((size_t)(p / KS) * C + n0 + 8 * h + g) * C + p % KS * 16 + 2 * t4;
        bf[p][h][0] = *reinterpret_cast<const uint32_t*>(wk);
        bf[p][h][1] = *reinterpret_cast<const uint32_t*>(wk + 8);
      }
    }
  for (int i = threadIdx.x; i < cv.tables; i += NTP) tab[i] = 0.f;
  if (threadIdx.x == 0) {
    tc::mbar_init(full, 1);
    tc::mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Second half. issue(m): tile m's dh rows t0 .. t0+TP+K-2 within the batch
  // row by one bulk copy into landing tile m % 2, the classes of positions
  // t0-(K-1) .. t0+TP-1 by cp.async into class row m % 2 (one commit group
  // per tile, empty past the block's tiles). classes(m): wait for tile m's
  // classes and check them (-1 out of range), each by the thread that
  // copied it.
  auto issue = [&](int m) {
    if (m < mine) {
      const int tile = blockIdx.x + m * gridDim.x, b = tile / per_row, t0 = tile % per_row * TP;
      const int valid = min(rows, T - t0);
      if (lt == 0) {
        tc::mbar_expect_tx(full + (m & 1), (uint32_t)(valid * C * sizeof(float)));
        tc::bulk_load(L0 + (m & 1) * cv.land, a.dh + ((size_t)b * T + t0) * C,
                      (uint32_t)(valid * C * sizeof(float)), full + (m & 1));
      }
      int* xd = xs0 + (m & 1) * cv.xrow;
      for (int i = lt; i < rows; i += HALF) {
        const int p = t0 - (K - 1) + i;
        if (p >= 0 && p < T) cp4(xd + i, a.x + (size_t)b * T + p);
        else xd[i] = -1;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto classes = [&](int m) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    int* xd = xs0 + (m & 1) * cv.xrow;
    for (int i = lt; i < rows; i += HALF)
      if (!valid_class(xd[i], Q)) xd[i] = -1;
    if (MASK) {   // each class by the thread that checked it
      const int tile = blockIdx.x + m * gridDim.x, b = tile / per_row, t0 = tile % per_row * TP;
      for (int i = lt; i < rows; i += HALF) {
        const int p = t0 - (K - 1) + i;
        if (p >= 0 && p < T && a.mask[(size_t)b * T + p] == 0.f) xd[i] = -1;
      }
    }
  };
  // First half. split(m): wait for tile m's rows and split them into hi =
  // rnd(v) and lo = rnd(v - hi) (zeros past T); masked, v = dh * m, also
  // written back to the landing tile for d_b and the G scatters.
  auto split = [&](int m) {
    const int tile = blockIdx.x + m * gridDim.x, t0 = tile % per_row * TP;
    const int valid = min(rows, T - t0);
    tc::mbar_wait(full + (m & 1), (m >> 1) & 1);
    float* src = L0 + (m & 1) * cv.land;
    for (int i = threadIdx.x; i < rows * (C / 4); i += HALF) {
      const int r = i / (C / 4), c4 = i % (C / 4) * 4;
      float4 v = r < valid ? *reinterpret_cast<const float4*>(src + r * C + c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      if (MASK && r < valid) {
        const float mk = a.mask[(size_t)(tile / per_row) * T + t0 + r];
        v = make_float4(v.x * mk, v.y * mk, v.z * mk, v.w * mk);
        *reinterpret_cast<float4*>(src + r * C + c4) = v;
      }
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y), h1 = __floats2bfloat162_rn(v.z, v.w);
      const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
      const __nv_bfloat162 l0 = __floats2bfloat162_rn(v.x - f0.x, v.y - f0.y);
      const __nv_bfloat162 l1 = __floats2bfloat162_rn(v.z - f1.x, v.w - f1.y);
      *reinterpret_cast<uint2*>(hi + r * ld + c4) = make_uint2(bf2_bits(h0), bf2_bits(h1));
      *reinterpret_cast<uint2*>(lo + r * ld + c4) = make_uint2(bf2_bits(l0), bf2_bits(l1));
    }
    // The landing tile's next bulk copy (async proxy) follows these writes.
    if (MASK) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };
  if (mine > 0) {
    if (aux) {
      issue(0);
      issue(1);
      classes(0);
    } else {
      split(0);
    }
  }
  __syncthreads();  // tile 0 split

  for (int n = 0; n < mine; ++n) {
    if (n > 0) __syncthreads();  // tile n split; tile n-1's scatters done
    const int tile = blockIdx.x + n * gridDim.x;
    const int n_valid = min(TP, T - tile % per_row * TP);
    const int* cls = xs0 + (n & 1) * cv.xrow;
    const float* dh = L0 + (n & 1) * cv.land;
    int it0, it1, w;   // this half's G items, and its warp index
    if (!aux) {
      if (mma_warp) {  // d_e rows strip*16 .., columns n0 .. n0+15
        float de[2][4], sh[2][4], sl[2][4];
#pragma unroll
        for (int p = 0; p < MAX_PAIRS; ++p) {
          if (p < np) {
            const int k = p / KS, ks = p % KS;
            if (ks == 0) {
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int v = 0; v < 4; ++v) sh[h][v] = sl[h][v] = 0.f;
            }
            uint32_t ah[4], al[4];
            tct::lda_rm(ah, hi, ld, strip * 16 + K - 1 - k, ks * 16);
            tct::lda_rm(al, lo, ld, strip * 16 + K - 1 - k, ks * 16);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              tct::mma_add(sh[h], ah, bf[p][h][0], bf[p][h][1]);
              tct::mma_add(sl[h], al, bf[p][h][0], bf[p][h][1]);
            }
            if (ks == KS - 1) {
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  const float piece = rnd<bf16>(sh[h][v] + sl[h][v]);
                  de[h][v] = k == 0 ? piece : de[h][v] + piece;
                }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* er = E + (strip * 16 + g) * C + n0 + 8 * h + 2 * t4;
          *reinterpret_cast<float2*>(er) = make_float2(de[h][0], de[h][1]);
          *reinterpret_cast<float2*>(er + 8 * C) = make_float2(de[h][2], de[h][3]);
        }
      }
      if (threadIdx.x < C) {  // d_b, a column each, positions in order
        float s = tab[(K + 1) * Q * C + threadIdx.x];
#pragma unroll 8
        for (int i = 0; i < n_valid; ++i) s += dh[i * C + threadIdx.x];
        tab[(K + 1) * Q * C + threadIdx.x] = s;
      }
      groups_wait(K);
      w = warp, it0 = g_split, it1 = g_items;
    } else {
      w = warp - HW, it0 = 0, it1 = g_split;
      if (w <= K) {  // table w's class groups; the d_embed table keeps its classes
        const int* cw = cls + (w == 0 ? K - 1 : w - 1);
        class_groups(cw, n_valid, grps + w * TP);
        if (w == 0) cls0[lane] = lane < n_valid ? cw[lane] : -1;
        groups_arrive(K);
      }
      half_sync();  // groups ready
    }
    for (int base = it0 + w * NB; base < it1; base += HW * NB) {
      const int j = 1 + base / TP;  // NB divides TP: a batch stays in one table
      add_groups<C, NB>(tab + (size_t)j * Q * C, cls + j - 1, grps + j * TP, dh, 2 * lane,
                        base % TP, 1);
    }
    __syncthreads();  // E and the d_embed table's groups ready; tile n read

    if (!aux) {  // d_embed[x[s]] += d_e[s]: groups warp + 8 u; then tile n+1
      add_groups<C, TP / HW>(tab, cls0, grps, E, 2 * lane, warp, HW);
      if (n + 1 < mine) split(n + 1);
    } else if (n + 1 < mine) {
      issue(n + 2);
      classes(n + 1);
    }
  }  // tiles
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(a.partial + (size_t)blockIdx.x * cv.tables);
  for (int i = threadIdx.x; i < cv.tables / 4; i += NTP)
    out[i] = reinterpret_cast<const float4*>(tab)[i];
}

// Entry i of every slot, summed in slot order: d_embed and d_b into grads,
// the G totals into a.table.
__global__ void __launch_bounds__(NT) reduce_slots(FrontArgs a) {
  const int QC = a.Q * a.C, nw = (a.K + 1) * QC + a.C;
  const int i = blockIdx.x * NT + threadIdx.x;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the slots are written
  if (i >= nw) return;
  const float* p = a.partial + i;
  float s = 0.f;
#pragma unroll 8
  for (int sl = 0; sl < a.blocks; ++sl) s += p[(size_t)sl * nw];
  if (i < QC) a.grads[i] = s;
  else if (i < (a.K + 1) * QC) a.table[i - QC] = s;
  else a.grads[QC + a.K * a.C * a.C + (i - (a.K + 1) * QC)] = s;
}

// d_w[k][c][n] = sum_q emb[q][c] * G[k][q][n], one fp32 FMA chain in q
// order. Block (16 rows c, k): G[k] staged in shared memory by bulk copies
// on an mbarrier, emb[:, c0:c0+16] by 16-byte loads (C % 16 == 0); a
// thread owns one row c and four columns n.
constexpr int DW_ROWS = 16;
constexpr uint32_t DW_CHUNK = 16384;   // bytes of one bulk copy

__host__ __device__ inline size_t dw_smem(int Q, int C) {
  return sizeof(float) * (size_t)Q * (DW_ROWS + C) + 16;
}

__global__ void __launch_bounds__(NT) dw_from_g(FrontArgs a) {
  extern __shared__ __align__(16) float ds[];
  const int C = a.C, Q = a.Q, k = blockIdx.y, c0 = blockIdx.x * DW_ROWS;
  float* es = ds;                  // [Q][DW_ROWS]
  float* gs = ds + Q * DW_ROWS;    // [Q][C]
  uint64_t* bar = reinterpret_cast<uint64_t*>(gs + Q * C);
  if (threadIdx.x == 0) {
    tc::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the G totals are written
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(sizeof(float) * Q * C);
    const char* src = reinterpret_cast<const char*>(a.table + (size_t)k * Q * C);
    tc::mbar_expect_tx(bar, bytes);
    for (uint32_t o = 0; o < bytes; o += DW_CHUNK)
      tc::bulk_load(reinterpret_cast<char*>(gs) + o, src + o, min(DW_CHUNK, bytes - o), bar);
  }
  for (int i = threadIdx.x; i < Q * DW_ROWS / 4; i += NT) {
    const int q = i / (DW_ROWS / 4), r = i % (DW_ROWS / 4) * 4;
    reinterpret_cast<float4*>(es)[i] =
        __ldg(reinterpret_cast<const float4*>(a.emb + (size_t)q * C + c0 + r));
  }
  __syncthreads();
  tc::mbar_wait(bar, 0);
  for (int item = threadIdx.x; item < DW_ROWS * (C / 4); item += NT) {
    const int r = item / (C / 4), n = item % (C / 4) * 4;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < Q; ++q) {
      const float e = es[q * DW_ROWS + r];
      const float4 gv = *reinterpret_cast<const float4*>(gs + q * C + n);
      s[0] = fmaf(e, gv.x, s[0]);
      s[1] = fmaf(e, gv.y, s[1]);
      s[2] = fmaf(e, gv.z, s[2]);
      s[3] = fmaf(e, gv.w, s[3]);
    }
    float* out = a.grads + Q * C + ((size_t)k * C + c0 + r) * C + n;
    out[0] = s[0]; out[1] = s[1]; out[2] = s[2]; out[3] = s[3];
  }
}

}  // namespace ftc

#define WN_TRY(expr)                  \
  do {                                \
    cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

static int blocks(size_t items) { return (int)((items + NT - 1) / NT); }

// Launch k<<<grid, block, smem, s>>>(a) as a programmatic dependent launch:
// it may start while the launch before it on s finishes, and waits for that
// launch's writes (griddepcontrol.wait) before it reads them.
template <typename Kern>
static cudaError_t launch_dependent(Kern k, dim3 grid, int block, size_t smem, cudaStream_t s,
                                    const FrontArgs& a) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  WN_TRY(cudaLaunchKernelEx(&cfg, k, a));
  return cudaGetLastError();
}

template <typename T>
static cudaError_t forward(const FrontArgs& a, cudaStream_t s, int* launches) {
  const int K = a.K, Q = a.Q, C = a.C;
  if (a.tc) {
    table_tc<<<blocks((size_t)K * ((Q + 15) / 16) * (C / 8) * 32), NT, 0, s>>>(a);
  } else {
    table_fma<T><<<blocks((size_t)K * Q * C), NT, 0, s>>>(a);
  }
  WN_TRY(cudaGetLastError());
  auto* gather = C % 4 == 0 ? (a.mask ? gather_add<4, true> : gather_add<4, false>)
                            : (a.mask ? gather_add<1, true> : gather_add<1, false>);
  WN_TRY(cudaFuncSetAttribute(gather, cudaFuncAttributePreferredSharedMemoryCarveout, 0));
  WN_TRY(launch_dependent(gather, dim3(a.blocks), NT, 0, s, a));
  *launches += 2;
  return cudaSuccess;
}

template <typename T, bool MASK>
static cudaError_t backward(const FrontArgs& a, cudaStream_t s, int* launches) {
  const int C = a.C, Q = a.Q, K = a.K;
  const size_t rows_bytes = sizeof(float) * (FT + K - 1) * C;
  WN_TRY(cudaFuncSetAttribute(front_de<T, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)rows_bytes));
  front_de<T, MASK><<<dim3((a.T + FT - 1) / FT, a.B), NT, rows_bytes, s>>>(a);
  WN_TRY(cudaGetLastError());

  const int n_pos = a.B * a.T;
  const int chunks = (n_pos + SCATTER - 1) / SCATTER;
  const size_t part_bytes = sizeof(float) * Q * C;
  WN_TRY(cudaFuncSetAttribute(front_scatter<MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)part_bytes));
  front_scatter<MASK><<<chunks, (C + 31) / 32 * 32, part_bytes, s>>>(a);
  WN_TRY(cudaGetLastError());

  // d_w[k] = sum_s e[s - (K-1-k)]^T dh[s] and d_b = sum_s dh[s], unrounded,
  // over the scatter's chunks, into the same partial rows after d_embed.
  const int nw = Q * C + K * C * C + C;
  WGrad w;
  const WOp dho = wop(MASK ? a.dhm : a.dh, 0, C, a.T);
  for (int k = 0; k < K; ++k)
    w.job[k] = outer(wop(a.e, 0, C, a.T, 0, K - 1 - k), dho, C, C, Q * C + k * C * C);
  w.job[K] = colsum(dho, C, Q * C + K * C * C);
  w.n_jobs = K + 1;
  w.n_pos_b = a.T;
  w.B = a.B;
  w.chunk = SCATTER;
  w.nw = nw;
  w.round_bf16 = 0;
  w.partial = a.partial;
  WN_TRY(launch_wgrad(w, chunks, s));
  WN_TRY(launch_reduce(a.partial, a.grads, 1, chunks, nw, s));
  *launches += 4;
  return cudaSuccess;
}

static cudaError_t backward_tc(const FrontArgs& a, cudaStream_t s, int* launches) {
  // A warp of the second half per table (frontend.py `route` takes no other
  // shape).
  if (a.C % 16 || a.C > 64 || a.K * (a.C / 16) > ftc::MAX_PAIRS || a.K + 1 > ftc::NWP / 2)
    return cudaErrorInvalidValue;
  const size_t smem = ftc::Carve(a.Q, a.C, a.K).bytes();
  auto* pass = a.mask ? (a.C == 16 ? ftc::bwd_pass<1, true> : a.C == 32 ? ftc::bwd_pass<2, true>
                         : a.C == 48 ? ftc::bwd_pass<3, true> : ftc::bwd_pass<4, true>)
                      : (a.C == 16 ? ftc::bwd_pass<1, false> : a.C == 32 ? ftc::bwd_pass<2, false>
                         : a.C == 48 ? ftc::bwd_pass<3, false> : ftc::bwd_pass<4, false>);
  WN_TRY(cudaFuncSetAttribute(pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  pass<<<a.blocks, ftc::NTP, smem, s>>>(a);
  WN_TRY(cudaGetLastError());
  WN_TRY(launch_dependent(ftc::reduce_slots, dim3(blocks((size_t)(a.K + 1) * a.Q * a.C + a.C)),
                          NT, 0, s, a));
  const size_t dw_bytes = ftc::dw_smem(a.Q, a.C);
  WN_TRY(cudaFuncSetAttribute(ftc::dw_from_g, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dw_bytes));
  WN_TRY(launch_dependent(ftc::dw_from_g, dim3(a.C / ftc::DW_ROWS, a.K), NT, dw_bytes, s, a));
  *launches += 3;
  return cudaSuccess;
}

}  // namespace wn

extern "C" int wn_front_scatter_chunk() { return wn::SCATTER; }

// Bytes of dynamic shared memory of the tensor-core backward pass at (Q, C,
// K) (frontend.py `tc_smem` must agree).
extern "C" long long wn_front_tc_smem(int Q, int C, int K) {
  return (long long)wn::ftc::Carve(Q, C, K).bytes();
}

// Each returns a CUDA error code and adds the kernels it launched to *launches.
extern "C" int wn_front_fwd(const wn::FrontArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->bf16 ? wn::forward<__nv_bfloat16>(*a, s, launches)
                       : wn::forward<float>(*a, s, launches));
}

extern "C" int wn_front_bwd(const wn::FrontArgs* a, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->mask && !a->tc && !a->dhm) return (int)cudaErrorInvalidValue;
  if (a->tc) return (int)wn::backward_tc(*a, s, launches);
  if (a->mask)
    return (int)(a->bf16 ? wn::backward<__nv_bfloat16, true>(*a, s, launches)
                         : wn::backward<float, true>(*a, s, launches));
  return (int)(a->bf16 ? wn::backward<__nv_bfloat16, false>(*a, s, launches)
                       : wn::backward<float, false>(*a, s, launches));
}
