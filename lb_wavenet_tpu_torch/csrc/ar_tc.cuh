// Tensor-core device code of the bf16 sampling kernels (ar_mega.cu and
// ar_turbo.cu, bf16 instantiations; their fp32 instantiations keep the
// CUDA-core path of common.cuh) and of the tensor-core route of the
// one-step stack kernels B1 (ar_step.cu) and B7 (ar_tp.cu), which run
// turbo's and mega's layer loop without a finale (`layer`, `stack_tc_kernel`).
//
// A block owns a tile of TB = 8 lanes, as in common.cuh, and runs 8
// consumer warps plus one producer warp:
//   * Weights through shared memory. The host packs every weight matrix of
//     a sample step once, in the order the step consumes them, into the
//     register layout of an mma.sync m16n8k16 A fragment (ar_tc.py
//     `pack_mma`): k-step by k-step, each 16x16 tile as 32 lanes x 16
//     bytes. The producer warp walks that stream in pieces of whole k-steps
//     (at most SLOT bytes) and copies each piece with one bulk asynchronous
//     copy (cp.async.bulk, completion on an mbarrier) into a ring of slots;
//     consumer warps wait on a slot's `full` barrier, multiply, and release
//     it on its `empty` barrier, so the next pieces are in flight while
//     the current one multiplies. A block reads each weight byte once per
//     step with 16-byte shared-memory loads that feed 8 lanes at once.
//   * Products on tensor cores: out[m][lane] = sum_k W[k][m] x[k][lane] as
//     mma.sync.m16n8k16 bf16 x bf16 -> fp32, output channels as M (one
//     16-row tile per warp and round), the tile's 8 lanes as N, k in
//     16-deep steps in order. Activations are staged lane-major in bf16
//     (rounded where common.cuh rounds them), rows padded by 8 elements so
//     the B-fragment loads are free of bank conflicts.
//   * Invariance: an (output, lane) sum is the same chain of k-steps for
//     every lane of every tile, the thread that owns it depends only on
//     (M, warp, lane of the warp), and no k is split across warps or
//     blocks, so a lane's result does not depend on B or its place in it.
//   * Kernels are instantiated per tile entries per warp (TPW: 3, or 6 for
//     products up to 768 outputs), picked on the host, so that fragments
//     and sums stay in registers.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace wn {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NC = 256;             // consumer threads (8 warps)
constexpr int NCW = NC / 32;        // consumer warps
constexpr int NTH = NC + 32;        // plus the producer warp
constexpr int FRAG = 512;           // bytes of one packed 16x16 A tile
constexpr int SLOT = 32768;         // bytes of one ring slot
constexpr int MAX_SLOTS = 6;
constexpr int MAX_MT = 6;           // 16-row tiles per warp: M <= 16 * 6 * 8
constexpr int MAX_M = 16 * MAX_MT * NCW;
static_assert(SLOT >= (MAX_M / 16) * FRAG, "a slot holds one k-step of the widest product");

// Shared-memory carving, the same on the host (p == nullptr: sizes only)
// and the device.
struct Carve {
  char* p;
  size_t off;
  template <typename X>
  __host__ __device__ X* take(size_t n) {
    off = (off + 15) & ~size_t(15);
    X* r = reinterpret_cast<X*>(reinterpret_cast<uintptr_t>(p) + off);
    off += n * sizeof(X);
    return r;
  }
};

// Named barrier of the consumer warps (the producer warp never joins it).
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory"); }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(saddr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of `parity` to complete. A wait of ~20 s means the
// producer and the consumers walk different schedules: trap (a launch
// error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
                   saddr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// d += A (16x16, packed fragment) * B (16x8: b0 rows 2t..2t+1, b1 rows
// 2t+8..2t+9 of column lane / 4), fp32 accumulators.
__device__ __forceinline__ void mma16816(float* d, const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// k-steps per piece of an (M x K) product: as many as fill a slot.
__host__ __device__ __forceinline__ int kgroup(int M, int K) {
  const int per = (M / 16) * FRAG, ks = K / 16, kg = SLOT / per;
  return kg < ks ? kg : ks;
}

// The ring of weight slots; every consumer thread walks the same piece
// index i, the producer thread its own copy.
struct Ring {
  char* slots;
  uint64_t* full;
  uint64_t* empty;
  int n;
  int i;

  __device__ __forceinline__ const char* acquire() {
    const int s = i % n;
    mbar_wait(full + s, (i / n) & 1);
    return slots + (size_t)s * SLOT;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + i % n);
    ++i;
  }
};

// Set up the ring's barriers (thread 0; the caller syncs the block after).
__device__ __forceinline__ void ring_init(Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.n; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// The producer: n_steps passes over the packed weight stream `w`, whose
// products are prods[2p] x prods[2p+1] (M, K), p < n_prod.
__device__ __forceinline__ void produce(Ring& r, const char* w, const int* prods, int n_prod,
                                        int n_steps) {
  for (int t = 0; t < n_steps; ++t) {
    const char* src = w;
    for (int p = 0; p < n_prod; ++p) {
      const int M = prods[2 * p], K = prods[2 * p + 1];
      const int per = (M / 16) * FRAG, ks = K / 16, kg = kgroup(M, K);
      for (int k0 = 0; k0 < ks; k0 += kg) {
        const uint32_t bytes = (uint32_t)((kg < ks - k0 ? kg : ks - k0) * per);
        const int s = r.i % r.n;
        mbar_wait(r.empty + s, ((r.i / r.n) & 1) ^ 1);
        mbar_expect_tx(r.full + s, bytes);
        bulk_load(r.slots + (size_t)s * SLOT, src, bytes, r.full + s);
        src += bytes;
        ++r.i;
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}
// 4-byte copy, for a tap whose address is not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Programmatic dependent launch: let the next launch on the stream start
// its prologue now; wait until the launch before this one has finished and
// its writes are visible.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// The 16-row tile of entry i of a warp's tiles, or MT (none). PAIRED puts
// tile u (a tanh row block of a gate product) and tile u + MT/2 (its
// sigmoid rows) in entries 2v and 2v+1 of the same warp.
template <bool PAIRED>
__device__ __forceinline__ int tile_of(int warp, int i, int MT) {
  if (!PAIRED) return warp + i * NCW < MT ? warp + i * NCW : MT;
  const int u = warp + (i >> 1) * NCW;
  return u < MT / 2 ? u + (i & 1) * (MT / 2) : MT;
}

// out[m][lane] = sum_k W[k][m] act[lane][k] for the next (M x K) product of
// the stream; act is bf16 [TB][lda], bias fp32 (or null: 0). Each k-step is
// one mma from zero, added to the fp32 sum in k-step order: acc = ((s_0 +
// s_1) + s_2) + ..., the order ar_tc.py `tc_product` reproduces. The
// fragments of the next k-step load (ld.shared by 32-bit address, two
// k-steps per turn in two register sets) while the current one multiplies; the
// biases load before the first wait. epi(m, lane, acc, bias[m]) consumes
// each sum, or with PAIRED epi(m, lane, acc, bias[m], acc', bias[m']) each
// pair m < M/2, m' = m + M/2. With SPLIT the two halves of K are summed
// apart and then added, (first + second), turbo's split order for
// [h | tap] @ [w_cur ; w_prev]. TPW >= tiles_per_warp(M, PAIRED), a
// compile-time count so that fragments and sums stay in registers: the
// kernels are instantiated per TPW and the host picks one for all of a
// step's products, so each call site is compiled once.
template <int TPW, bool PAIRED = false, bool SPLIT = false, typename Epi>
__device__ __forceinline__ void mm(Ring& r, int M, int K, const bf16* act, int lda,
                                   const float* bias, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int MT = M / 16, ks = K / 16, kg = kgroup(M, K);
  int mt[TPW];
  float acc[TPW][4], acc2[SPLIT ? TPW : 1][4], bv[TPW][2];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    mt[i] = tile_of<PAIRED>(warp, i, MT);
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    if constexpr (SPLIT) acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;
    bv[i][0] = bv[i][1] = 0.f;
    if (bias && mt[i] < MT) {
      bv[i][0] = bias[mt[i] * 16 + g];
      bv[i][1] = bias[mt[i] * 16 + g + 8];
    }
    // Keep the loads here, ahead of the first wait, rather than sunk into
    // the epilogue where their latency would add to the layer's.
    asm volatile("" : "+f"(bv[i][0]), "+f"(bv[i][1]));
  }
  // Operands by 32-bit shared-memory address: B of k-step k at bb + 32 k
  // (rows 2t..2t+1, then 2t+8..2t+9 of column g), A tile (k, m) of a piece
  // at sb + (k MT + m) FRAG.
  const uint32_t bb = saddr(act + g * lda + 2 * t);
  // acc (or, with SPLIT, acc2 over the second half of K) += s, in k order.
  auto add = [&](const float (&s)[TPW][4], int k) {
    const bool upper = SPLIT && 2 * k >= ks;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (mt[i] < MT) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (upper) {
            acc2[SPLIT ? i : 0][v] += s[i][v];
          } else {
            acc[i][v] += s[i][v];
          }
        }
      }
    }
  };
  auto mma_all = [&](float (&s)[TPW][4], const uint4 (&a)[TPW], uint32_t b0, uint32_t b1) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      if (mt[i] < MT) mma16816(s[i], a[i], b0, b1);
    }
  };
#pragma unroll 1
  for (int k0 = 0; k0 < ks; k0 += kg) {
    const uint32_t sb = saddr(r.acquire()) + lane * 16;
    const int kn = kg < ks - k0 ? kg : ks - k0;
    auto load = [&](uint4 (&a)[TPW], uint32_t& b0, uint32_t& b1, int kk) {
      b0 = lds32(bb + (k0 + kk) * 32);
      b1 = lds32(bb + (k0 + kk) * 32 + 16);
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        if (mt[i] < MT) a[i] = lds128(sb + (kk * MT + mt[i]) * FRAG);
      }
    };
    // Two k-steps per turn in two register sets, the next set's loads in
    // flight while the current one multiplies.
    uint4 a0[TPW], a1[TPW];
    uint32_t b00, b01, b10 = 0, b11 = 0;
    load(a0, b00, b01, 0);
#pragma unroll 1
    for (int kk = 0; kk < kn; kk += 2) {
      const bool two = kk + 1 < kn;
      if (two) load(a1, b10, b11, kk + 1);
      float s0[TPW][4], s1[TPW][4];
      mma_all(s0, a0, b00, b01);
      if (kk + 2 < kn) load(a0, b00, b01, kk + 2);
      add(s0, k0 + kk);
      if (two) {
        mma_all(s1, a1, b10, b11);
        add(s1, k0 + kk + 1);
      }
    }
    r.release();
  }
  if constexpr (SPLIT) {  // (sum over the first half + sum over the second)
#pragma unroll
    for (int i = 0; i < TPW; ++i)
      for (int v = 0; v < 4; ++v) acc[i][v] = acc[i][v] + acc2[i][v];
  }
  const int n = 2 * t;
  if constexpr (PAIRED) {
#pragma unroll
    for (int i = 0; i + 1 < TPW; i += 2) {
      if (mt[i] < MT) {
        const int m = mt[i] * 16 + g;
        epi(m, n, acc[i][0], bv[i][0], acc[i + 1][0], bv[i + 1][0]);
        epi(m, n + 1, acc[i][1], bv[i][0], acc[i + 1][1], bv[i + 1][0]);
        epi(m + 8, n, acc[i][2], bv[i][1], acc[i + 1][2], bv[i + 1][1]);
        epi(m + 8, n + 1, acc[i][3], bv[i][1], acc[i + 1][3], bv[i + 1][1]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (mt[i] < MT) {
        const int m = mt[i] * 16 + g;
        epi(m, n, acc[i][0], bv[i][0]);
        epi(m, n + 1, acc[i][1], bv[i][0]);
        epi(m + 8, n, acc[i][2], bv[i][1]);
        epi(m + 8, n + 1, acc[i][3], bv[i][1]);
      }
    }
  }
}

// Tile entries a warp needs for an M-wide product (PAIRED: tile pairs).
__host__ __device__ inline int tiles_per_warp(int M, bool paired) {
  const int units = paired ? M / 32 : M / 16;
  return (units + NCW - 1) / NCW * (paired ? 2 : 1);
}

// The instantiated TPW that covers every product of a sample step (the
// gate pairs, [w_res | w_skip], w1, w2 and the frontend's C x C), or 0: 3
// serves WaveNet-30, MAX_MT the 512-skip stress config.
inline int step_tpw(int C, int G, int S, int Q) {
  const int need = std::max(
      {tiles_per_warp(2 * G, true), tiles_per_warp(C + S, false), tiles_per_warp(Q, false)});
  return need <= 3 ? 3 : need <= MAX_MT ? MAX_MT : 0;
}

// ---- The layer loop of the stack kernels B1 and B7 -------------------------
//
// turbo's and mega's layer loop (ar_turbo.cu, ar_mega.cu) as one function.
// mega and turbo keep their own copies: folded onto this one they ran ~3%
// slower for the same arithmetic (PERF.md, Findings). The ring holds each
// layer's taps in one of two layouts: lane-major rows (sum_d, B, C)
// (turbo, B1) or feature-major rows (sum_d, C, B) (mega, B7). A tap buffer
// in shared memory keeps a tile's taps in the ring's order: [TB][C]
// lane-major, [C][TB] feature-major.

// Copy a tile's taps from ring row `row` (B x C values) into `dst` by
// cp.async, zero past B: 16-byte copies of 4 channels of a lane
// (lane-major) or 4 lanes of a channel (feature-major), 4-byte copies
// where a chunk is cut by B or not 16-byte aligned (feature-major rows at
// B % 4 != 0). The caller waits (cp_async_wait_all) and syncs.
template <bool FM>
__device__ __forceinline__ void prefetch_taps(const float* row, float* dst, int B, int b0,
                                              int C) {
  for (int i = threadIdx.x; i < C * TB / 4; i += NC) {
    const float* src;
    int n;
    if (FM) {
      const int l0 = b0 + (i & 1) * 4;
      src = row + (size_t)(i >> 1) * B + l0;
      n = B - l0;
    } else {
      const int b = b0 + i / (C / 4);
      src = row + (size_t)b * C + (i % (C / 4)) * 4;
      n = b < B ? 4 : 0;
    }
    float* d = dst + i * 4;
    if (n >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < n) {
          cp_async4(d + e, src + e);
        } else {
          d[e] = 0.f;
        }
      }
    }
  }
}

// One gated layer l of the tile (lanes b0.. of B) on the consumer warps: x
// [C][TB] (h, fp32) and skip [S][TB] are updated in place, the weights are
// the next two products of the ring's stream ([w_cur ; w_prev] (2C, 2G),
// then [w_res | w_skip] (G, C+S)), bg (2G) and brs (C+S) their biases.
//   * Stage bf16 [h | tap] per lane into xb [TB][2C+8], the tap from the
//     prefetched buffer tp, and h into the tap's ring row `row`;
//   * start the copies of the next layer's taps (ring row next_row, unless
//     null, into `next`), which land during this layer's products;
//   * pre = [h | tap] @ [w_cur ; w_prev] + b on paired tiles, z =
//     tanh(pre[m]) sigmoid(pre[G + m]) into zb [TB][G+8]. SPLIT: the two
//     halves of K summed apart, (h @ w_cur + tap @ w_prev) + b (turbo's
//     and B1's order); else one 2C-deep sum (mega's and B7's);
//   * one z @ [w_res | w_skip] product: h = (h + res) + b_res; SPLIT: skip
//     = (skip + sk) + b_skip; else skip = skip + (sk + b_skip) (the first
//     layer's sum is its contribution), mega's bias order.
// Ends with the tap copies landed and the consumer warps synced.
template <int TPW, bool SPLIT, bool FM>
__device__ __forceinline__ void layer(Ring& r, float* x, float* skip, bf16* xb, bf16* zb,
                                      int l, int B, int b0, int C, int G, int S,
                                      const float* bg, const float* brs, float* row,
                                      const float* tp, const float* next_row, float* next) {
  const int lda = 2 * C + 8, ldg = G + 8;
  for (int i = threadIdx.x; i < C * TB; i += NC) {
    const int c = FM ? i / TB : i % C, j = FM ? i % TB : i / C, b = b0 + j;
    const float h = x[c * TB + j];
    if (b < B) row[FM ? (size_t)c * B + b : (size_t)b * C + c] = h;
    xb[j * lda + c] = __float2bfloat16_rn(h);
    xb[j * lda + C + c] = __float2bfloat16_rn(tp[i]);
  }
  if (next_row) prefetch_taps<FM>(next_row, next, B, b0, C);
  csync();
  mm<TPW, true, SPLIT>(r, 2 * G, 2 * C, xb, lda, bg,
                       [&](int m, int j, float at, float bt, float as, float bs) {
                         zb[j * ldg + m] = __float2bfloat16_rn(tanhf(at + bt) * sigmoidf(as + bs));
                       });
  csync();
  mm<TPW>(r, C + S, G, zb, ldg, brs, [&](int m, int j, float acc, float b) {
    if (m < C) {
      x[m * TB + j] = (x[m * TB + j] + acc) + b;
    } else if (SPLIT) {
      float* o = skip + (m - C) * TB + j;
      *o = (*o + acc) + b;
    } else {
      const float contrib = acc + b;
      float* o = skip + (m - C) * TB + j;
      *o = l == 0 ? contrib : *o + contrib;
    }
  });
  cp_async_wait_all();
  csync();
}

// The post network of the tile: ab = bf16(relu(skip)), hb = bf16(relu(ab @
// w1 + b1)), lg [Q][TB] = hb @ w2 + b2; emit(m, j, v) sees each logit.
template <int TPW, typename Emit>
__device__ __forceinline__ void post_logits(Ring& r, const float* skip, bf16* ab, bf16* hb,
                                            float* lg, const float* b1, const float* b2, int S,
                                            int Q, Emit emit) {
  const int lds = S + 8;
  for (int i = threadIdx.x; i < S * TB; i += NC) {
    ab[(i % TB) * lds + i / TB] = __float2bfloat16_rn(fmaxf(skip[i], 0.f));
  }
  csync();
  mm<TPW>(r, S, S, ab, lds, b1, [&](int m, int j, float acc, float b) {
    hb[j * lds + m] = __float2bfloat16_rn(fmaxf(acc + b, 0.f));
  });
  csync();
  mm<TPW>(r, Q, S, hb, lds, b2, [&](int m, int j, float acc, float b) {
    const float v = acc + b;
    lg[m * TB + j] = v;
    emit(m, j, v);
  });
  csync();
}

// sample_tile of common.cuh for the consumer warps: Gumbel-max sampling of
// lg [Q][TB] at absolute step t, first-max argmax, the forced override;
// the class goes to cls[j] (0 past B) and out[b].
__device__ __forceinline__ void sample(const float* lg, const Sampler& sp, int B, int b0, int Q,
                                       int t_abs, const int* forced, int* cls, int* out) {
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  for (int j = warp; j < TB; j += NCW) {
    const int b = b0 + j;
    if (b >= B) {
      if (lid == 0) cls[j] = 0;
      continue;
    }
    float best = -INFINITY;
    int bq = Q;
    for (int q = lid; q < Q; q += 32) {
      const float v = lg[q * TB + j];
      float s = v;
      if (sp.mode == 1) {
        const uint32_t seed = (uint32_t)sp.lane[b];
        const uint32_t tl = (uint32_t)(t_abs - sp.lane[B + b]);
        const float g = gumbel(mix32(seed + tl * 0x9E3779B9u + (uint32_t)q * 0x7FEB352Du));
        if (sp.lane_rows == 3) {
          const float inv = __int_as_float(sp.lane[2 * B + b]);
          s = inv > 0.f ? __fadd_rn(__fmul_rn(v, inv), g) : v;
        } else {
          s = __fadd_rn(__fmul_rn(v, sp.inv_temp), g);
        }
      } else if (sp.mode == 2) {
        const uint32_t ctr = (uint32_t)q * (uint32_t)sp.ctr_q + (uint32_t)b * (uint32_t)sp.ctr_b;
        const uint32_t seed = (uint32_t)(sp.seed_base + t_abs);
        s = __fadd_rn(__fmul_rn(v, sp.inv_temp), gumbel(mix32(seed + ctr * 0x9E3779B9u)));
      }
      if (s > best) { best = s; bq = q; }  // q rises: keeps the first max
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oq = __shfl_xor_sync(0xffffffffu, bq, o);
      if (ob > best || (ob == best && oq < bq)) { best = ob; bq = oq; }
    }
    if (lid == 0) {
      const int f = forced[b];
      const int c = f >= 0 ? f : bq;
      cls[j] = c;
      out[b] = c;
    }
  }
  csync();
}

// Next step's frontend: eb = emb[cls] (bf16), x = (b_in + eb @ w_in[K-1]) +
// sum_p bf16(es[p]) @ w_in[p] (pb scratch, [TB][C+8]), then the stack es
// [(K-1)C][TB] shifts and takes the new embedding.
template <int TPW>
__device__ __forceinline__ void next_frontend(Ring& r, float* x, float* es, bf16* eb, bf16* pb,
                                              const int* cls, const bf16* emb,
                                              const float* b_in, int C, int K) {
  const int ldc = C + 8;
  for (int i = threadIdx.x; i < C * TB; i += NC) {
    const int j = i / C, c = i % C;
    eb[j * ldc + c] = emb[(size_t)cls[j] * C + c];
  }
  csync();
  mm<TPW>(r, C, C, eb, ldc, b_in,
         [&](int m, int j, float acc, float b) { x[m * TB + j] = b + acc; });
  csync();
  for (int p = 0; p < K - 1; ++p) {
    for (int i = threadIdx.x; i < C * TB; i += NC) {
      pb[(i % TB) * ldc + i / TB] = __float2bfloat16_rn(es[p * C * TB + i]);
    }
    csync();
    mm<TPW>(r, C, C, pb, ldc, nullptr,
       [&](int m, int j, float acc, float) { x[m * TB + j] = x[m * TB + j] + acc; });
    csync();
  }
  if (K > 1) {
    for (int i = threadIdx.x; i < C * TB; i += NC) {
      for (int p = 0; p < K - 2; ++p) es[p * C * TB + i] = es[(p + 1) * C * TB + i];
      es[(K - 2) * C * TB + i] = __bfloat162float(eb[(i % TB) * ldc + i / TB]);
    }
    csync();
  }
}

// Weight slots (at most MAX_SLOTS) that fit in the dynamic shared memory a
// block may use on this device beside `fixed` bytes of activations.
inline int ring_slots(size_t fixed) {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)std::min<long>(MAX_SLOTS, std::max<long>(0, bytes - (long)fixed) / SLOT);
}

// ---- B1 and B7: one sample step through the L layers ----------------------
//
// The stack kernels run `layer` and stop at the skip sum (the post network
// stays outside, as in JAX): one block per tile of TB lanes,
// any batch (the last block masks lanes past B), the weight stream of one
// step without its finale (ar_tc.py `layer_stream`), the ring updated in
// place. B1 (ar_step.cu) is turbo's loop, lane-major and SPLIT; B7
// (ar_tp.cu) is mega's, feature-major and merged, on a rank's skip slice.

struct StackArgs {
  const float* h0;    // (B, C) lane-major, (C, B) feature-major
  float* bufs;        // (sum_d, B, C) or (sum_d, C, B) ring, in place
  const int* dils;    // (L,)
  const void* wpk;    // packed bf16: per layer [w_cur ; w_prev], [w_res | w_skip]
  const int* prods;   // (2L, 2) (M, K) of each packed product
  const float* bg;    // (L, 2G)
  const float* brs;   // (L, C+S) [b_res | b_skip]
  float* skip;        // (B, S) or (S, B) out
  int B, L, C, G, S, t, grid;
};

struct StackSmem {  // the block's shared memory
  float *x, *skip, *tap[2];
  int* dl;
  bf16 *xb, *zb;
  Ring ring;
};

__host__ __device__ inline StackSmem stack_carve(int L, int C, int G, int S, char* base,
                                                 int n_slots, size_t* bytes) {
  Carve cv{base, 0};
  StackSmem s;
  s.ring.full = cv.take<uint64_t>(MAX_SLOTS);
  s.ring.empty = cv.take<uint64_t>(MAX_SLOTS);
  s.ring.slots = cv.take<char>((size_t)n_slots * SLOT);
  s.ring.n = n_slots;
  s.ring.i = 0;
  s.x = cv.take<float>(C * TB);
  s.skip = cv.take<float>(S * TB);
  s.tap[0] = cv.take<float>(C * TB);
  s.tap[1] = cv.take<float>(C * TB);
  s.dl = cv.take<int>(L);
  s.xb = cv.take<bf16>(TB * (2 * C + 8));
  s.zb = cv.take<bf16>(TB * (G + 8));
  *bytes = cv.off;
  return s;
}

template <int TPW, bool SPLIT, bool FM>
__global__ void __launch_bounds__(NTH, 1) stack_tc_kernel(StackArgs a, int n_slots) {
  extern __shared__ __align__(128) char smem[];
  const int C = a.C, S = a.S, B = a.B;
  size_t bytes;
  StackSmem s = stack_carve(a.L, C, a.G, S, smem, n_slots, &bytes);
  Ring ring = s.ring;  // locals: no lambda captures the struct
  float *x = s.x, *skip = s.skip, *tap0 = s.tap[0], *tap1 = s.tap[1];
  int* dl = s.dl;
  ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= NC) {
    if (threadIdx.x == NC) produce(ring, static_cast<const char*>(a.wpk), a.prods, 2 * a.L, 1);
    return;
  }
  const int b0 = blockIdx.x * TB;
  const size_t rows = (size_t)B * C;  // floats of one ring row
  for (int l = threadIdx.x; l < a.L; l += NC) dl[l] = a.dils[l];
  for (int i = threadIdx.x; i < C * TB; i += NC) {
    const int c = FM ? i / TB : i % C, j = FM ? i % TB : i / C, b = b0 + j;
    x[c * TB + j] = b < B ? a.h0[FM ? (size_t)c * B + b : (size_t)b * C + c] : 0.f;
  }
  for (int i = threadIdx.x; i < S * TB; i += NC) skip[i] = 0.f;
  csync();
  prefetch_taps<FM>(a.bufs + (size_t)(a.t % dl[0]) * rows, tap0, B, b0, C);
  cp_async_wait_all();
  csync();

  int off = 0;
  for (int l = 0; l < a.L; ++l) {
    const int d = dl[l];
    const bool odd = l & 1;  // tap buffers by select: no dynamic index
    layer<TPW, SPLIT, FM>(
        ring, x, skip, s.xb, s.zb, l, B, b0, C, a.G, S, a.bg + l * 2 * a.G, a.brs + l * (C + S),
        a.bufs + (size_t)(off + a.t % d) * rows, odd ? tap1 : tap0,
        l + 1 < a.L ? a.bufs + (size_t)(off + d + a.t % dl[l + 1]) * rows : nullptr,
        odd ? tap0 : tap1);
    off += d;
  }
  for (int i = threadIdx.x; i < S * TB; i += NC) {
    const int m = FM ? i / TB : i % S, j = FM ? i % TB : i / S, b = b0 + j;
    if (b < B) a.skip[FM ? (size_t)m * B + b : (size_t)b * S + m] = skip[m * TB + j];
  }
}

// The instantiated TPW that covers a stack step's products (the gate
// pairs and [w_res | w_skip]), or 0.
inline int stack_tpw(int C, int G, int S) {
  const int need = std::max(tiles_per_warp(2 * G, true), tiles_per_warp(C + S, false));
  return need <= 3 ? 3 : need <= MAX_MT ? MAX_MT : 0;
}

// Dynamic shared memory of a stack launch at these widths on this device:
// activations plus as many weight slots as fit (ar_tc.py `stack_smem`
// reckons the same bytes; the wrapper checks it before every launch).
inline size_t stack_smem(int L, int C, int G, int S, int* n_slots) {
  size_t fixed;
  stack_carve(L, C, G, S, nullptr, 0, &fixed);
  *n_slots = ring_slots(fixed);
  return fixed + (size_t)*n_slots * SLOT;
}

template <int TPW, bool SPLIT, bool FM>
inline cudaError_t stack_launch_nt(const StackArgs& a, int n_slots, size_t smem,
                                   cudaStream_t stream, int* launches) {
  cudaError_t err = cudaFuncSetAttribute(stack_tc_kernel<TPW, SPLIT, FM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  stack_tc_kernel<TPW, SPLIT, FM><<<a.grid, NTH, smem, stream>>>(a, n_slots);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

template <bool SPLIT, bool FM>
inline cudaError_t stack_launch(const StackArgs& a, cudaStream_t stream, int* launches) {
  if (a.B < 1 || a.L < 1 || a.grid * TB < a.B || (a.grid - 1) * TB >= a.B || !a.wpk ||
      !a.prods || a.C % 16 || a.G % 16 || a.S % 16)
    return cudaErrorInvalidValue;
  int n_slots;
  const size_t smem = stack_smem(a.L, a.C, a.G, a.S, &n_slots);
  if (n_slots < 2) return cudaErrorInvalidValue;
  switch (stack_tpw(a.C, a.G, a.S)) {
    case 3: return stack_launch_nt<3, SPLIT, FM>(a, n_slots, smem, stream, launches);
    case MAX_MT: return stack_launch_nt<MAX_MT, SPLIT, FM>(a, n_slots, smem, stream, launches);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace wn
