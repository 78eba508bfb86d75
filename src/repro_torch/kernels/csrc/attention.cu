// Attention for Hopper (sm_90a): the LM serving path's two attention hot
// spots, prefill (K3) and decode (K4).
//
//   flash_attention   O = softmax(mask(Q K^T * scale)) V per (batch, q head),
//     GQA (q head h reads kv head h / group), causal and/or sliding window
//     (position i attends to (i - window, i]), fully masked rows -> 0.
//     Replaces the Pallas kernel repro/kernels/flash_attention.py:
//     flash_attention (:116, body _kernel :33).
//
//   decode_attention  one query token per (batch, q head) against a KV cache
//     whose first seq_lens[b] rows are valid and, when slot_pos is given,
//     whose row w also holds a position slot_pos[w] >= 0 above slot_lo (the
//     windowed ring buffer's rule, repro/models/layers.py:260-262).  slot_lo
//     lies in device memory and each block reads it once, so a decode step
//     captured in a CUDA graph reads the bound of the step it replays.
//     Replaces repro/kernels/decode_attention.py:decode_attention (:94, body
//     _kernel :33).
//
// Every tensor is addressed through its (batch, head, row) strides with the
// last dimension contiguous, so the model hands over transposed views of
// its [B, S, H, D] activations and of its [B, W, Hkv, D] cache and nothing
// is copied.  Softmax is taken in base 2 (scores pre-multiplied by scale *
// log2 e); masked scores are -inf, and a row that has seen no valid key
// keeps max -inf, normaliser 0 and output 0.  No atomics: reruns agree bit
// for bit.
//
// K3, bound.  Prefill at the serving shapes (phi4-mini: head dim 128,
// causal, 1,024 tokens; recurrentgemma-9b: head dim 256) does 4 D flops per
// kept (query, key) pair on about 4 S D bytes per head: a few hundred flops
// a byte, above the bf16 ridge (989 TFLOP/s over 3.35 TB/s), so the bound
// is the tensor cores' rate.
//
// K3, bf16 at head dims 64, 128 and 256 (flash_wgmma_kernel): a persistent
// grid, one block of three warpgroups per SM, walks the work items (a
// 128-row q tile of one head and batch each) in a fixed order, longest
// causal q tiles first.
//   - Warpgroup 0 is the producer: one thread issues TMA loads (tensor maps
//     over the strided [B, H, S, D] views, built on the host) of each
//     item's Q tile (double-buffered up to head dim 128, so the next item's
//     Q arrives while this one runs) and of K and V tiles into a two-stage
//     ring that runs on across items, with full / empty mbarrier pairs; K
//     and V have their own, so a K tile is refilled as soon as S is done
//     with it.  It gives up its registers (setmaxnreg) to
//   - warpgroups 1 and 2, the consumers, 64 q rows each.  S = Q K^T is one
//     wgmma chain with Q and K from shared memory (128-byte swizzle, as TMA
//     wrote them); the online softmax runs in registers; P, rounded to bf16
//     (as the TPU kernel rounds it, flash_attention.py:96-97), is the
//     register A operand of O += P V, with V read MN-major through its
//     descriptor (no transposing copy).  The softmax of tile j runs while
//     P V of tile j - 1 is in flight; O stays in registers (128 fp32 a
//     thread at head dim 256) and leaves, normalised, through the item's Q
//     buffer by TMA stores.
//   - KV tiles past the causal frontier or left of every row's window are
//     never loaded (kv_tile_range, as the TPU kernel skips them,
//     flash_attention.py:64-71); a consumer skips tiles outside its own 64
//     rows' range, and only boundary tiles (the diagonal, the window's left
//     edge, the ragged tail past sk) evaluate the mask; TMA's zero fill
//     covers rows past sq and sk, and keys past sk are still masked.
//   KV tiles: 128 keys at head dim <= 128 (193 KB of shared memory at
//   128), 64 at 256 (Q alone is 64 KB; 193 KB in all).
// Head dims 16 and 32 (the reference's sweep only) take flash_mma_kernel,
// mma.sync m16n8k16 with synchronous loads; float32 inputs (checks only)
// take a CUDA-core kernel of the same structure.
// Not yet done in K3: the exponentials (the special-function unit's 16 a
// clock per SM take about half the tensor time of a tile at head dim 128)
// overlap the products only as far as the two consumer warpgroups and the
// in-flight P V let them; the next item's Q at head dim 256 (one buffer)
// waits for the last item's stores.
//
// K4, bound.  Decode reads each valid K/V row once per kv head and does 4
// flops per element per q head of the group: it is bound by memory (bytes
// of the valid K/V rows over 3.35 TB/s on an H100 SXM).  One block owns one
// (cache split, kv head, batch) and serves the q heads of that kv head from
// one read of each row; B * Hkv blocks would leave most of the 132 SMs
// idle at serving batch sizes, so the cache axis is split across blocks
// (flash-decoding) and a second kernel combines the partial (max,
// normaliser, output) of the splits in ascending order.  Rows past
// seq_lens[b] and rows whose slot_pos fails the window rule are never read
// (the kernel reads slot_pos itself; no mask is built).
//   - bf16 (decode_tc_kernel): the group's q heads, padded to 16, are the M
//     side of mma.sync m16n8k16 tiles for Q K^T and for P V; up to 32 q
//     heads (two 16-head tiles) are served by one block, so one read of
//     each row serves every q head of recurrentgemma-9b's 16 and any group
//     of the model zoo.  Rows are staged in shared memory by cp.async
//     three stages deep (invalid rows are zero-filled, not read); the four
//     warps split the keys for the scores and the head dim for P V, and
//     share the tile's max and P (rounded to bf16, as the TPU kernel
//     rounds it, decode_attention.py:76) through shared memory.
//   - float32 (decode_split_kernel, checks only): CUDA cores, a lane per
//     D / 32 elements, up to kMaxGroup q heads in registers per block.
// Not yet done in K4: the combine fused into the split kernel (one launch
// fewer per call), TMA for the rows.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// each launcher returns cudaGetLastError() of its launch, or an error code
// of hopper::map_bf16 when a tensor map cannot be built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of dims (batch, head, row)
  long long b, h, s;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x by the special-function unit, flushing subnormal results to 0 (a
// probability below 2^-126 of the row's largest adds nothing to its sum).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -inf-safe exponent base: a row whose max is still -inf uses 0, so every
// exp2(-inf - 0) is 0 and nothing accumulates.
__device__ __forceinline__ float safe_max(float m) {
  return m == -INFINITY ? 0.0f : m;
}

__device__ __forceinline__ bool key_valid(int kpos, int qpos, int sk,
                                          int causal, int window) {
  return kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// The KV tiles [lo, hi) a q tile [q0, q0 + bq) needs: the rest are fully
// masked (past the causal frontier or left of every row's window).  Empty
// (lo = hi) when every row's window starts past the last key.
__device__ __forceinline__ void kv_tile_range(int q0, int bq, int bk, int sk,
                                              int causal, int window, int& lo,
                                              int& hi) {
  const int last = causal ? min(sk, q0 + bq) : sk;
  hi = (last + bk - 1) / bk;
  lo = window > 0 ? min(max(0, q0 - window + 1) / bk, hi) : 0;
}

// ---------------------------------------------------------------------------
// mma.sync helpers (m16n8k16, bf16 in, f32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: thread i gives the address of
// row i % 8 of matrix i / 8 and receives, per matrix, row i / 4, elements
// 2 (i % 4) and 2 (i % 4) + 1; transposed (.trans), elements (2 (i % 4),
// i / 4) and (2 (i % 4) + 1, i / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(smem_row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(smem_row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

using hopper::cp_async_16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// ---------------------------------------------------------------------------
// K3, bf16, head dims 64-256: TMA ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

template <int D>
struct WgShape {
  static constexpr int kBq = 128;                 // q rows per block
  static constexpr int kBk = D > 128 ? 64 : 128;  // keys per KV tile
  static constexpr int kStages = 2;
  static constexpr int kQStages = D > 128 ? 1 : 2;  // the next item's Q loads early
  static constexpr int kThreads = 384;  // producer + two consumer warpgroups
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kKVBytes = kBk * D * 2;  // one K (or V) tile
  static constexpr int kQSlab = kBq * 128;      // bytes of one 64-column slab
  static constexpr int kKVSlab = kBk * 128;
  static constexpr size_t kSmem = 1024 + kQStages * kQBytes + 2 * kStages * kKVBytes + 128;
};

// S[64 x kBk] = Q[64 x D] K^T: chained wgmmas over D, 16 at a time.
template <int D, int Bk>
__device__ __forceinline__ void qk_product(float (&s)[Bk / 2], uint32_t q_addr,
                                           uint32_t k_addr) {
  constexpr int kQSlab = WgShape<D>::kQSlab;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = hopper::wgmma_desc(q_addr + (kk / 4) * kQSlab + (kk % 4) * 32, 16, 1024);
    const uint64_t db = hopper::wgmma_desc(k_addr + (kk / 4) * Bk * 128 + (kk % 4) * 32, 16, 1024);
    if constexpr (Bk == 128) {
      hopper::wgmma_ss_n128(s, da, db, kk > 0);
    } else {
      hopper::wgmma_ss_n64(s, da, db, kk > 0);
    }
  }
}

// O[64 x D] += P[64 x Bk] V: P from registers, V MN-major from shared memory.
template <int D, int Bk>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&p)[Bk / 16][4],
                                           uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < Bk / 16; ++kk) {
    const uint64_t db = hopper::wgmma_desc(v_addr + kk * 2048, Bk * 128, 1024);
    if constexpr (D == 256) {
      hopper::wgmma_rs_n256(o, p[kk], db);
    } else if constexpr (D == 128) {
      hopper::wgmma_rs_n128(o, p[kk], db);
    } else {
      hopper::wgmma_rs_n64(o, p[kk], db);
    }
  }
}

// The online softmax of one tile of scores, in the wgmma accumulator
// layout: thread (warp w, lane 4 g + t) holds rows 16 w + g (half 0) and
// + 8 (half 1), and for each 8-key block n keys 8 n + 2 t, + 1 at
// s[4 n + 2 half + e].  Scales (and, kMask: boundary tiles only, masks)
// the scores, replaces them by P, updates each row's running max and this
// thread's share of its sum, and returns the factor that rescales the
// output accumulated so far.
template <bool kMask, int Bk>
__device__ __forceinline__ void tile_softmax(float (&s)[Bk / 2], float (&m_run)[2],
                                             float (&l_part)[2], float (&corr)[2],
                                             float scale_log2, int k0, int row0, int t, int sk,
                                             int causal, int window) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float m = -INFINITY;
#pragma unroll
    for (int n = 0; n < Bk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * n + 2 * half + e] * scale_log2;
        if constexpr (kMask) {
          x = key_valid(k0 + 8 * n + 2 * t + e, row0 + 8 * half, sk, causal, window) ? x
                                                                                     : -INFINITY;
        }
        s[4 * n + 2 * half + e] = x;
        m = fmaxf(m, x);
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[half], m);
    const float base = safe_max(m_new);
    corr[half] = fast_exp2(m_run[half] - base);
    m_run[half] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < Bk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(s[4 * n + 2 * half + e] - base);
        s[4 * n + 2 * half + e] = p;
        sum += p;
      }
    }
    l_part[half] = l_part[half] * corr[half] + sum;
  }
}

// P (the softmax's s) as bf16 A fragments of 16-key slices.
template <int Bk>
__device__ __forceinline__ void pack_p(const float (&s)[Bk / 2], uint32_t (&pa)[Bk / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < Bk / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// The work items of a launch: one per (128-row q tile, head, batch), the
// longest causal q tiles first.  Block j of G persistent blocks takes item
// r G + j in even rounds r and r G + G - 1 - j in odd ones (a snake over the
// sorted lengths balances the blocks as well as greedy assignment does at
// the serving shapes), so the schedule is fixed and needs no counter.
struct FlashItem {
  int q0, h, b;
};
__device__ __forceinline__ int flash_item_at(int round, int n_items) {
  const int g = gridDim.x;
  const int i = round * g + (round & 1 ? g - 1 - static_cast<int>(blockIdx.x) : blockIdx.x);
  return i < n_items ? i : -1;
}
__device__ __forceinline__ FlashItem flash_item(int i, int n_qt, int hq, int batch) {
  const int n_bh = hq * batch;
  return {(n_qt - 1 - i / n_bh) * 128, i % n_bh % hq, i % n_bh / hq};
}

// grid min(items, SMs), persistent; block 384; dynamic shared memory
// WgShape<D>::kSmem.  tm_q / tm_k / tm_v / tm_o: tensor maps over (d,
// row, head, batch) with boxes of 128 (q), kBk (k, v) or 64 (o) rows x 64
// columns.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, int hq, int batch, int group,
                       int sq, int sk, float scale_log2, int causal, int window) {
  using Sh = WgShape<D>;
  constexpr int kBk = Sh::kBk;
  constexpr int kStages = Sh::kStages;
  constexpr int kQStages = Sh::kQStages;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* s_q = smem;                              // Q buffer i at + i * kQBytes
  unsigned char* s_k = s_q + kQStages * Sh::kQBytes;      // stage i at + i * kKVBytes
  unsigned char* s_v = s_k + kStages * Sh::kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(s_v + kStages * Sh::kKVBytes);
  uint64_t* empty_q = full_q + kQStages;  // 2 arrivals: each consumer warpgroup's store
  uint64_t* full_k = empty_q + kQStages;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;  // 8 arrivals: each consumer warp once
  uint64_t* empty_v = empty_k + kStages;

  const int n_qt = (sq + Sh::kBq - 1) / Sh::kBq;
  const int n_items = n_qt * hq * batch;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQStages; ++i) {
      hopper::mbar_init(&full_q[i], 1);
      hopper::mbar_init(&empty_q[i], 2);
    }
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full_k[i], 1);
      hopper::mbar_init(&full_v[i], 1);
      hopper::mbar_init(&empty_k[i], 8);
      hopper::mbar_init(&empty_v[i], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread issues the copies
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;  // position in the K/V ring, across items
      for (int round = 0, i; (i = flash_item_at(round, n_items)) >= 0; ++round) {
        const FlashItem w = flash_item(i, n_qt, hq, batch);
        const int hk = w.h / group;
        const int qs = round % kQStages;
        hopper::mbar_wait(&empty_q[qs], ((round / kQStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full_q[qs], Sh::kQBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(s_q + qs * Sh::kQBytes + c * Sh::kQSlab, &tm_q, 64 * c, w.q0, w.h,
                              w.b, &full_q[qs]);
        }
        int lo, hi;
        kv_tile_range(w.q0, Sh::kBq, kBk, sk, causal, window, lo, hi);
        for (int tile = lo; tile < hi; ++tile, ++it) {
          const int st = it % kStages;
          const uint32_t ph = ((it / kStages) & 1) ^ 1;
          hopper::mbar_wait(&empty_k[st], ph);
          hopper::mbar_expect_tx(&full_k[st], Sh::kKVBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(s_k + st * Sh::kKVBytes + c * Sh::kKVSlab, &tm_k, 64 * c,
                                tile * kBk, hk, w.b, &full_k[st]);
          }
          hopper::mbar_wait(&empty_v[st], ph);
          hopper::mbar_expect_tx(&full_v[st], Sh::kKVBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(s_v + st * Sh::kKVBytes + c * Sh::kKVSlab, &tm_v, 64 * c,
                                tile * kBk, hk, w.b, &full_v[st]);
          }
        }
      }
    }
  } else {  // consumer warpgroups: 64 q rows each
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x - 128;
    const int cw = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    int it_base = 0;  // ring position of the item's first tile

    for (int round = 0, i; (i = flash_item_at(round, n_items)) >= 0; ++round) {
      const FlashItem w = flash_item(i, n_qt, hq, batch);
      const int qs = round % kQStages;
      int lo, hi;
      kv_tile_range(w.q0, Sh::kBq, kBk, sk, causal, window, lo, hi);
      const int r_lo = w.q0 + 64 * cw;        // this warpgroup's first row
      const int row0 = r_lo + 16 * warp + g;  // this thread's rows: row0, row0 + 8
      int lo_w, hi_w;                         // the tiles its rows need
      kv_tile_range(r_lo, 64, kBk, sk, causal, window, lo_w, hi_w);
      if (r_lo >= sq) hi_w = lo_w;

      float acc[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
      float m_run[2] = {-INFINITY, -INFINITY};
      float l_part[2] = {0.0f, 0.0f};  // this thread's share of each row's sum
      unsigned char* s_qw = s_q + qs * Sh::kQBytes + cw * 64 * 128;  // this warpgroup's rows
      const uint32_t q_addr = hopper::smem_addr(s_qw);
      auto slot = [&](int tile) { return (it_base + tile - lo) % kStages; };
      auto phase = [&](int tile) {
        return static_cast<uint32_t>((it_base + tile - lo) / kStages & 1);
      };
      auto k_addr = [&](int tile) { return hopper::smem_addr(s_k + slot(tile) * Sh::kKVBytes); };
      auto v_addr = [&](int tile) { return hopper::smem_addr(s_v + slot(tile) * Sh::kKVBytes); };
      // each K tile is released once S is done, each V tile once P V is
      auto release_k = [&](int tile) {
        if (lane == 0) hopper::mbar_arrive(&empty_k[slot(tile)]);
      };
      auto release_v = [&](int tile) {
        if (lane == 0) hopper::mbar_arrive(&empty_v[slot(tile)]);
      };
      auto skip = [&](int tile) {  // a tile these rows do not need
        hopper::mbar_wait(&full_k[slot(tile)], phase(tile));
        release_k(tile);
        hopper::mbar_wait(&full_v[slot(tile)], phase(tile));
        release_v(tile);
      };
      // scores of a tile -> P in place, the running max and sum; mask only
      // where it cuts
      auto softmax = [&](float (&s)[kBk / 2], int tile, float (&corr)[2]) {
        const int k0 = tile * kBk;
        const bool interior = k0 + kBk <= sk && (!causal || k0 + kBk - 1 <= r_lo) &&
                              (window <= 0 || k0 > r_lo + 63 - window);
        if (interior) {
          tile_softmax<false, kBk>(s, m_run, l_part, corr, scale_log2, k0, row0, t, sk, causal,
                                   window);
        } else {
          tile_softmax<true, kBk>(s, m_run, l_part, corr, scale_log2, k0, row0, t, sk, causal,
                                  window);
        }
      };
      auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= corr[0];
          acc[4 * n + 1] *= corr[0];
          acc[4 * n + 2] *= corr[1];
          acc[4 * n + 3] *= corr[1];
        }
      };

      // The tiles of [lo, hi) outside these rows' own [a, e) are released
      // unread.  Over [a, e) the products overlap the softmax: while the
      // softmax of tile j runs, S of tile j is done and P V of tile j - 1
      // is in flight; the output is rescaled and the new P packed once that
      // product is done (no register a product in flight reads is
      // written), so the sums are taken in the same order as one tile at a
      // time.
      const int a = max(lo, lo_w);
      const int e = min(hi, hi_w);
      hopper::mbar_wait(&full_q[qs], (round / kQStages) & 1);
      for (int tile = lo; tile < min(a, hi); ++tile) skip(tile);
      if (a < e) {
        float s[kBk / 2];
        uint32_t pa[kBk / 16][4];
        float corr[2];
        hopper::mbar_wait(&full_k[slot(a)], phase(a));
        hopper::wgmma_fence();
        qk_product<D, kBk>(s, q_addr, k_addr(a));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        release_k(a);
        softmax(s, a, corr);  // the output is still 0: nothing to rescale
        pack_p<kBk>(s, pa);
        for (int tile = a + 1; tile < e; ++tile) {
          hopper::mbar_wait(&full_k[slot(tile)], phase(tile));
          hopper::mbar_wait(&full_v[slot(tile - 1)], phase(tile - 1));
          hopper::wgmma_fence();
          qk_product<D, kBk>(s, q_addr, k_addr(tile));
          hopper::wgmma_commit();
          pv_product<D, kBk>(acc, pa, v_addr(tile - 1));
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // S of this tile
          hopper::fence_regs(s);
          release_k(tile);
          softmax(s, tile, corr);
          hopper::wgmma_wait<0>();  // P V of the previous tile
          hopper::fence_regs(acc);
          release_v(tile - 1);
          rescale(corr);
          pack_p<kBk>(s, pa);
        }
        hopper::mbar_wait(&full_v[slot(e - 1)], phase(e - 1));
        hopper::wgmma_fence();
        pv_product<D, kBk>(acc, pa, v_addr(e - 1));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release_v(e - 1);
      }
      for (int tile = max(e, a); tile < hi; ++tile) skip(tile);
      it_base += hi - lo;

      // Each row's normaliser is the sum of its 4 threads' shares.  O
      // goes, normalised and in bf16, to this warpgroup's rows of the Q
      // buffer (free now) in the same swizzled slabs, and from there to
      // global memory by one TMA store per slab; rows past sq fall outside
      // the tensor map.  The Q buffer is handed back once the stores have
      // read it.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float l = l_part[half];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // fully masked row -> 0
        const int r = 16 * warp + g + 8 * half;         // row of the warpgroup's 64
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(s_qw + (n / 8) * Sh::kQSlab + r * 128 +
                                       (((n % 8) ^ (r % 8)) * 16) + 4 * t) =
              pack_bf16(acc[4 * n + 2 * half] * inv, acc[4 * n + 2 * half + 1] * inv);
        }
      }
      hopper::fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // this warpgroup's writes
      if ((tid & 127) == 0) {
        if (r_lo < sq) {
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_store_4d(&tm_o, s_qw + c * Sh::kQSlab, 64 * c, r_lo, w.h, w.b);
          }
          hopper::tma_store_wait();
        }
        hopper::mbar_arrive(&empty_q[qs]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3, bf16, head dims 16 and 32: mma.sync, synchronous loads
// ---------------------------------------------------------------------------

constexpr int kBq = 64;  // q rows per block, 16 per warp
constexpr int kMmaBk = 64;
constexpr int kMmaThreads = 128;

// Loads rows [r0, r0 + R) of a [rows, D] bf16 matrix (row stride `ld`
// elements, last dim contiguous, 16-byte aligned) into shared memory with
// row stride D + 8; rows at or past `rows` are zero.
template <int D, int R>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* sm,
                                               const __nv_bfloat16* g,
                                               long long ld, int r0,
                                               int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(g + (r0 + r) * ld + c);
    }
    *reinterpret_cast<uint4*>(sm + r * (D + 8) + c) = val;
  }
}

// grid (ceil(sq / kBq), hq, batch); block kMmaThreads.
//
// Warp w owns q rows q0 + 16 w .. + 15.  In the mma fragments, thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 of the warp's 16, and
// score columns (keys) 8 n + 2 t, + 1 of each 8-key slice n.  The score
// accumulator of two neighbouring 8-key slices is, packed to bf16, the A
// fragment of the P V product for those 16 keys (no trip through shared
// memory); V's B fragments come transposed from shared memory by ldmatrix.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                     Strides vs, Strides os, int group, int sq, int sk,
                     float scale_log2, int causal, int window) {
  constexpr int kS = D + 8;  // padded shared row: conflict-free fragments
  constexpr int kBk = kMmaBk;
  __shared__ __align__(16) __nv_bfloat16 sk_tile[kBk * kS];
  __shared__ __align__(16) __nv_bfloat16 sv_tile[kBk * kS];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;

  // Q as A fragments, kept in registers for the whole KV loop
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // row0, row0 + 8
      const int r = row0 + 8 * half;
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns 2t.., 8 + 2t..
        uint32_t val = 0u;
        if (r < sq) {
          val = *reinterpret_cast<const uint32_t*>(qb + r * qs.s + kk * 16 +
                                                   8 * c + 2 * t);
        }
        qa[kk][half + 2 * c] = val;
      }
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.0f, 0.0f};  // this thread's share of each row's sum

  int lo, hi;
  kv_tile_range(q0, kBq, kBk, sk, causal, window, lo, hi);
  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kBk;
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<D, kBk>(sk_tile, kb, ks.s, k0, sk);
    load_tile_bf16<D, kBk>(sv_tile, vb, vs.s, k0, sk);
    __syncthreads();

    float s[kBk / 8][4];
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
        const __nv_bfloat16* kr = sk_tile + (n * 8 + g) * kS + kk * 16 + 2 * t;
        mma_16816(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, running max (the 4 threads of a row share it)
    float m_new[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = row0 + 8 * half;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + n * 8 + 2 * t + e;
          float x = s[n][2 * half + e] * scale_log2;
          x = key_valid(kpos, qpos, sk, causal, window) ? x : -INFINITY;
          s[n][2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[half] = fmaxf(m_run[half], mx);
    }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float base = safe_max(m_new[half]);
      corr[half] = exp2f(m_run[half] - base);
      m_run[half] = m_new[half];
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * half + e] - base);
          s[n][2 * half + e] = p;
          sum += p;
        }
      }
      l_part[half] = l_part[half] * corr[half] + sum;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P V, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mat = lane >> 3;  // 0: keys 0-7, 1: keys 8-15 (of 16), x2 for d
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, sv_tile + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * kS +
                                   (n + (mat >> 1)) * 8);
        mma_16816(acc[n], pa, vb4[0], vb4[1]);
        mma_16816(acc[n + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

  // each row's normaliser is the sum of its 4 threads' shares
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_part[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // fully masked row -> 0
    const int r = row0 + 8 * half;
    if (r < sq) {
      __nv_bfloat16* orow = o + b * os.b + h * os.h + r * os.s;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3, float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Bq = 16;  // q rows per block, 4 per warp (smem < 48 KB)
constexpr int kF32Bk = 32;  // keys per KV tile, one per lane
constexpr int kF32Threads = 128;

template <int D>
constexpr size_t flash_f32_smem_bytes() {
  return sizeof(float) * (kF32Bq * D + kF32Bk * (D + 1) + kF32Bk * D);
}

// grid (ceil(sq / kF32Bq), hq, batch); block kF32Threads; dynamic shared
// memory flash_f32_smem_bytes<D>().  Lane j scores key j of the tile
// against the warp's 4 rows; the probabilities are then broadcast by
// shuffles and lane j accumulates output columns j + 32 c.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides qs, Strides ks, Strides vs, Strides os, int group,
                     int sq, int sk, float scale_log2, int causal, int window) {
  constexpr int kRows = kF32Bq / 4;
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ float flash_f32_smem[];
  auto sq_tile = reinterpret_cast<float(*)[D]>(flash_f32_smem);
  auto sk_tile = reinterpret_cast<float(*)[D + 1]>(  // +1: lanes hit distinct banks
      flash_f32_smem + kF32Bq * D);
  auto sv_tile = reinterpret_cast<float(*)[D]>(flash_f32_smem + kF32Bq * D +
                                               kF32Bk * (D + 1));

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kF32Bq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;

  for (int i = threadIdx.x; i < kF32Bq * D; i += kF32Threads) {
    const int r = i / D;
    const int c = i % D;
    sq_tile[r][c] = q0 + r < sq ? qb[(q0 + r) * qs.s + c] : 0.0f;
  }
  float acc[kRows][kCols];
  float m_run[kRows];
  float l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  int lo, hi;
  kv_tile_range(q0, kF32Bq, kF32Bk, sk, causal, window, lo, hi);
  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kF32Bk;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Bk * D; i += kF32Threads) {
      const int r = i / D;
      const int c = i % D;
      const bool in = k0 + r < sk;
      sk_tile[r][c] = in ? kb[(k0 + r) * ks.s + c] : 0.0f;
      sv_tile[r][c] = in ? vb[(k0 + r) * vs.s + c] : 0.0f;
    }
    __syncthreads();

    float x[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kd = sk_tile[lane][d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        x[i] = fmaf(sq_tile[warp * kRows + i][d], kd, x[i]);
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + warp * kRows + i;
      float xi = key_valid(kpos, qpos, sk, causal, window) ? x[i] * scale_log2
                                                           : -INFINITY;
      float mx = xi;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[i], mx);
      const float base = safe_max(m_new);
      const float corr = exp2f(m_run[i] - base);
      const float p = exp2f(xi - base);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      m_run[i] = m_new;
      l_run[i] = l_run[i] * corr + sum;
      x[i] = p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    for (int j = 0; j < kF32Bk; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        vj[c] = lane + 32 * c < D ? sv_tile[j][lane + 32 * c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = __shfl_sync(0xffffffffu, x[i], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vj[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + warp * kRows + i;
    if (r >= sq) continue;
    const float inv = l_run[i] > 0.0f ? 1.0f / l_run[i] : 0.0f;
    float* orow = o + b * os.b + h * os.h + r * os.s;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (lane + 32 * c < D) orow[lane + 32 * c] = acc[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// K4, bf16: tensor cores over the group's q heads, cp.async ring
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;

template <int D, int Ht>
struct DecShape {
  static constexpr int kTk = D > 128 ? 32 : 64;  // keys per tile
  static constexpr int kStages = 3;
  static constexpr int kRow = D + 8;              // padded shared row (elements)
  static constexpr int kPRow = kTk + 8;
  static constexpr int kWarpKeys = kTk / kDecWarps;  // keys each warp scores
  static constexpr int kDw = D / kDecWarps;          // output columns each warp owns
  static constexpr size_t kKVElems = static_cast<size_t>(kTk) * kRow;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (2 * kStages * kKVElems + Ht * 16 * kRow + Ht * 16 * kPRow) +
      sizeof(int) * kStages * kTk + sizeof(float) * (Ht * kDecWarps * 16 + kDecWarps * Ht * 16);
};

// grid (n_split, hkv * n_gc, batch); block kDecThreads; dynamic shared
// memory DecShape<D, Ht>::kSmem.  The block scores keys [split * chunk,
// min((split + 1) * chunk, len)) of kv head blockIdx.y / n_gc against its
// q heads [g0, g0 + 16 Ht) of the group (g0 = (blockIdx.y % n_gc) * 16 Ht);
// len = seq_lens[b] (s_cap without seq_lens), and with slot_pos key j also
// needs slot_pos[j] > lo, lo = max(*slot_lo, -1) read once per block (-1
// when slot_lo is null, so an empty slot, -1, never counts).
//
// Per tile of kTk keys: warp w scores keys w kTk/4 .. + kTk/4 - 1 for all
// heads (A = Q from shared memory, B = K rows), the tile's max per head is
// shared through shared memory, P (bf16) is written there, and warp w adds
// P V for output columns w D/4 .. + D/4 - 1 (B = V rows, transposed by
// ldmatrix).  Every warp keeps the same running max per head; each keeps
// its share of the normaliser, summed in warp order at the end.
template <int D, int Ht>
__global__ void __launch_bounds__(kDecThreads)
    decode_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seq_lens,
                     const int* __restrict__ slot_pos, const int* __restrict__ slot_lo,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc, Strides qs, Strides ks, Strides vs, int hq,
                     int group, int n_gc, int s_cap, int chunk, float scale_log2) {
  using Sh = DecShape<D, Ht>;
  constexpr int kTk = Sh::kTk;
  constexpr int kStages = Sh::kStages;
  constexpr int kRow = Sh::kRow;
  constexpr int kPRow = Sh::kPRow;
  constexpr int kNb = Sh::kWarpKeys / 8;  // 8-key score blocks per warp
  constexpr int kOb = Sh::kDw / 8;        // 8-column output blocks per warp
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(dec_smem);  // [stage][kTk][kRow]
  __nv_bfloat16* s_v = s_k + kStages * Sh::kKVElems;
  __nv_bfloat16* s_q = s_v + kStages * Sh::kKVElems;  // [Ht][16][kRow]
  __nv_bfloat16* s_p = s_q + Ht * 16 * kRow;          // [Ht][16][kPRow]
  int* s_ok = reinterpret_cast<int*>(s_p + Ht * 16 * kPRow);  // [stage][kTk]
  float* s_max = reinterpret_cast<float*>(s_ok + kStages * kTk);  // [Ht][warp][16]
  float* s_l = s_max + Ht * kDecWarps * 16;                       // [warp][Ht][16]

  const int split = blockIdx.x;
  const int hk = blockIdx.y / n_gc;
  const int g0 = (blockIdx.y % n_gc) * 16 * Ht;
  const int ng = min(16 * Ht, group - g0);
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int len = seq_lens == nullptr ? s_cap : min(max(seq_lens[b], 0), s_cap);
  const int lo = slot_lo == nullptr ? -1 : max(*slot_lo, -1);
  const int j0 = split * chunk;
  const int j1 = min(j0 + chunk, len);
  const int n_tiles = j1 > j0 ? (j1 - j0 + kTk - 1) / kTk : 0;

  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  // the group's q heads, zero past ng (read once, synchronously)
  for (int i = threadIdx.x; i < Ht * 16 * (D / 8); i += kDecThreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < ng) {
      val = *reinterpret_cast<const uint4*>(q + b * qs.b + (hk * group + g0 + r) * qs.h + c);
    }
    *reinterpret_cast<uint4*>(s_q + r * kRow + c) = val;
  }

  // rows [j, j + kTk) into a stage; rows that fail validity are zero-filled
  // and never read
  auto load_tile = [&](int tile, int st) {
    const int jt = j0 + tile * kTk;
    __nv_bfloat16* dk = s_k + st * Sh::kKVElems;
    __nv_bfloat16* dv = s_v + st * Sh::kKVElems;
    for (int i = threadIdx.x; i < kTk * (D / 8); i += kDecThreads) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      const int j = jt + r;
      const bool ok = j < j1 && (slot_pos == nullptr || slot_pos[j] > lo);
      const long long jr = ok ? j : 0;
      cp_async_16(dk + r * kRow + c, kb + jr * ks.s + c, ok ? 16 : 0);
      cp_async_16(dv + r * kRow + c, vb + jr * vs.s + c, ok ? 16 : 0);
      if (c == 0) s_ok[st * kTk + r] = ok;
    }
  };

  float acc[Ht][kOb][4];
  float m_run[Ht][2];
  float l_part[Ht][2];  // this thread's share, over its keys
#pragma unroll
  for (int ht = 0; ht < Ht; ++ht) {
#pragma unroll
    for (int n = 0; n < kOb; ++n) acc[ht][n][0] = acc[ht][n][1] = acc[ht][n][2] = acc[ht][n][3] = 0.0f;
    m_run[ht][0] = m_run[ht][1] = -INFINITY;
    l_part[ht][0] = l_part[ht][1] = 0.0f;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile landed for every thread; the last one is done with
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int st = it % kStages;
    const __nv_bfloat16* tk = s_k + st * Sh::kKVElems;
    const __nv_bfloat16* tv = s_v + st * Sh::kKVElems;
    const int* ok = s_ok + st * kTk;
    const int kw = warp * Sh::kWarpKeys;  // this warp's first key of the tile

    // scores of this warp's keys: s[ht][nb] (heads g, g + 8; keys kw + 8 nb + 2 t, + 1)
    float s[Ht][kNb][4];
#pragma unroll
    for (int ht = 0; ht < Ht; ++ht) {
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) s[ht][nb][0] = s[ht][nb][1] = s[ht][nb][2] = s[ht][nb][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t kf[kNb][4];  // B fragments of slices kk and kk + 1
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        ldmatrix_x4(kf[nb], tk + (kw + 8 * nb + (lane & 7)) * kRow + 16 * kk + 8 * (lane >> 3));
      }
#pragma unroll
      for (int ht = 0; ht < Ht; ++ht) {
        uint32_t qa[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          ldmatrix_x4(qa[x], s_q + (ht * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRow +
                                 16 * (kk + x) + 8 * (lane >> 4));
        }
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb) {
          mma_16816(s[ht][nb], qa[0], kf[nb][0], kf[nb][1]);
          mma_16816(s[ht][nb], qa[1], kf[nb][2], kf[nb][3]);
        }
      }
    }

    // scale, mask, this warp's max per head -> shared
#pragma unroll
    for (int ht = 0; ht < Ht; ++ht) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = ok[kw + 8 * nb + 2 * t + e] ? s[ht][nb][2 * half + e] * scale_log2
                                                        : -INFINITY;
            s[ht][nb][2 * half + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (t == 0) s_max[(ht * kDecWarps + warp) * 16 + g + 8 * half] = mx;
      }
    }
    __syncthreads();

    // the tile's max per head (every warp alike), P (bf16) -> shared
    float corr[Ht][2];
#pragma unroll
    for (int ht = 0; ht < Ht; ++ht) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, s_max[(ht * kDecWarps + w) * 16 + g + 8 * half]);
        const float m_new = fmaxf(m_run[ht][half], mx);
        const float base = safe_max(m_new);
        corr[ht][half] = exp2f(m_run[ht][half] - base);
        m_run[ht][half] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb) {
          const float p0 = exp2f(s[ht][nb][2 * half] - base);
          const float p1 = exp2f(s[ht][nb][2 * half + 1] - base);
          sum += p0 + p1;
          *reinterpret_cast<uint32_t*>(s_p + (ht * 16 + g + 8 * half) * kPRow + kw + 8 * nb + 2 * t) =
              pack_bf16(p0, p1);
        }
        l_part[ht][half] = l_part[ht][half] * corr[ht][half] + sum;
      }
    }
    __syncthreads();

    // acc += P V over this warp's output columns
#pragma unroll
    for (int ht = 0; ht < Ht; ++ht) {
      uint32_t pa[kTk / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTk / 16; ++kk) {
        ldmatrix_x4(pa[kk], s_p + (ht * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kPRow + 16 * kk +
                                8 * (lane >> 4));
      }
#pragma unroll
      for (int n = 0; n < kOb; ++n) {
        acc[ht][n][0] *= corr[ht][0];
        acc[ht][n][1] *= corr[ht][0];
        acc[ht][n][2] *= corr[ht][1];
        acc[ht][n][3] *= corr[ht][1];
#pragma unroll
        for (int kk = 0; kk < kTk / 16; kk += 2) {
          uint32_t vf[4];  // B fragments of key slices kk and kk + 1
          ldmatrix_x4_trans(vf, tv + (16 * kk + lane) * kRow + warp * Sh::kDw + 8 * n);
          mma_16816(acc[ht][n], pa[kk], vf[0], vf[1]);
          mma_16816(acc[ht][n], pa[kk + 1], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the normaliser: each thread's share -> its warp's -> the block's, in
  // warp order
#pragma unroll
  for (int ht = 0; ht < Ht; ++ht) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = l_part[ht][half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t == 0) s_l[(warp * Ht + ht) * 16 + g + 8 * half] = l;
    }
  }
  __syncthreads();
#pragma unroll
  for (int ht = 0; ht < Ht; ++ht) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gq = ht * 16 + g + 8 * half;
      if (gq >= ng) continue;
      const long long row =
          (static_cast<long long>(b) * hq + hk * group + g0 + gq) * n_split + split;
      if (warp == 0 && t == 0) {
        float l = 0.0f;
        for (int w = 0; w < kDecWarps; ++w) l += s_l[(w * Ht + ht) * 16 + g + 8 * half];
        part_m[row] = m_run[ht][half];
        part_l[row] = l;
      }
#pragma unroll
      for (int n = 0; n < kOb; ++n) {
        *reinterpret_cast<float2*>(part_acc + row * D + warp * Sh::kDw + 8 * n + 2 * t) =
            make_float2(acc[ht][n][2 * half], acc[ht][n][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4, float32: CUDA cores, split-cache, and the combine pass of both
// ---------------------------------------------------------------------------

constexpr int kMaxGroup = 8;  // q heads per block

// K/V rows each warp loads before using them: fewer at head dim 256, where
// each row takes 8 registers a lane.
template <int D>
constexpr int kDecUnroll = D > 128 ? 2 : 4;

template <int E>
__device__ __forceinline__ void load_row(float (&dst)[E], const float* src) {
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = src[e];
}

// grid (n_split, hkv * n_gc, batch); block kDecThreads.  The block scores
// keys [split * chunk, min((split + 1) * chunk, len)) of kv head
// blockIdx.y / n_gc against its q heads [g0, g0 + kMaxGroup) of the group,
// g0 = (blockIdx.y % n_gc) * kMaxGroup (len and slot_pos as for
// decode_tc_kernel).  Lane l holds elements [l E, l E + E) of each row
// (E = D / 32); warp w takes keys w U, w U + 1, ... of the split, U at a
// time, and keeps its own running (max, sum, output) per q head; the four
// warps are combined in order at the end and written as this split's
// partial.
template <int D>
__global__ void __launch_bounds__(kDecThreads)
    decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ seq_lens,
                        const int* __restrict__ slot_pos, const int* __restrict__ slot_lo,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, Strides qs, Strides ks,
                        Strides vs, int hq, int group, int n_gc, int s_cap,
                        int chunk, float scale_log2) {
  constexpr int E = D / 32;
  constexpr int U = kDecUnroll<D>;
  __shared__ float sh_m[kDecWarps][kMaxGroup];
  __shared__ float sh_l[kDecWarps][kMaxGroup];
  __shared__ float sh_acc[kDecWarps][kMaxGroup][D];

  const int split = blockIdx.x;
  const int hk = blockIdx.y / n_gc;
  const int g0 = (blockIdx.y % n_gc) * kMaxGroup;
  const int ng = min(kMaxGroup, group - g0);
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = seq_lens == nullptr ? s_cap : min(max(seq_lens[b], 0), s_cap);
  const int lo = slot_lo == nullptr ? -1 : max(*slot_lo, -1);
  const int j0 = split * chunk;
  const int j1 = min(j0 + chunk, len);

  float qr[kMaxGroup][E];
  float m_run[kMaxGroup];
  float l_run[kMaxGroup];
  float acc[kMaxGroup][E];
#pragma unroll
  for (int gq = 0; gq < kMaxGroup; ++gq) {
    m_run[gq] = -INFINITY;
    l_run[gq] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[gq][e] = 0.0f;
      qr[gq][e] = 0.0f;
    }
    if (gq < ng) {
      load_row<E>(qr[gq], q + b * qs.b + (hk * group + g0 + gq) * qs.h + lane * E);
    }
  }
  const float* kb = k + b * ks.b + hk * ks.h + lane * E;
  const float* vb = v + b * vs.b + hk * vs.h + lane * E;

  for (int j = j0 + warp * U; j < j1; j += kDecWarps * U) {
    bool ok[U];  // the same for every lane of the warp
    float kr[U][E];
    float vr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = j + u < j1 && (slot_pos == nullptr || slot_pos[j + u] > lo);
      if (ok[u]) {
        load_row<E>(kr[u], kb + (j + u) * ks.s);
        load_row<E>(vr[u], vb + (j + u) * vs.s);
      }
    }
#pragma unroll
    for (int gq = 0; gq < kMaxGroup; ++gq) {
      if (gq >= ng) break;
      float x[U];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.0f;
        if (ok[u]) {
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[gq][e], kr[u][e], dot);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        x[u] = ok[u] ? dot * scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[u]);
      }
      const float m_new = fmaxf(m_run[gq], mx);
      const float base = safe_max(m_new);
      const float corr = exp2f(m_run[gq] - base);
      m_run[gq] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gq][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(x[u] - base);
        sum += p;
        if (ok[u]) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[gq][e] = fmaf(p, vr[u][e], acc[gq][e]);
        }
      }
      l_run[gq] = l_run[gq] * corr + sum;
    }
  }

#pragma unroll
  for (int gq = 0; gq < kMaxGroup; ++gq) {
    if (gq >= ng) break;
    if (lane == 0) {
      sh_m[warp][gq] = m_run[gq];
      sh_l[warp][gq] = l_run[gq];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sh_acc[warp][gq][lane * E + e] = acc[gq][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += kDecThreads) {
    const int gq = i / D;
    const int d = i % D;
    float mx = -INFINITY;
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sh_m[w][gq]);
    const float base = safe_max(mx);
    float l = 0.0f;
    float a = 0.0f;
    for (int w = 0; w < kDecWarps; ++w) {  // fixed order
      const float wt = exp2f(sh_m[w][gq] - base);
      l += sh_l[w][gq] * wt;
      a += sh_acc[w][gq][d] * wt;
    }
    const long long row =
        (static_cast<long long>(b) * hq + hk * group + g0 + gq) * n_split + split;
    part_acc[row * D + d] = a;
    if (d == 0) {
      part_m[row] = mx;
      part_l[row] = l;
    }
  }
}

// grid (hq, batch); block D.  out = sum_s acc_s 2^(m_s - M) / sum_s l_s
// 2^(m_s - M) over the splits in ascending order; no valid key -> 0.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ o, Strides os, int hq,
                                      int n_split, int d_head) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const long long row0 = (static_cast<long long>(b) * hq + h) * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[row0 + s]);
  const float base = safe_max(mx);
  float l = 0.0f;
  float a = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float wt = exp2f(part_m[row0 + s] - base);
    l += part_l[row0 + s] * wt;
    a += part_acc[(row0 + s) * d_head + d] * wt;
  }
  o[b * os.b + h * os.h + d] = from_float<T>(l > 0.0f ? a / l : 0.0f);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename F>
int allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int is_bf16, int b, int hq, int hkv, int sq, int sk,
                 const long long* st, float scale_log2, int causal, int window,
                 cudaStream_t stream) {
  const int group = hq / hkv;
  if (!is_bf16) {
    constexpr size_t smem = flash_f32_smem_bytes<D>();
    const int err = allow_smem(flash_f32_kernel<D>, smem);
    if (err) return err;
    const dim3 grid((sq + kF32Bq - 1) / kF32Bq, hq, b);
    flash_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), group, sq, sk, scale_log2, causal, window);
  } else if constexpr (D >= 64) {
    using Sh = WgShape<D>;
    CUtensorMap mq, mk, mv, mo;
    const int sk_rows = sk > 0 ? sk : 1;  // no tile is loaded when sk is 0
    int err = hopper::map_bf16(&mq, q, D, sq, hq, b, st[2], st[1], st[0], Sh::kBq);
    if (!err) err = hopper::map_bf16(&mk, k, D, sk_rows, hkv, b, st[5], st[4], st[3], Sh::kBk);
    if (!err) err = hopper::map_bf16(&mv, v, D, sk_rows, hkv, b, st[8], st[7], st[6], Sh::kBk);
    if (!err) err = hopper::map_bf16(&mo, o, D, sq, hq, b, st[11], st[10], st[9], 64);
    if (!err) err = allow_smem(flash_wgmma_kernel<D>, Sh::kSmem);
    int dev = 0, n_sm = 0;
    if (!err) err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
    const int blocks = min((sq + Sh::kBq - 1) / Sh::kBq * hq * b, n_sm);
    flash_wgmma_kernel<D><<<blocks, Sh::kThreads, Sh::kSmem, stream>>>(
        mq, mk, mv, mo, hq, b, group, sq, sk, scale_log2, causal, window);
  } else {
    const dim3 grid((sq + kBq - 1) / kBq, hq, b);
    flash_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), group, sq, sk, scale_log2, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode_tc(const void* q, const void* k, const void* v, const int* seq_lens,
                     const int* slot_pos, const int* slot_lo, float* part_m, float* part_l,
                     float* part_acc, int b, int hq, int hkv, int s_cap, int n_split,
                     int chunk, const long long* st, float scale_log2, cudaStream_t stream) {
  const int group = hq / hkv;
  auto launch = [&](auto kernel, size_t smem, int heads) {
    const int err = allow_smem(kernel, smem);
    if (err) return err;
    const int n_gc = (group + heads - 1) / heads;
    kernel<<<dim3(n_split, hkv * n_gc, b), kDecThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seq_lens, slot_pos, slot_lo, part_m, part_l,
        part_acc, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), hq, group, n_gc,
        s_cap, chunk, scale_log2);
    return 0;
  };
  return group <= 16 ? launch(decode_tc_kernel<D, 1>, DecShape<D, 1>::kSmem, 16)
                     : launch(decode_tc_kernel<D, 2>, DecShape<D, 2>::kSmem, 32);
}

template <int D, typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* seq_lens, const int* slot_pos, const int* slot_lo,
                  void* o, float* part_m, float* part_l, float* part_acc,
                  int b, int hq, int hkv, int s_cap, int n_split, int chunk,
                  const long long* st, float scale_log2, cudaStream_t stream) {
  const int group = hq / hkv;
  if constexpr (sizeof(T) == 2) {
    const int err = launch_decode_tc<D>(q, k, v, seq_lens, slot_pos, slot_lo, part_m, part_l,
                                        part_acc, b, hq, hkv, s_cap, n_split, chunk, st,
                                        scale_log2, stream);
    if (err) return err;
  } else {
    const int n_gc = (group + kMaxGroup - 1) / kMaxGroup;
    const dim3 grid(n_split, hkv * n_gc, b);
    decode_split_kernel<D><<<grid, kDecThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seq_lens, slot_pos, slot_lo, part_m, part_l,
        part_acc, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), hq,
        group, n_gc, s_cap, chunk, scale_log2);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(hq, b), D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), strides_at(st, 3), hq,
      n_split, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64, (batch, head, row) element strides of q, k, v, o.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int is_bf16,
                                      int b, int hq, int hkv, int sq, int sk,
                                      int d, const long long* strides,
                                      float sm_scale, int causal, int window,
                                      void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || sk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float sl2 = sm_scale * kLog2e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_flash<16>(q, k, v, o, is_bf16, b, hq, hkv, sq, sk, strides, sl2, causal, window, st);
    case 32: return launch_flash<32>(q, k, v, o, is_bf16, b, hq, hkv, sq, sk, strides, sl2, causal, window, st);
    case 64: return launch_flash<64>(q, k, v, o, is_bf16, b, hq, hkv, sq, sk, strides, sl2, causal, window, st);
    case 128: return launch_flash<128>(q, k, v, o, is_bf16, b, hq, hkv, sq, sk, strides, sl2, causal, window, st);
    case 256: return launch_flash<256>(q, k, v, o, is_bf16, b, hq, hkv, sq, sk, strides, sl2, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: 12 int64, (batch, head, row) element strides of q, k, v, o (the
// row strides of q and o are unused).  seq_lens: null (every row up to
// s_cap), or int32[b].  slot_pos: null, or int32[s_cap] shared by the
// batch.  slot_lo: null (-1), or one int32 in device memory (a value below
// -1 counts as -1).  part_m / part_l: f32[b, hq, n_split],
// part_acc: f32[b, hq, n_split, d].
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* seq_lens,
                                       const void* slot_pos, const void* slot_lo,
                                       void* o, void* part_m, void* part_l,
                                       void* part_acc, int is_bf16, int b,
                                       int hq, int hkv, int s_cap, int d,
                                       int n_split, int chunk,
                                       const long long* strides,
                                       float sm_scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || n_split <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float sl2 = sm_scale * kLog2e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* sp = static_cast<const int*>(slot_pos);
  const int* lo = static_cast<const int*>(slot_lo);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
#define REPRO_DECODE(D)                                                       \
  return is_bf16 ? launch_decode<D, __nv_bfloat16>(q, k, v, sl, sp, lo,      \
                                                   o, pm, pl, pa, b, hq, hkv, \
                                                   s_cap, n_split, chunk,     \
                                                   strides, sl2, st)          \
                 : launch_decode<D, float>(q, k, v, sl, sp, lo, o, pm,       \
                                           pl, pa, b, hq, hkv, s_cap,         \
                                           n_split, chunk, strides, sl2, st)
  switch (d) {
    case 32: REPRO_DECODE(32);
    case 64: REPRO_DECODE(64);
    case 128: REPRO_DECODE(128);
    case 256: REPRO_DECODE(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE
}
