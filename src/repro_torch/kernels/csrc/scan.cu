// Sequence scans for Hopper (sm_90a): the recurrent mixers' prefill hot
// spots, Mamba-2's SSD scan (K5) and RG-LRU's diagonal recurrence (K6).
//
//   ssd_scan    y = SSD(x, a, B, C) per (batch, head), chunked: within a
//     chunk of L steps ((C B^T) * causal decay) X plus exp(cum) C h_prev,
//     across chunks the [N, P] state h.  Also returns the final state h_S.
//     Replaces the Pallas kernel repro/kernels/ssd_scan.py:ssd_scan (:81,
//     body _kernel :39).
//
//   rglru_scan  h_t = a_t * h_{t-1} + b_t per (batch, channel), the whole
//     trace returned.  Replaces repro/kernels/rglru_scan.py:rglru_scan
//     (:53, body _kernel :31).
//
// Both take and return float32, contiguous, in the JAX kernels' layouts:
// x, y [B, S, H, P]; a [B, S, H]; B, C [B, S, G, N]; final state
// [B, H, N, P]; RG-LRU a, b, h [B, S, D].
//
// K5, bound on the card.  The work is four small matrix products per
// chunk: C B^T (2 T N flops, T = L (L + 1) / 2 the causal (t, s <= t)
// pairs; once per (batch, group, chunk), shared by the group's heads), its
// decayed product with X (2 T P), C h_prev (2 L N P) and the state update
// B^T X (2 L N P) per (batch, head, chunk), on (2 L P + 2 L N + L) * 4
// bytes and the [N, P] final state.  At mamba2-1.3b's prefill that is
// 10.8 GFLOP on 148 MB: about 73 flops per byte, so the tensor cores'
// rate bounds it.  The products run as 3xTF32 on mma.sync m16n8k8: each
// float32 operand is split into a TF32 high part and a TF32 residual (bit
// masks) and hi*hi + hi*lo + lo*hi are summed in float32, which keeps
// about 21 bits (single-pass TF32 keeps 10 and misses the reference's 3e-3
// near zero); the bound counts each product three times at the TF32 peak.
//
// Design: the chunk decomposition of the SSD paper (Dao & Gu 2024, sec.
// 6), three launches on one stream:
//   ssd_cb_kernel     (group, chunk, batch): C B^T, [128, 128] per chunk,
//                     into a workspace, once per group;
//   ssd_state_kernel  (head, batch): walks the chunks in order, the
//                     [N, P] state in the accumulator: per chunk the
//                     cumsum of log a (into a workspace), the state
//                     entering the chunk (into the chunk-state workspace),
//                     h = exp(cum_L) h + (B * exp(cum_L - cum))^T X; the
//                     last h is the final state;
//   ssd_scan_kernel   (batch, chunk, head) items, 2 blocks an SM each
//                     walking a run of them: y = exp(cum_t) C h_prev +
//                     ((C B^T) * exp(cum_t - cum_s), s <= t) X, one
//                     accumulator, the inter-chunk part first.
// The product kernels stream 32-deep k-chunks of their operands through a
// three-stage cp.async ring that runs on across chunks and items (the
// next k-chunks load under the current products) and keep under 113 KB of
// shared memory, so two blocks of 8 warps share an SM.  A chunk shorter
// than 128 (127, 96, or any L <= 128) is zero-padded to 128 rows; the
// decay is taken only where s <= t < L (masking before the exp: above the
// diagonal the difference is positive and would overflow to inf, and
// inf * 0 is NaN), and k-steps wholly above the diagonal or m-tiles past L
// skip their products.  Fixed order, no atomics: reruns agree bit for bit.
//
// K6, bound on the card.  The recurrence does 2 flops per 12 bytes: it is
// bound by memory (3 * B * S * D * 4 bytes over 3.35 TB/s).  One thread
// owns one (batch, channel) and walks time in order; neighbouring threads
// take neighbouring channels, so every load of a_t, b_t and store of h_t is
// coalesced, and each thread loads kRgUnroll steps ahead before the
// dependent FMA chain uses them.  B * D threads is 16,384 at
// recurrentgemma-9b's prefill, about one block of 128 per SM: a chunked
// two-pass scan that fills the card is later work.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// each launcher returns the first nonzero CUDA error of its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// ---------------------------------------------------------------------------
// K5: ssd_scan
// ---------------------------------------------------------------------------

constexpr int kSsdThreads = 256;  // 8 warps
constexpr int kLP = 128;          // chunk rows, zero-padded (any chunk <= 128)
constexpr int kMaxState = 128;    // N
constexpr int kKC = 32;           // depth of one staged k-chunk
constexpr int kStages = 3;        // k-chunks in the cp.async ring
// Row strides (floats) that make the mma fragments' shared loads
// conflict-free: a stride = 4 (mod 8) where a fragment reads along the
// row, = 8 (mod 16) where it reads down the column.
constexpr int kLdA = kKC + 4;          // [rows, 32] chunks read along the row
constexpr int kLdBt = kMaxState + 8;   // [32, N] chunk of B read down the column
template <int P>
__host__ __device__ constexpr int ld_x() { return P + 8; }  // [32, P] chunks of X and h_prev

// Shared memory (floats) of each kernel, also computed by the wrapper
// (kernels/scan.py: ssd_plan).
__host__ __device__ constexpr int cb_smem_floats() { return kStages * 2 * kLP * kLdA; }
template <int P>
__host__ __device__ constexpr int state_smem_floats() {
  return kStages * kKC * (kLdBt + ld_x<P>()) + 2 * kLP;
}
template <int P>
__host__ __device__ constexpr int scan_smem_floats() {
  return kStages * (kLP * kLdA + kKC * ld_x<P>() + kLP);  // a stage carries its item's cumsum
}

struct SsdDims {
  int s_len, n_heads, n_groups, n, l, n_chunks;
};

// Warp layout of a [128, W] output tile: WN warps across, 8 / WN down;
// each warp owns MT 16-row m-tiles and NT 8-column n-tiles.
template <int W>
struct Tile {
  static constexpr int WN = W >= 32 ? 2 : 1;
  static constexpr int WM = 8 / WN;
  static constexpr int MT = kLP / 16 / WM;
  static constexpr int NT = W / 8 / WN;
};

// x = hi + lo, hi the top 19 bits of x (a TF32), lo = x - hi (exact).  The
// tensor cores read a TF32 operand's top 19 bits, so lo enters its
// products as a TF32 too: hi*hi + hi*lo + lo*hi recovers about 21 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A[m0 .. m0 + 16 MT, 0 .. kKC) B[0 .. kKC, n0 .. n0 + 8 NT) for one
// staged k-chunk, in 3xTF32 (each operand split as it is loaded), where
//   A(m, k) = kAT ? a[k * lda + m] : a[m * lda + k],
//   B(k, n) = kBT ? b[n * ldb + k] : b[k * ldb + n].
// With bscale, B(k, n) is multiplied by bscale[k] as it is loaded.
// m-tile i runs only where bit i of `live` is set and, when `diag` >= 0,
// only for the k-steps of 8 with diag + k <= its last row (a causal
// product whose k-chunk starts at step diag).  Fragment layouts of
// mma.m16n8k8.tf32: lane = 4 g + q; A holds (g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4); B (q, g), (q + 4, g); the sum (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1).  The three terms go one after another over
// all tiles, so consecutive products feed different accumulators.
template <int MT, int NT, bool kAT, bool kBT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const float* a, int lda,
                                         const float* b, int ldb, int m0, int n0,
                                         unsigned live, int diag = -1,
                                         const float* bscale = nullptr) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int k = 0; k < kKC; k += 8) {
    unsigned on = live;
    if (diag >= 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (diag + k > m0 + 16 * i + 15) on &= ~(1u << i);
      }
    }
    if (!on) continue;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!((on >> i) & 1u)) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 16 * i + g + 8 * (r & 1);
        const int kk = k + q + 4 * (r >> 1);
        split_tf32(kAT ? a[kk * lda + m] : a[m * lda + kk], ah[i][r], al[i][r]);
      }
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kk = k + q + 4 * r;
        const float v = kBT ? b[n * ldb + kk] : b[kk * ldb + n];
        split_tf32(bscale != nullptr ? v * bscale[kk] : v, bh[j][r], bl[j][r]);
      }
    }
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (!((on >> i) & 1u)) continue;
          if (term == 0) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
          if (term == 1) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
          if (term == 2) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
        }
  }
}

// cum[t] = sum_{u <= t} log a[u * stride] over the chunk's l steps, in a
// fixed order; 0 for t >= l.  All threads of the block must call it.
__device__ void chunk_cumsum(float* cum, const float* a, long long stride, int l) {
  const int tid = threadIdx.x;
  for (int t = tid; t < kLP; t += blockDim.x) cum[t] = t < l ? logf(a[t * stride]) : 0.0f;
  __syncthreads();
  if (tid < 32) {  // each lane sums its run of steps; a warp scan joins them
    const int per = (l + 31) / 32;
    const int lo = tid * per;
    const int hi = min(lo + per, l);
    float run = 0.0f;
    for (int t = lo; t < hi; ++t) run += cum[t];
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    float acc = incl - run;
    for (int t = lo; t < hi; ++t) {
      acc += cum[t];
      cum[t] = acc;
    }
  }
  __syncthreads();
}

// Copies rows [0, ROWS) x columns [0, 4 SEGS) of a row-major global tile
// (row stride ld_g) into shared memory (row stride ld_s) with 16-byte
// cp.async copies, thread i taking piece i % SEGS of every
// (threads / SEGS)-th row; rows from valid_rows and columns from
// valid_cols on are zero-filled.
template <int ROWS, int SEGS>
__device__ __forceinline__ void copy_tile(float* dst, int ld_s, const float* src, long long ld_g,
                                          int valid_rows, int valid_cols) {
  constexpr int kRowStep = kSsdThreads / SEGS;
  const int c4 = (threadIdx.x % SEGS) * 4;
  const bool col_ok = c4 < valid_cols;
  int r = threadIdx.x / SEGS;
  const float* s = src + r * ld_g + c4;
  float* d = dst + r * ld_s + c4;
#pragma unroll
  for (int i = 0; i < (ROWS + kRowStep - 1) / kRowStep; ++i) {
    if (r < ROWS) {
      const bool ok = col_ok && r < valid_rows;
      cp_async_16(d, ok ? s : src, ok ? 16 : 0);
    }
    r += kRowStep;
    s += kRowStep * ld_g;
    d += kRowStep * ld_s;
  }
}

// grid (groups, chunks, batch).  cb[b, c, grp] = C_c B_c^T, [128, 128],
// rows and columns past L zero.
__global__ void __launch_bounds__(kSsdThreads)
    ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ cb, SsdDims d) {
  using T = Tile<kLP>;
  constexpr int kStage = 2 * kLP * kLdA;
  extern __shared__ float smem[];
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long bc_row = static_cast<long long>(d.n_groups) * d.n;
  const long long base = (static_cast<long long>(b) * d.s_len + c * d.l) * bc_row + grp * d.n;
  const float* cb_ = cm + base;
  const float* bb = bm + base;
  const int nk = (d.n + kKC - 1) / kKC;
  auto load = [&](int i) {
    float* cs = smem + (i % kStages) * kStage;
    float* bs = cs + kLP * kLdA;
    const int k0 = i * kKC;
    copy_tile<kLP, kKC / 4>(cs, kLdA, cb_ + k0, bc_row, d.l, d.n - k0);
    copy_tile<kLP, kKC / 4>(bs, kLdA, bb + k0, bc_row, d.l, d.n - k0);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / T::WN) * T::MT * 16;
  const int n0 = (warp % T::WN) * T::NT * 8;
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) live |= (m0 + 16 * i < d.l ? 1u : 0u) << i;
  float acc[T::MT][T::NT][4] = {};
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i landed; chunk i - 1's readers are done
    if (i + kStages - 1 < nk) load(i + kStages - 1);
    cp_async_commit();
    const float* cs = smem + (i % kStages) * kStage;
    warp_mma<T::MT, T::NT, false, true>(acc, cs, kLdA, cs + kLP * kLdA, kLdA, m0, n0, live);
  }
  float* out = cb + ((static_cast<long long>(b) * d.n_chunks + c) * d.n_groups + grp) * kLP * kLP;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = m0 + 16 * i + (lane >> 2) + 8 * r;
        *reinterpret_cast<float2*>(out + t * kLP + n0 + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
      }
}

// Stores a warp's fragments of a [rows, P] tile (rows below `rows` only)
// at out + row * ld + column.
template <int MT, int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][NT][4], float* out,
                                           long long ld, int rows, int m0, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 16 * i + (lane >> 2) + 8 * r;
        if (row < rows) {
          *reinterpret_cast<float2*>(out + row * ld + n0 + 8 * j + 2 * (lane & 3)) =
              make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
        }
      }
}

// grid (heads, batch).  Walks the chunks of one (batch, head) in order,
// the k-chunks of every chunk streaming through one ring: at each chunk's
// start its cumsum of log a (into cum_out), the state entering it (into
// states[b, h, c]) and h *= exp(cum_L); then h += (B * exp(cum_L - cum))^T
// X in the accumulator.  The last h goes to final_state (when not null).
template <int P>
__global__ void __launch_bounds__(kSsdThreads, 2)
    ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ bm, float* __restrict__ states,
                     float* __restrict__ cum_out, float* __restrict__ final_state, SsdDims d) {
  using T = Tile<P>;
  constexpr int kLdX = ld_x<P>();
  constexpr int kStage = kKC * (kLdBt + kLdX);
  extern __shared__ float smem[];
  float* cum = smem + kStages * kStage;
  float* wend = cum + kLP;
  const int head = blockIdx.x, b = blockIdx.y;
  const int grp = head / (d.n_heads / d.n_groups);
  const long long x_row = static_cast<long long>(d.n_heads) * P;
  const long long bc_row = static_cast<long long>(d.n_groups) * d.n;
  const float* xb = x + static_cast<long long>(b) * d.s_len * x_row + head * P;
  const float* bb = bm + static_cast<long long>(b) * d.s_len * bc_row + grp * d.n;
  const float* ab = a + static_cast<long long>(b) * d.s_len * d.n_heads + head;
  const long long bh = static_cast<long long>(b) * d.n_heads + head;
  const int kpc = (d.l + kKC - 1) / kKC;  // k-chunks per chunk
  const int nk = d.n_chunks * kpc;
  auto load = [&](int i) {
    float* bt = smem + (i % kStages) * kStage;
    float* xs = bt + kKC * kLdBt;
    const int t0 = (i % kpc) * kKC;                 // step in the chunk
    const long long s0 = (i / kpc) * static_cast<long long>(d.l) + t0;  // in the sequence
    copy_tile<kKC, kMaxState / 4>(bt, kLdBt, bb + s0 * bc_row, bc_row, d.l - t0, d.n);
    copy_tile<kKC, P / 4>(xs, kLdX, xb + s0 * x_row, x_row, d.l - t0, P);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / T::WN) * T::MT * 16;
  const int n0 = (warp % T::WN) * T::NT * 8;
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) live |= (m0 + 16 * i < d.n ? 1u : 0u) << i;
  const long long state_size = static_cast<long long>(d.n) * P;
  float acc[T::MT][T::NT][4] = {};
  for (int i = 0; i < nk; ++i) {
    const int kk = i % kpc;
    if (kk == 0) {  // a chunk starts: its decays, and the state entering it
      const int c = i / kpc;
      store_tile(acc, states + (bh * d.n_chunks + c) * state_size, P, d.n, m0, n0);
      chunk_cumsum(cum, ab + static_cast<long long>(c) * d.l * d.n_heads, d.n_heads, d.l);
      const float cum_last = cum[d.l - 1];
      float* cum_row = cum_out + bh * d.s_len + static_cast<long long>(c) * d.l;
      for (int t = threadIdx.x; t < kLP; t += kSsdThreads) {
        wend[t] = t < d.l ? expf(cum_last - cum[t]) : 0.0f;
        if (t < d.l) cum_row[t] = cum[t];
      }
      const float dec = expf(cum_last);
#pragma unroll
      for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][j][r] *= dec;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // k-chunk i landed (and wend is written); i - 1 is done
    if (i + kStages - 1 < nk) load(i + kStages - 1);
    cp_async_commit();
    const float* bt = smem + (i % kStages) * kStage;
    // X scaled by the decay to the chunk's end as its fragments load
    warp_mma<T::MT, T::NT, true, false>(acc, bt, kLdBt, bt + kKC * kLdBt, kLdX, m0, n0, live, -1,
                                        wend + kk * kKC);
  }
  if (final_state != nullptr) store_tile(acc, final_state + bh * state_size, P, d.n, m0, n0);
}

// grid ceil(items / per); block j walks the items j * per .. (j + 1) * per
// - 1 of (batch, chunk, head), head fastest, their k-chunks streaming
// through one ring.  Per item y[b, c0 + t, h] = exp(cum_t) C_t h_prev +
// sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) X_s: the k-chunks of C h_prev
// (none in the first chunk, whose h_prev is 0), the row scale, then the
// k-chunks of the decayed C B^T against X.  A stage also carries its
// item's cumsum.
template <int P>
__global__ void __launch_bounds__(kSsdThreads, 2)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ cm,
                    const float* __restrict__ cb, const float* __restrict__ hprev,
                    const float* __restrict__ cum_in, float* __restrict__ y, SsdDims d,
                    int bs, int per) {
  using T = Tile<P>;
  constexpr int kLdX = ld_x<P>();
  constexpr int kStage = kLP * kLdA + kKC * kLdX + kLP;
  extern __shared__ float smem[];
  const long long x_row = static_cast<long long>(d.n_heads) * P;
  const long long bc_row = static_cast<long long>(d.n_groups) * d.n;
  const int rep = d.n_heads / d.n_groups;
  const int nkc = (d.n + kKC - 1) / kKC;  // k-chunks of C h_prev
  const int nkm = (d.l + kKC - 1) / kKC;  // k-chunks of the decayed C B^T
  const int it0 = blockIdx.x * per;
  const int it1 = min(it0 + per, bs * d.n_chunks * d.n_heads);
  // the loader's place: item li = (b, c, head), its k-chunk lk; slot counts
  // the k-chunks loaded
  int li = it0, lk = 0, slot = 0;
  int l_head = it0 % d.n_heads, l_c = (it0 / d.n_heads) % d.n_chunks;
  int l_b = it0 / (d.n_heads * d.n_chunks);
  int c_head = l_head, c_c = l_c, c_b = l_b;  // the consumer's place (item ci, k-chunk ck)
  auto load_next = [&]() {
    float* as = smem + (slot % kStages) * kStage;
    float* bs_ = as + kLP * kLdA;
    float* cum = bs_ + kKC * kLdX;
    const int head = l_head, c = l_c, b = l_b;
    const int grp = head / rep;
    const long long row0 = static_cast<long long>(b) * d.s_len + static_cast<long long>(c) * d.l;
    const int nkc_i = c == 0 ? 0 : nkc;
    if (lk < nkc_i) {  // C[:, k0 .. k0 + 32) and h_prev[k0 .. k0 + 32, :]
      const int k0 = lk * kKC;
      const float* cbase = cm + row0 * bc_row + grp * d.n;
      const float* hp = hprev + ((static_cast<long long>(b) * d.n_heads + head) * d.n_chunks + c) *
                                    static_cast<long long>(d.n) * P;
      copy_tile<kLP, kKC / 4>(as, kLdA, cbase + k0, bc_row, d.l, d.n - k0);
      copy_tile<kKC, P / 4>(bs_, kLdX, hp + k0 * P, P, d.n - k0, P);
    } else {  // (C B^T)[:, k0 .. k0 + 32), X[k0 .. k0 + 32, :] and the cumsum
      const int k0 = (lk - nkc_i) * kKC;
      const float* cbt =
          cb + ((static_cast<long long>(b) * d.n_chunks + c) * d.n_groups + grp) * kLP * kLP;
      const float* xb = x + row0 * x_row + head * P;
      copy_tile<kLP, kKC / 4>(as, kLdA, cbt + k0, kLP, kLP, kKC);
      copy_tile<kKC, P / 4>(bs_, kLdX, xb + k0 * x_row, x_row, d.l - k0, P);
      const float* cum_row =
          cum_in + (static_cast<long long>(b) * d.n_heads + head) * d.s_len + c * d.l;
      for (int t = threadIdx.x; t < kLP; t += kSsdThreads) {
        if (t < d.l) {
          hopper::cp_async_4(cum + t, cum_row + t);
        } else {
          cum[t] = 0.0f;
        }
      }
    }
    ++slot;
    if (++lk == nkc_i + nkm) {
      lk = 0;
      ++li;
      if (++l_head == d.n_heads) {
        l_head = 0;
        if (++l_c == d.n_chunks) {
          l_c = 0;
          ++l_b;
        }
      }
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (li < it1) load_next();
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (warp / T::WN) * T::MT * 16;
  const int n0 = (warp % T::WN) * T::NT * 8;
  unsigned rows_live = 0;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) rows_live |= (m0 + 16 * i < d.l ? 1u : 0u) << i;
  float acc[T::MT][T::NT][4] = {};
  int ck = 0;
  for (int ci = it0, i = 0; ci < it1; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // k-chunk i landed; k-chunk i - 1 is done
    if (li < it1) load_next();
    cp_async_commit();
    float* as = smem + (i % kStages) * kStage;
    float* bs = as + kLP * kLdA;
    const float* cum = bs + kKC * kLdX;
    const int c = c_c;
    const int nkc_i = c == 0 ? 0 : nkc;
    int diag = -1;
    if (ck >= nkc_i) {  // the decayed C B^T, masked to s <= t < L; rows above k0 stay unread
      const int k0 = (ck - nkc_i) * kKC;
      for (int e = k0 * kKC + threadIdx.x; e < kLP * kKC; e += kSsdThreads) {
        const int t = e / kKC, s = k0 + e % kKC;
        float* v = as + t * kLdA + e % kKC;
        *v = (s <= t && t < d.l) ? *v * __expf(cum[t] - cum[s]) : 0.0f;
      }
      __syncthreads();
      if (ck == nkc_i && nkc_i > 0) {  // the inter-chunk part is complete: scale by exp(cum_t)
#pragma unroll
        for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float e = expf(cum[m0 + 16 * mi + (lane >> 2) + 8 * r]);
#pragma unroll
            for (int j = 0; j < T::NT; ++j) {
              acc[mi][j][2 * r] *= e;
              acc[mi][j][2 * r + 1] *= e;
            }
          }
      }
      diag = k0;
    }
    warp_mma<T::MT, T::NT, false, false>(acc, as, kLdA, bs, kLdX, m0, n0, rows_live, diag);
    if (++ck == nkc_i + nkm) {  // the item is done: its y, and a fresh accumulator
      const long long row0 =
          static_cast<long long>(c_b) * d.s_len + static_cast<long long>(c) * d.l;
      store_tile(acc, y + row0 * x_row + c_head * P, x_row, d.l, m0, n0);
#pragma unroll
      for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.0f;
      ck = 0;
      ++ci;
      if (++c_head == d.n_heads) {
        c_head = 0;
        if (++c_c == d.n_chunks) {
          c_c = 0;
          ++c_b;
        }
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, int floats) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               floats * static_cast<int>(sizeof(float))));
}

template <int P>
int launch_ssd(const float* x, const float* a, const float* bm, const float* cm, float* y,
               float* final_state, float* cum, float* cb, float* states, int bs, SsdDims d,
               int per, cudaStream_t stream) {
  int err = set_smem(ssd_cb_kernel, cb_smem_floats());
  if (!err) err = set_smem(ssd_state_kernel<P>, state_smem_floats<P>());
  if (!err) err = set_smem(ssd_scan_kernel<P>, scan_smem_floats<P>());
  if (err) return err;
  ssd_cb_kernel<<<dim3(d.n_groups, d.n_chunks, bs), kSsdThreads,
                  cb_smem_floats() * sizeof(float), stream>>>(bm, cm, cb, d);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_state_kernel<P><<<dim3(d.n_heads, bs), kSsdThreads, state_smem_floats<P>() * sizeof(float),
                        stream>>>(x, a, bm, states, cum, final_state, d);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int items = bs * d.n_chunks * d.n_heads;
  ssd_scan_kernel<P><<<(items + per - 1) / per, kSsdThreads, scan_smem_floats<P>() * sizeof(float),
                       stream>>>(x, cm, cb, states, cum, y, d, bs, per);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K6: rglru_scan
// ---------------------------------------------------------------------------

constexpr int kRgThreads = 128;
constexpr int kRgUnroll = 16;  // steps loaded ahead of the dependent chain

// grid ceil(B * D / kRgThreads); block kRgThreads.  Thread i owns channel
// i % D of batch row i / D.
__global__ void __launch_bounds__(kRgThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ h, int bs, int s_len, int d) {
  const long long i = static_cast<long long>(blockIdx.x) * kRgThreads + threadIdx.x;
  if (i >= static_cast<long long>(bs) * d) return;
  const long long base = (i / d) * s_len * d + i % d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = 0.0f;
  int t = 0;
  for (; t + kRgUnroll <= s_len; t += kRgUnroll) {
    float av[kRgUnroll], bv[kRgUnroll];
#pragma unroll
    for (int u = 0; u < kRgUnroll; ++u) {
      av[u] = ap[static_cast<long long>(t + u) * d];
      bv[u] = bp[static_cast<long long>(t + u) * d];
    }
#pragma unroll
    for (int u = 0; u < kRgUnroll; ++u) {
      state = fmaf(av[u], state, bv[u]);
      hp[static_cast<long long>(t + u) * d] = state;
    }
  }
  for (; t < s_len; ++t) {
    state = fmaf(ap[static_cast<long long>(t) * d], state,
                 bp[static_cast<long long>(t) * d]);
    hp[static_cast<long long>(t) * d] = state;
  }
}

}  // namespace

// Shared memory bytes of ssd_scan's product kernels at head dim p
// (which: 0 = C B^T, 1 = chunk state, 2 = chunk scan); -1 for another p.
extern "C" long long ssd_scan_smem_bytes(int which, int p) {
  int floats = -1;
  switch (p) {
    case 16: floats = which == 1 ? state_smem_floats<16>() : scan_smem_floats<16>(); break;
    case 32: floats = which == 1 ? state_smem_floats<32>() : scan_smem_floats<32>(); break;
    case 64: floats = which == 1 ? state_smem_floats<64>() : scan_smem_floats<64>(); break;
    case 128: floats = which == 1 ? state_smem_floats<128>() : scan_smem_floats<128>(); break;
    default: return -1;
  }
  if (which == 0) floats = cb_smem_floats();
  return static_cast<long long>(floats) * static_cast<long long>(sizeof(float));
}

// x, y: f32[bs, s, h, p]; a: f32[bs, s, h]; b, c: f32[bs, s, g, n]; all
// contiguous.  chunk l divides s, l <= 128; n % 8 == 0, n <= 128; p in
// {16, 32, 64, 128}.  Workspaces (f32, contiguous, from the caller): cum
// [bs, h, s], cb [bs, s / l, g, 128, 128], states [bs, h, s / l, n, p].
// final_state f32[bs, h, n, p] or null.  per: (batch, chunk, head) items
// each block of the chunk-scan kernel walks.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b, const void* c,
                               void* y, void* final_state, void* cum, void* cb, void* states,
                               int bs, int s, int h, int g, int n, int p, int l, int per,
                               void* stream) {
  if (bs <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g || n <= 0 || n % 8 || n > kMaxState ||
      l <= 0 || l > kLP || s % l || per <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SsdDims d{s, h, g, n, l, s / l};
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* yf = static_cast<float*>(y);
  float* fs = static_cast<float*>(final_state);
  float* cu = static_cast<float*>(cum);
  float* cbw = static_cast<float*>(cb);
  float* st = static_cast<float*>(states);
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return launch_ssd<16>(xf, af, bf, cf, yf, fs, cu, cbw, st, bs, d, per, sm);
    case 32: return launch_ssd<32>(xf, af, bf, cf, yf, fs, cu, cbw, st, bs, d, per, sm);
    case 64: return launch_ssd<64>(xf, af, bf, cf, yf, fs, cu, cbw, st, bs, d, per, sm);
    case 128: return launch_ssd<128>(xf, af, bf, cf, yf, fs, cu, cbw, st, bs, d, per, sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a, b, h: f32[bs, s, d], contiguous.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int bs,
                                 int s, int d, void* stream) {
  if (bs <= 0 || s <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(bs) * d;
  const unsigned blocks = static_cast<unsigned>((threads + kRgThreads - 1) / kRgThreads);
  rglru_scan_kernel<<<blocks, kRgThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), bs, s, d);
  return static_cast<int>(cudaGetLastError());
}
