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
//     windowed ring buffer's rule, repro/models/layers.py:260-262).
//     Replaces repro/kernels/decode_attention.py:decode_attention (:94, body
//     _kernel :33).
//
// Every tensor is addressed through its (batch, head, row) strides with the
// last dimension contiguous, so the model hands over transposed views of
// its [B, S, H, D] activations and of its [B, W, Hkv, D] cache and nothing
// is copied.
//
// Bound on the card.  Prefill at the serving shapes (head_dim 128, causal,
// 1,024 tokens) does 2 * 2 * Sq * Sk / 2 * D flops per (batch, head) on
// 4 * Sq * D bytes: about 256 flop/byte, at the bf16 tensor-core ridge
// (989 TFLOP/s over 3.35 TB/s), so its bound is the tensor-core rate.  The
// bf16 kernel runs its two products on the tensor cores with mma.sync
// (m16n8k16, f32 accumulation), keeps the running max, normaliser and
// output tile in registers for the whole KV loop, and never writes the
// score matrix to memory; KV tiles past the causal frontier or outside the
// window are skipped as the TPU kernel skips them (flash_attention.py:
// 64-71).  One block owns one (64-row q tile, q head, batch) and loops over
// its KV tiles: that loop takes the place of the TPU's sequential KV grid
// axis.  float32 inputs take a CUDA-core kernel of the same structure
// (16-row tiles, one key per lane).  At head dim 256 (recurrentgemma-9b)
// the Q fragments (64 registers) and the output accumulator (128) would not
// fit in a thread's registers beside the scores, so Q stays in shared
// memory and is read fragment by fragment, and KV tiles are 32 keys; the
// tiles then pass the 48 KB of static shared memory and both kernels take
// theirs dynamically.  Not yet done: wgmma, TMA and a multi-stage copy
// pipeline.
//
// Decode reads each valid K/V row once per kv head and does 4 flops per
// element per q head of the group: it is bound by memory (bytes of the valid
// K/V rows over 3.35 TB/s on an H100 SXM).  One block owns one (cache
// split, kv head, batch) and serves all `group` q heads of that kv head from
// one read of each row (the TPU kernel reads the cache once per q head).
// B * Hkv blocks would leave most of the 132 SMs idle at serving batch
// sizes, so the cache axis is split across blocks (flash-decoding) and a
// second kernel combines the partial (max, normaliser, output) of the
// splits in ascending order.  No atomics: reruns agree bit for bit.
// Tail rows past seq_lens[b] are not read, nor are rows whose slot_pos
// fails the window rule (the kernel reads slot_pos itself; no mask is
// built).  A block serves at most kMaxGroup q heads, held in registers; a
// larger group (recurrentgemma-9b's 16 q heads on one kv head) is split
// over several blocks, each reading the kv head's rows again (from L2).
//
// Softmax is taken in base 2 (scores pre-multiplied by scale * log2 e).
// Masked scores are -inf and a row that has seen no valid key keeps
// max = -inf, normaliser 0 and output 0.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// each launcher returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of dims (batch, head, row)
  long long b, h, s;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
// masked (past the causal frontier or left of every row's window).
__device__ __forceinline__ void kv_tile_range(int q0, int bq, int bk, int sk,
                                              int causal, int window, int& lo,
                                              int& hi) {
  const int last = causal ? min(sk, q0 + bq) : sk;
  hi = (last + bk - 1) / bk;
  lo = window > 0 ? max(0, q0 - window + 1) / bk : 0;
}

// ---------------------------------------------------------------------------
// K3, bf16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

constexpr int kBq = 64;        // q rows per block, 16 per warp
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, transposed: thread i gives the
// address of row i % 8 of matrix i / 8 and receives, per matrix, elements
// (2 * (i % 4), i / 4) and (2 * (i % 4) + 1, i / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// KV tile length and where Q lives, by head dim: registers up to 128,
// shared memory at 256 (see the header).
template <int D>
struct FlashShape {
  static constexpr int kBk = D > 128 ? 32 : 64;
  static constexpr bool kQShared = D > 128;
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * (D + 8) * (2 * kBk + (kQShared ? kBq : 0));
};

// grid (ceil(sq / kBq), hq, batch); block kMmaThreads; dynamic shared
// memory FlashShape<D>::kSmemBytes.
//
// Warp w owns q rows q0 + 16 w .. + 15.  In the mma fragments, thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 of the warp's 16, and
// score columns (keys) 8 n + 2 t, + 1 of each 8-key slice n.  The score
// accumulator of two neighbouring 8-key slices is, packed to bf16, the A
// fragment of the P V product for those 16 keys (no trip through shared
// memory); V's B fragments come transposed from shared memory by ldmatrix.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                      Strides vs, Strides os, int group, int sq, int sk,
                      float scale_log2, int causal, int window) {
  constexpr int kS = D + 8;  // padded shared row: conflict-free fragments
  constexpr int kBk = FlashShape<D>::kBk;
  constexpr bool kQShared = FlashShape<D>::kQShared;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* sk_tile = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* sv_tile = sk_tile + kBk * kS;
  __nv_bfloat16* sq_tile = sv_tile + kBk * kS;  // kQShared only

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

  // Q as A fragments, kept in registers for the whole KV loop (D <= 128)
  // or loaded from shared memory at each use (D = 256).
  uint32_t qa[kQShared ? 1 : D / 16][4];
  if constexpr (kQShared) {
    load_tile_bf16<D, kBq>(sq_tile, qb, qs.s, q0, sq);
  } else {
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
      if constexpr (kQShared) {  // the register layout, from shared memory
        const __nv_bfloat16* qr = sq_tile + (warp * 16 + g) * kS + kk * 16 + 2 * t;
        qa[0][0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[0][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kS);
        qa[0][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        qa[0][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * kS + 8);
      }
      const auto& a_frag = qa[kQShared ? 0 : kk];
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
        const __nv_bfloat16* kr = sk_tile + (n * 8 + g) * kS + kk * 16 + 2 * t;
        mma_16816(s[n], a_frag, *reinterpret_cast<const uint32_t*>(kr),
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
// K4: split-cache decode attention and its combine pass
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxGroup = 8;  // q heads per block

// K/V rows each warp loads before using them: fewer at head dim 256, where
// each row takes 8 registers a lane.
template <int D>
constexpr int kDecUnroll = D > 128 ? 2 : 4;

template <int E, typename T>
__device__ __forceinline__ void load_row(float (&dst)[E], const T* src) {
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = to_float(src[e]);
}

// grid (n_split, hkv * n_gc, batch); block kDecThreads.  The block scores
// keys [split * chunk, min((split + 1) * chunk, seq_lens[b])) of kv head
// blockIdx.y / n_gc against its q heads [g0, g0 + kMaxGroup) of the group,
// g0 = (blockIdx.y % n_gc) * kMaxGroup; with slot_pos, key j also needs
// slot_pos[j] > slot_lo (the host passes slot_lo >= -1, so an empty slot,
// -1, never counts).  Lane l holds elements [l E, l E + E) of each row
// (E = D / 32); warp w takes keys w U, w U + 1, ... of the split, U at a
// time, and keeps its own running (max, sum, output) per q head; the four
// warps are combined in order at the end and written as this split's
// partial.
template <int D, typename T>
__global__ void __launch_bounds__(kDecThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ seq_lens,
                        const int* __restrict__ slot_pos, int slot_lo,
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
  const int len = min(max(seq_lens[b], 0), s_cap);
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
  const T* kb = k + b * ks.b + hk * ks.h + lane * E;
  const T* vb = v + b * vs.b + hk * vs.h + lane * E;

  for (int j = j0 + warp * U; j < j1; j += kDecWarps * U) {
    bool ok[U];  // the same for every lane of the warp
    float kr[U][E];
    float vr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = j + u < j1 && (slot_pos == nullptr || slot_pos[j + u] > slot_lo);
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

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int is_bf16, int b, int hq, int group, int sq, int sk,
                 const long long* st, float scale_log2, int causal, int window,
                 cudaStream_t stream) {
  if (is_bf16) {
    constexpr size_t smem = FlashShape<D>::kSmemBytes;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((sq + kBq - 1) / kBq, hq, b);
    flash_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), group, sq, sk, scale_log2, causal, window);
  } else {
    constexpr size_t smem = flash_f32_smem_bytes<D>();
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((sq + kF32Bq - 1) / kF32Bq, hq, b);
    flash_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), group, sq, sk, scale_log2, causal, window);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* seq_lens, const int* slot_pos, int slot_lo,
                  void* o, float* part_m, float* part_l, float* part_acc,
                  int b, int hq, int hkv, int s_cap, int n_split, int chunk,
                  const long long* st, float scale_log2, cudaStream_t stream) {
  const int group = hq / hkv;
  const int n_gc = (group + kMaxGroup - 1) / kMaxGroup;
  const dim3 grid(n_split, hkv * n_gc, b);
  decode_split_kernel<D, T><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seq_lens, slot_pos, slot_lo, part_m, part_l,
      part_acc, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), hq,
      group, n_gc, s_cap, chunk, scale_log2);
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
  const int group = hq / hkv;
  const float sl2 = sm_scale * kLog2e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_flash<16>(q, k, v, o, is_bf16, b, hq, group, sq, sk, strides, sl2, causal, window, st);
    case 32: return launch_flash<32>(q, k, v, o, is_bf16, b, hq, group, sq, sk, strides, sl2, causal, window, st);
    case 64: return launch_flash<64>(q, k, v, o, is_bf16, b, hq, group, sq, sk, strides, sl2, causal, window, st);
    case 128: return launch_flash<128>(q, k, v, o, is_bf16, b, hq, group, sq, sk, strides, sl2, causal, window, st);
    case 256: return launch_flash<256>(q, k, v, o, is_bf16, b, hq, group, sq, sk, strides, sl2, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: 12 int64, (batch, head, row) element strides of q, k, v, o (the
// row strides of q and o are unused).  slot_pos: null, or int32[s_cap]
// shared by the batch, with slot_lo >= -1.  part_m / part_l:
// f32[b, hq, n_split], part_acc: f32[b, hq, n_split, d].
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* seq_lens,
                                       const void* slot_pos, int slot_lo,
                                       void* o, void* part_m, void* part_l,
                                       void* part_acc, int is_bf16, int b,
                                       int hq, int hkv, int s_cap, int d,
                                       int n_split, int chunk,
                                       const long long* strides,
                                       float sm_scale, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || n_split <= 0 || chunk <= 0 ||
      slot_lo < -1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float sl2 = sm_scale * kLog2e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* sp = static_cast<const int*>(slot_pos);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
#define REPRO_DECODE(D)                                                       \
  return is_bf16 ? launch_decode<D, __nv_bfloat16>(q, k, v, sl, sp, slot_lo, \
                                                   o, pm, pl, pa, b, hq, hkv, \
                                                   s_cap, n_split, chunk,     \
                                                   strides, sl2, st)          \
                 : launch_decode<D, float>(q, k, v, sl, sp, slot_lo, o, pm,  \
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
