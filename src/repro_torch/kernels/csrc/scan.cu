// Sequence scans for Hopper (sm_90a): the recurrent mixers' prefill hot
// spots, Mamba-2's SSD scan (K5) and RG-LRU's diagonal recurrence (K6).
//
//   ssd_scan    y = SSD(x, a, B, C) per (batch, head), chunked: within a
//     chunk of L steps ((C B^T) * causal decay) X plus exp(cum) C h_prev,
//     across chunks the [N, P] state h carried in order.  Replaces the
//     Pallas kernel repro/kernels/ssd_scan.py:ssd_scan (:81, body _kernel
//     :39).
//
//   rglru_scan  h_t = a_t * h_{t-1} + b_t per (batch, channel), the whole
//     trace returned.  Replaces repro/kernels/rglru_scan.py:rglru_scan
//     (:53, body _kernel :31).
//
// Both take and return float32, contiguous, in the JAX kernels' layouts:
// x, y [B, S, H, P]; a [B, S, H]; B, C [B, S, G, N]; RG-LRU a, b, h
// [B, S, D].
//
// K5, bound on the card.  Per (batch, head, chunk) the work is three small
// matrix products over L, N and P (C B^T, its product with X, C h_prev and
// the state update B^T X): 2 T N + 2 T P + 4 L N P flops, T = L (L + 1) / 2
// the (t, s <= t) pairs the causal mask keeps, on (L P + 2 L N + L) * 4
// bytes read.  At mamba2-1.3b's prefill (L = 128, N = 128, P = 64) that is
// about 45 flops per byte, above the float32
// ridge (67 TFLOP/s over 3.35 TB/s = 20): the bound is the float32 rate of
// the CUDA cores.  The design keeps every operand of a chunk on chip: one
// block owns one (batch, head) and walks its chunks in order, which takes
// the place of the TPU's sequential chunk grid axis; the [N, P] state
// lives in shared memory for the whole sequence and never goes to device
// memory.  A chunk's X and B (B transposed, so lanes read neighbouring
// steps) stay in shared memory while C is streamed 32 rows at a time with
// its [32, L] score tile, which keeps the block under the 227 KB of
// shared memory at L = N = 128.  The score tile is computed 4 x 4 outputs
// per thread (16 FMAs per 8 shared loads); the decay exp(cum_t - cum_s) is
// taken only where s <= t (masking before the exp: above the diagonal the
// difference is positive and would overflow to inf, and inf * 0 is NaN).
// Float32 FMAs on the CUDA cores, no tensor cores yet (TF32 keeps about
// three digits; wgmma is later work).  Fixed order, no atomics: reruns
// agree bit for bit.  C B^T is recomputed for every head of a group.
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
// each launcher returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K5: ssd_scan
// ---------------------------------------------------------------------------

constexpr int kSsdThreads = 256;
constexpr int kTt = 32;       // rows of C (steps t) per score tile
constexpr int kMaxChunk = 128;
constexpr int kRows = 8;      // state rows each thread keeps in registers

// Shared layout (floats), for chunk length L, state N, head dim P:
//   h    [N * P]        the carried state
//   xs   [L * P]        this chunk's X
//   bt   [N * (L + 1)]  this chunk's B, transposed (step contiguous, padded)
//   ct   [kTt * N]      32 rows of C
//   sc   [kTt * kMaxChunk] the score tile
//   cum, ecum, wend [kMaxChunk] cumulative log a, exp(cum), exp(cum_L - cum)
__host__ __device__ inline size_t ssd_smem_floats(int l, int n, int p) {
  return static_cast<size_t>(n) * p + static_cast<size_t>(l) * p +
         static_cast<size_t>(n) * (l + 1) + kTt * n + kTt * kMaxChunk +
         3 * kMaxChunk;
}

// grid (heads, batch); block kSsdThreads; dynamic shared memory
// ssd_smem_floats(L, N, P) floats.
template <int P>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    float* __restrict__ y, int s_len, int n_heads, int n_groups,
                    int n, int l) {
  extern __shared__ float smem[];
  float* h = smem;
  float* xs = h + n * P;
  float* bt = xs + l * P;
  float* ct = bt + n * (l + 1);
  float* sc = ct + kTt * n;
  float* cum = sc + kTt * kMaxChunk;
  float* ecum = cum + kMaxChunk;
  float* wend = ecum + kMaxChunk;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = head / (n_heads / n_groups);
  const int tid = threadIdx.x;
  const int lp = l + 1;
  const long long x_row = static_cast<long long>(n_heads) * P;  // x/y step stride
  const long long bc_row = static_cast<long long>(n_groups) * n;
  const float* xb = x + static_cast<long long>(b) * s_len * x_row + head * P;
  float* yb = y + static_cast<long long>(b) * s_len * x_row + head * P;
  const float* ab = a + static_cast<long long>(b) * s_len * n_heads + head;
  const float* bb = bm + static_cast<long long>(b) * s_len * bc_row + grp * n;
  const float* cb = cm + static_cast<long long>(b) * s_len * bc_row + grp * n;

  for (int i = tid; i < n * P; i += kSsdThreads) h[i] = 0.0f;

  for (int c0 = 0; c0 < s_len; c0 += l) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < l * P; i += kSsdThreads) {
      const int t = i / P;
      xs[i] = xb[(c0 + t) * x_row + i % P];
    }
    for (int i = tid; i < l * n; i += kSsdThreads) {
      const int t = i / n;
      const int k = i % n;
      bt[k * lp + t] = bb[(c0 + t) * bc_row + k];
    }
    for (int t = tid; t < l; t += kSsdThreads) cum[t] = logf(ab[(c0 + t) * n_heads]);
    __syncthreads();
    if (tid < 32) {  // inclusive scan of log a over the chunk, in order
      const int per = (l + 31) / 32;
      const int lo = tid * per;
      const int hi = min(lo + per, l);
      float run = 0.0f;
      for (int t = lo; t < hi; ++t) run += cum[t];
      float incl = run;  // warp-inclusive scan of the lanes' sums
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
    const float cum_last = cum[l - 1];
    for (int t = tid; t < l; t += kSsdThreads) {
      ecum[t] = expf(cum[t]);
      wend[t] = expf(cum_last - cum[t]);
    }

    for (int t0 = 0; t0 < l; t0 += kTt) {
      const int rows = min(kTt, l - t0);
      const int cols = min(t0 + kTt, l);  // steps s <= t for every row
      __syncthreads();  // ecum/wend written; the previous tile's readers done
      for (int i = tid; i < kTt * n; i += kSsdThreads) {
        const int r = i / n;
        ct[i] = r < rows ? cb[(c0 + t0 + r) * bc_row + i % n] : 0.0f;
      }
      __syncthreads();
      {  // score tile: sc[r][s] = (C_t . B_s) exp(cum_t - cum_s), s <= t
        const int ty = tid >> 5;   // rows 4 ty .. 4 ty + 3
        const int tx = tid & 31;   // steps tx + 32 j
        const int nj = (cols + 31) / 32;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ct[(4 * ty + i) * n + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sj = tx + 32 * j;
            bv[j] = (j < nj && sj < l) ? bt[k * lp + sj] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * ty + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sj = tx + 32 * j;
            if (j < nj) {
              sc[(4 * ty + i) * kMaxChunk + sj] =
                  (sj <= t && t < l) ? acc[i][j] * expf(cum[t] - cum[sj]) : 0.0f;
            }
          }
        }
      }
      __syncthreads();
      {  // y[t][p] = sum_s sc[t][s] X[s][p] + exp(cum_t) sum_k C[t][k] h[k][p]
        constexpr int kStep = kSsdThreads / P;  // rows between a thread's rows
        constexpr int kR = kTt / kStep;         // rows per thread
        const int p = tid % P;
        const int r0 = tid / P;
        float intra[kR], inter[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) intra[i] = inter[i] = 0.0f;
        for (int s = 0; s < cols; ++s) {
          const float xv = xs[s * P + p];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            intra[i] = fmaf(sc[(r0 + kStep * i) * kMaxChunk + s], xv, intra[i]);
          }
        }
        for (int k = 0; k < n; ++k) {
          const float hv = h[k * P + p];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            inter[i] = fmaf(ct[(r0 + kStep * i) * n + k], hv, inter[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int r = r0 + kStep * i;
          if (r < rows) {
            yb[(c0 + t0 + r) * x_row + p] = intra[i] + ecum[t0 + r] * inter[i];
          }
        }
      }
    }
    __syncthreads();  // every y of the chunk has read h
    {  // h[k][p] = exp(cum_L) h[k][p] + sum_s B[s][k] exp(cum_L - cum_s) X[s][p]
      constexpr int kStep = kSsdThreads / P;
      const int p = tid % P;
      const float decay = expf(cum_last);
      for (int k0 = tid / P; k0 < n; k0 += kStep * kRows) {
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
        for (int s = 0; s < l; ++s) {
          const float xv = xs[s * P + p] * wend[s];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int k = k0 + kStep * i;
            if (k < n) acc[i] = fmaf(bt[k * lp + s], xv, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int k = k0 + kStep * i;
          if (k < n) h[k * P + p] = decay * h[k * P + p] + acc[i];
        }
      }
    }
  }
}

template <int P>
int launch_ssd(const float* x, const float* a, const float* b, const float* c,
               float* y, int bs, int s_len, int h, int g, int n, int l,
               cudaStream_t stream) {
  const size_t smem = ssd_smem_floats(l, n, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<P><<<dim3(h, bs), kSsdThreads, smem, stream>>>(
      x, a, b, c, y, s_len, h, g, n, l);
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

// Shared memory bytes ssd_scan_launch needs for chunk l, state n, head dim
// p (the wrapper checks it against the card's limit).
extern "C" long long ssd_scan_smem_bytes(int l, int n, int p) {
  return static_cast<long long>(ssd_smem_floats(l, n, p) * sizeof(float));
}

// x, y: f32[bs, s, h, p]; a: f32[bs, s, h]; b, c: f32[bs, s, g, n];
// all contiguous.  chunk l divides s, l <= 128; p in {16, 32, 64, 128}.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, void* y, int bs, int s, int h,
                               int g, int n, int p, int l, void* stream) {
  if (bs <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g || n <= 0 || l <= 0 ||
      l > kMaxChunk || s % l) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* yf = static_cast<float*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return launch_ssd<16>(xf, af, bf, cf, yf, bs, s, h, g, n, l, st);
    case 32: return launch_ssd<32>(xf, af, bf, cf, yf, bs, s, h, g, n, l, st);
    case 64: return launch_ssd<64>(xf, af, bf, cf, yf, bs, s, h, g, n, l, st);
    case 128: return launch_ssd<128>(xf, af, bf, cf, yf, bs, s, h, g, n, l, st);
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
