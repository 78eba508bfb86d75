// Spike -> current accumulation for Hopper (sm_90a): the brain
// simulation's synaptic-integration hot spot.
//
// Two kernels, one design:
//
//   spike_accum_blocks  I[d, j] = sum_k s_blocks[d, src_ids[d, k], :] @ blocks[d, k, :, j]
//     Replaces the Pallas kernel repro/kernels/spike_accum.py:spike_accum_blocks
//     (:133, body _blocks_kernel :109): the block-CSR accumulation every
//     'sparse'/'ragged' step of the distributed engine runs.  Rank-stacked:
//     one launch covers every rank d.
//
//   spike_accum         I[j] = sum_i s[i] * W[i, j]
//     Replaces repro/kernels/spike_accum.py:spike_accum (:62, body _kernel
//     :36): the single-device engine's current hook.
//
// Bound on the card.  Both are memory-bound gathers: per fired row the card
// must read one weight row of Bj (or N) floats and does 2 flops per float
// (5 with the compensation below), far below the ~20 flop/byte float32 ridge of an H100.  The least time is
// (fired rows x row bytes + spike and index bytes + output bytes) divided by
// the memory rate (3.35 TB/s on an H100 SXM).
//
// Design.  The TPU kernel is a block-masked dense matmul: it reads every
// K*B*Bj weight of a tile whose spike block has any spike, because the TPU
// has no cheap scatter.  Here a CUDA block owns one (rank, tile of output
// columns), walks the tiles k = 0..K-1 in order, compacts the nonzero rows
// of the tile's spike block (up to 4096 rows at a time) into shared memory
// with warp ballots and a prefix sum, and reads only those weight rows:
// each warp reads whole contiguous row segments (coalesced).  A tile with
// no spike costs only the read of its spikes.  Each thread sums its column
// in ascending (k, row) order with compensated (Kahan) summation and no
// atomics: the result is the same bit for bit from run to run, and its error
// stays near one rounding even when all 32,768 rows of a network fire at
// once (a plain float32 sum drifts by about sqrt(n) roundings there).  For
// the sparse engine, whose tiles of one destination are sorted by source,
// the order is ascending global row order, the order spike_accum uses; both
// skip zero weights, so the two kernels agree bit for bit on the same
// synapses.  Spikes are multiplied by their value (weighted spikes
// allowed); zero padding tiles change nothing.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// each launcher returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads per block = output columns per block.  256 was fastest for both
// kernels at every firing rate from 0 to 100 % on an H100 (32-256 tried):
// more warps compact a spike chunk sooner.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;             // spike rows compacted at once
constexpr int kBatch = 16;               // weight rows loaded at once

// Compacts the nonzero entries of s[0, rows) (rows <= kChunk) into
// (sh_idx, sh_val) in ascending row order and returns their count (in every
// thread).  Warp w scans the contiguous segment [w * seg, (w + 1) * seg):
// a first pass counts with ballots, a prefix over the warps' counts gives
// each warp its offset, and a second pass writes.  A silent chunk costs
// only the first pass.  All threads of the block must call it.
__device__ __forceinline__ int compact_fired(const float* __restrict__ s,
                                             int rows, int* sh_idx,
                                             float* sh_val, int* sh_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int seg = (rows + 32 * n_warps - 1) / (32 * n_warps) * 32;
  const int lo = warp * seg;
  const int hi = lo + seg;  // the same bound for every lane of the warp
  int count = 0;
#pragma unroll 8
  for (int i = lo + lane; i < hi; i += 32) {
    const float v = (i < rows) ? __ldg(s + i) : 0.0f;
    count += __popc(__ballot_sync(0xffffffffu, v != 0.0f));
  }
  if (lane == 0) sh_warp[warp] = count;
  __syncthreads();
  int offset = 0;
  int total = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = sh_warp[w];
    offset += (w < warp) ? c : 0;
    total += c;
  }
  if (total > 0 && count > 0) {
    const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
    for (int i = lo + lane; i < hi; i += 32) {
      const float v = (i < rows) ? __ldg(s + i) : 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, v != 0.0f);
      if (v != 0.0f) {
        const int pos = offset + __popc(ballot & below);
        sh_idx[pos] = i;
        sh_val[pos] = v;
      }
      offset += __popc(ballot);
    }
  }
  __syncthreads();
  return total;
}

// acc += s * w with Kahan compensation comp; a zero weight changes nothing.
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float s,
                                          float w) {
  if (w != 0.0f) {
    const float y = fmaf(s, w, -comp);
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
  }
}

// (acc, comp) += sum over the fired rows i of s[i] * w[i * ld], rows
// ascending, for one spike vector s[0, rows) against a weight tile whose
// column of this thread starts at w.  Compensated (Kahan) summation: comp
// carries the low-order bits lost so far, so the error does not grow with
// the number of fired rows.  A zero weight is skipped, so absent rows and
// zero padding tiles leave (acc, comp) exactly as they were.  All threads
// of the block must call it.
__device__ __forceinline__ void accumulate_tile(
    float& acc, float& comp, const float* __restrict__ s,
    const float* __restrict__ w, int rows, size_t ld, bool active,
    int* sh_idx, float* sh_val, int* sh_warp) {
  for (int base = 0; base < rows; base += kChunk) {
    const int n = min(kChunk, rows - base);
    const int n_fired = compact_fired(s + base, n, sh_idx, sh_val, sh_warp);
    if (active && n_fired > 0) {
      const float* wb = w + static_cast<size_t>(base) * ld;
      int f = 0;
      // kBatch weight loads in flight before the dependent update chain
      for (; f + kBatch <= n_fired; f += kBatch) {
        float wv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          wv[u] = __ldg(wb + static_cast<size_t>(sh_idx[f + u]) * ld);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          kahan_add(acc, comp, sh_val[f + u], wv[u]);
        }
      }
      for (; f < n_fired; ++f) {
        kahan_add(acc, comp, sh_val[f],
                  __ldg(wb + static_cast<size_t>(sh_idx[f]) * ld));
      }
    }
    if (n_fired > 0) __syncthreads();  // the list is rewritten by the next chunk
  }
}

// grid (ceil(Bj / kThreads), n_dev); block (kThreads).
__global__ void spike_accum_blocks_kernel(const float* __restrict__ s_blocks,
                                          const int* __restrict__ src_ids,
                                          const float* __restrict__ blocks,
                                          float* __restrict__ out, int n_blocks,
                                          int b, int k_tiles, int bj) {
  __shared__ int sh_idx[kChunk];
  __shared__ float sh_val[kChunk];
  __shared__ int sh_warp[kWarps];
  const int d = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = col < bj;
  const size_t tile = static_cast<size_t>(b) * bj;
  const float* s_d = s_blocks + static_cast<size_t>(d) * n_blocks * b;
  const int* src_d = src_ids + static_cast<size_t>(d) * k_tiles;
  const float* blk_d = blocks + static_cast<size_t>(d) * k_tiles * tile;
  float acc = 0.0f;
  float comp = 0.0f;
  for (int k = 0; k < k_tiles; ++k) {
    const int src = src_d[k];
    if (src < 0 || src >= n_blocks) continue;  // uniform across the block
    accumulate_tile(acc, comp, s_d + static_cast<size_t>(src) * b,
                    blk_d + k * tile + (active ? col : 0), b, bj, active,
                    sh_idx, sh_val, sh_warp);
  }
  if (active) out[static_cast<size_t>(d) * bj + col] = acc;
}

// grid (ceil(N / kThreads)); block (kThreads).
__global__ void spike_accum_kernel(const float* __restrict__ s,
                                   const float* __restrict__ w,
                                   float* __restrict__ out, int m, int n) {
  __shared__ int sh_idx[kChunk];
  __shared__ float sh_val[kChunk];
  __shared__ int sh_warp[kWarps];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = col < n;
  float acc = 0.0f;
  float comp = 0.0f;
  accumulate_tile(acc, comp, s, w + (active ? col : 0), m, n, active, sh_idx,
                  sh_val, sh_warp);
  if (active) out[col] = acc;
}

}  // namespace

extern "C" int spike_accum_blocks_launch(const void* s_blocks,
                                         const void* src_ids,
                                         const void* blocks, void* out,
                                         int n_dev, int n_blocks, int b,
                                         int k_tiles, int bj, void* stream) {
  if (n_dev <= 0 || bj <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((bj + kThreads - 1) / kThreads, n_dev);
  spike_accum_blocks_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s_blocks), static_cast<const int*>(src_ids),
      static_cast<const float*>(blocks), static_cast<float*>(out), n_blocks, b,
      k_tiles, bj);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spike_accum_launch(const void* s, const void* w, void* out,
                                  int m, int n, void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kThreads - 1) / kThreads);
  spike_accum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(w),
      static_cast<float*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}
