// Spike -> current accumulation for Hopper (sm_90a): the brain
// simulation's synaptic-integration hot spot.
//
// Two functions:
//
//   spike_accum_blocks  I[d, j] = sum_k s_blocks[d, src_ids[d, k], :] @ blocks[d, k, :, j]
//     Replaces the Pallas kernel repro/kernels/spike_accum.py:spike_accum_blocks
//     (:133, body _blocks_kernel :109): the block-CSR accumulation every
//     'sparse'/'ragged' step of the distributed engine runs.  Rank-stacked:
//     one call covers every rank d.
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
// The TPU kernel is a block-masked dense matmul: it reads every K*B*Bj
// weight of a tile whose spike block has any spike, because the TPU has no
// cheap scatter.  Here only the weight rows whose spike fired are read.
//
// spike_accum_blocks, two launches:
//   compact_tiles_kernel  (tile k, rank d): the nonzero spikes of tile k's
//     source block, in ascending row order, as (row, value) lists and a
//     count, written once per call (warp ballots and a prefix sum); a
//     silent step costs one read of the spikes.
//   spike_accum_ring_kernel  (128-column tile, rank d), one thread per
//     output column: the block joins the rank's lists into one stream of
//     fired rows in (k, row) order (2,048 at a time in shared memory) and
//     streams each fired row's segment of 128 columns through a ring of 3
//     stages of 64 rows, filled by 16-byte cp.async copies (2 stages,
//     64 KB, in flight while the threads sum the oldest from shared
//     memory; kernels/spike_accum.py: blocks_plan gives the geometry).
// spike_accum, one launch: one block per 256 columns compacts the spike
// vector 4,096 rows at a time and each thread loads its column of the
// fired rows kBatch at a time (not redesigned yet).
//
// Both sum each column in ascending (k, row) order with compensated
// (Kahan) summation and no atomics: the result is the same bit for bit
// from run to run, and its error stays near one rounding even when all
// 32,768 rows of a network fire at once (a plain float32 sum drifts by
// about sqrt(n) roundings there).  For the sparse engine, whose tiles of
// one destination are sorted by source, the order is ascending global row
// order, the order spike_accum uses; both skip zero weights, so the two
// agree bit for bit on the same synapses.  Spikes are multiplied by their
// value (weighted spikes allowed); zero padding tiles change nothing.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// each launcher returns the first nonzero cudaGetLastError() of its
// launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::cp_async_4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// Threads per block of spike_accum (= output columns per block) and of the
// compaction kernel.  256 was fastest for spike_accum at every firing rate
// from 0 to 100 % on an H100 (32-256 tried): more warps compact a spike
// chunk sooner.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;             // spike rows spike_accum compacts at once
constexpr int kBatch = 16;               // weight rows loaded at once

// Compacts the nonzero entries of s[0, rows) into (idx, val), shared or
// global memory with room for them, in ascending row order and returns
// their count (in every thread).  Warp w scans the contiguous segment [w * seg, (w + 1) * seg):
// a first pass counts with ballots, a prefix over the warps' counts gives
// each warp its offset, and a second pass writes.  A silent chunk costs
// only the first pass.  All threads of the block must call it.
__device__ __forceinline__ int compact_fired(const float* __restrict__ s,
                                             int rows, int* idx, float* val,
                                             int* sh_warp) {
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
        idx[pos] = i;
        val[pos] = v;
      }
      offset += __popc(ballot);
    }
  }
  __syncthreads();
  return total;
}

// acc += s * w with Kahan compensation comp; a zero weight changes nothing.
// Written without a branch (both sums are computed, the weight selects),
// so the dependent chain over the rows stays four operations long.
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float s,
                                          float w) {
  const float y = fmaf(s, w, -comp);
  const float t = acc + y;
  const float c = (t - acc) - y;
  const bool live = w != 0.0f;
  acc = live ? t : acc;
  comp = live ? c : comp;
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

// grid (k_tiles, n_dev); block kThreads.  The nonzero spikes of tile k's
// source block s_blocks[d, src_ids[d, k]] as (fired_row, fired_val)[d, k, :]
// in ascending row order, their count in fired_n[d, k] (0 for a source
// outside [0, n_blocks)).
__global__ void __launch_bounds__(kThreads)
    compact_tiles_kernel(const float* __restrict__ s_blocks, const int* __restrict__ src_ids,
                         int* __restrict__ fired_row, float* __restrict__ fired_val,
                         int* __restrict__ fired_n, int n_blocks, int b, int k_tiles) {
  __shared__ int sh_warp[kWarps];
  const size_t slot = static_cast<size_t>(blockIdx.y) * k_tiles + blockIdx.x;
  const int src = src_ids[slot];
  if (src < 0 || src >= n_blocks) {  // uniform across the block
    if (threadIdx.x == 0) fired_n[slot] = 0;
    return;
  }
  const float* s = s_blocks + (static_cast<size_t>(blockIdx.y) * n_blocks + src) * b;
  const int total = compact_fired(s, b, fired_row + slot * b, fired_val + slot * b, sh_warp);
  if (threadIdx.x == 0) fired_n[slot] = total;
}

constexpr int kColTile = 128;   // columns per block, one thread each
constexpr int kRingStages = 3;  // stages of the ring
constexpr int kRingRows = 64;   // fired rows per stage of the ring
constexpr int kListCap = 2048;  // fired rows listed in shared memory at once

// Shared memory of spike_accum_ring_kernel, the one owner of this size
// (the wrapper reads it through spike_accum_blocks_smem_bytes; its plan,
// kernels/spike_accum.py: blocks_plan, predicts it for the CPU tests).
constexpr long long ring_smem_bytes(int k_tiles) {
  return 4LL * kRingStages * kRingRows * kColTile + 8LL * kListCap + 4LL * (k_tiles + 1);
}

// grid (ceil(bj / kColTile), n_dev); block kColTile threads, thread i sums
// column blockIdx.x * kColTile + i of rank d over the rank's fired rows,
// read from a cp.async ring of kRingStages stages.  VEC (bj % 4 == 0 and
// blocks 16-byte aligned): thread i copies 16-byte piece i % (kColTile / 4)
// of every 4th row of a stage; else each thread copies its own column,
// 4 bytes a row.  A full
// stage's copies are issued between the rows of the stage being summed,
// in the idle issue slots of the dependent chain.
template <bool VEC>
__global__ void __launch_bounds__(kColTile)
    spike_accum_ring_kernel(const int* __restrict__ fired_row,
                            const float* __restrict__ fired_val,
                            const int* __restrict__ fired_n, const float* __restrict__ blocks,
                            float* __restrict__ out, int b, int k_tiles, int bj) {
  constexpr int kSeg = kColTile / 4;                   // 16-byte pieces of a row segment
  constexpr int kRowStep = VEC ? kColTile / kSeg : 1;  // rows between a thread's copies
  extern __shared__ float smem[];
  float* ring = smem;  // [kRingStages][kRingRows][kColTile]
  int* list_off =      // k * b + row
      reinterpret_cast<int*>(ring + kRingStages * kRingRows * kColTile);
  float* list_val = reinterpret_cast<float*>(list_off + kListCap);
  int* start = reinterpret_cast<int*>(list_val + kListCap);  // [k_tiles + 1]
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kColTile;
  const bool active = col0 + tid < bj;
  const size_t slot0 = static_cast<size_t>(blockIdx.y) * k_tiles;
  // this thread's copies: column piece c4 of rows r_first, r_first + kRowStep, ...
  const int c4 = VEC ? (tid % kSeg) * 4 : tid;
  const int r_first = VEC ? tid / kSeg : 0;
  const bool copies = c4 < bj - col0;
  if (tid == 0) {  // where each tile's fired rows start in the rank's stream
    int run = 0;
    for (int k = 0; k < k_tiles; ++k) {
      start[k] = run;
      run += fired_n[slot0 + k];
    }
    start[k_tiles] = run;
  }
  __syncthreads();
  const int total = start[k_tiles];
  const float* src = blocks + slot0 * b * bj + col0 + c4;
  float acc = 0.0f;
  float comp = 0.0f;
  for (int j0 = 0; j0 < total; j0 += kListCap) {
    const int n = min(kListCap, total - j0);
    __syncthreads();  // the previous list's and ring's readers are done
    {  // every load of this thread's list entries in flight at once
      constexpr int kPer = kListCap / kColTile;
      int tile[kPer], row[kPer];
      float val[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (tid + u * kColTile >= n) continue;
        const int pos = j0 + tid + u * kColTile;
        int lo = 0;  // the tile k with start[k] <= pos < start[k + 1]
        int hi = k_tiles;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (start[mid] <= pos) lo = mid; else hi = mid;
        }
        tile[u] = lo;
        const size_t at = (slot0 + lo) * b + (pos - start[lo]);
        row[u] = fired_row[at];
        val[u] = fired_val[at];
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = tid + u * kColTile;
        if (j < n) {
          list_off[j] = tile[u] * b + row[u];
          list_val[j] = val[u];
        }
      }
    }
    __syncthreads();
    const int n_st = (n + kRingRows - 1) / kRingRows;
    auto copy_row = [&](int st, int r) {  // row r of stage st, this thread's piece
      float* dst = ring + (st % kRingStages) * kRingRows * kColTile + c4 + r * kColTile;
      const float* row = src + static_cast<long long>(list_off[st * kRingRows + r]) * bj;
      if (VEC) {
        cp_async_16(dst, row, 16);
      } else {
        cp_async_4(dst, row);
      }
    };
    auto issue = [&](int st) {  // the row segments of stage st
      if (!copies) return;
      const int rows = min(kRingRows, n - st * kRingRows);
      for (int r = r_first; r < rows; r += kRowStep) copy_row(st, r);
    };
    for (int st = 0; st < kRingStages - 1; ++st) {
      if (st < n_st) issue(st);
      cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
      cp_async_wait<kRingStages - 2>();
      __syncthreads();  // stage st landed; stage st - 1's readers are done
      const int next = st + kRingStages - 1;  // the stage to fill into the slot just freed
      const int rows = min(kRingRows, n - st * kRingRows);
      const float* w = ring + (st % kRingStages) * kRingRows * kColTile + tid;
      const float* v = list_val + st * kRingRows;
      if (rows == kRingRows && active) {
        // a full stage: every load ahead of the dependent chain, and the
        // next stage's copies between its rows
        const int next_rows = next < n_st ? min(kRingRows, n - next * kRingRows) : 0;
        float wv[kRingRows];
#pragma unroll
        for (int r = 0; r < kRingRows; ++r) wv[r] = w[r * kColTile];
#pragma unroll
        for (int r = 0; r < kRingRows; ++r) {
          kahan_add(acc, comp, v[r], wv[r]);
          if (r % kRowStep == kRowStep - 1) {
            const int rr = r_first + r / kRowStep * kRowStep;
            if (copies && rr < next_rows) copy_row(next, rr);
          }
        }
      } else {
        if (next < n_st) issue(next);
        if (active) {
          for (int r = 0; r < rows; ++r) kahan_add(acc, comp, v[r], w[r * kColTile]);
        }
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
  }
  if (active) out[static_cast<size_t>(blockIdx.y) * bj + col0 + tid] = acc;
}

template <bool VEC>
int launch_ring_as(const int* fired_row, const float* fired_val, const int* fired_n,
                   const float* blocks, float* out, int n_dev, int b, int k_tiles, int bj,
                   cudaStream_t stream) {
  const long long smem = ring_smem_bytes(k_tiles);
  cudaError_t err = cudaFuncSetAttribute(spike_accum_ring_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((bj + kColTile - 1) / kColTile, n_dev);
  spike_accum_ring_kernel<VEC><<<grid, kColTile, smem, stream>>>(
      fired_row, fired_val, fired_n, blocks, out, b, k_tiles, bj);
  return static_cast<int>(cudaGetLastError());
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

// Shared memory bytes of the ring kernel at k_tiles tiles (the wrapper
// raises before launch where they exceed what a block may hold).
extern "C" long long spike_accum_blocks_smem_bytes(int k_tiles) {
  return ring_smem_bytes(k_tiles);
}

// s_blocks f32[n_dev, n_blocks, b], src_ids i32[n_dev, k_tiles], blocks
// f32[n_dev, k_tiles, b, bj], out f32[n_dev, bj]; workspaces fired_row
// i32[n_dev, k_tiles, b], fired_val f32[n_dev, k_tiles, b], fired_n
// i32[n_dev, k_tiles]; all contiguous.  vec: bj % 4 == 0 and blocks
// 16-byte aligned (16-byte copies), else 4-byte copies.
extern "C" int spike_accum_blocks_launch(const void* s_blocks, const void* src_ids,
                                         const void* blocks, void* out, void* fired_row,
                                         void* fired_val, void* fired_n, int n_dev,
                                         int n_blocks, int b, int k_tiles, int bj,
                                         int vec, void* stream) {
  if (n_dev <= 0 || bj <= 0 || b < 0 || k_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* rows = static_cast<int*>(fired_row);
  float* vals = static_cast<float*>(fired_val);
  int* counts = static_cast<int*>(fired_n);
  compact_tiles_kernel<<<dim3(k_tiles, n_dev), kThreads, 0, st>>>(
      static_cast<const float*>(s_blocks), static_cast<const int*>(src_ids), rows, vals, counts,
      n_blocks, b, k_tiles);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const float* blk = static_cast<const float*>(blocks);
  float* o = static_cast<float*>(out);
  return vec ? launch_ring_as<true>(rows, vals, counts, blk, o, n_dev, b, k_tiles, bj, st)
             : launch_ring_as<false>(rows, vals, counts, blk, o, n_dev, b, k_tiles, bj, st);
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
