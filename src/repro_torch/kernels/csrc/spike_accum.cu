// Spike -> current accumulation for Hopper (sm_90a): the brain
// simulation's synaptic-integration hot spot.
//
// Two functions, one design:
//
//   spike_accum_blocks  I[d, j] = sum_k s_blocks[d, src_ids[d, k], :] @ blocks[d, k, :, j]
//     Replaces the Pallas kernel repro/kernels/spike_accum.py:spike_accum_blocks
//     (:133, body _blocks_kernel :109): the block-CSR accumulation every
//     'sparse'/'ragged' step of the distributed engine runs.  Rank-stacked:
//     one call covers every rank d.
//
//   spike_accum         I[j] = sum_i s[i] * W[i, j]
//     Replaces repro/kernels/spike_accum.py:spike_accum (:62, body _kernel
//     :36): the single-device engine's current hook.  It is spike_accum_blocks
//     with one rank and no copy: a contiguous W f32[M, N] is already the
//     tile stack blocks[1, K, b, N] of K = ceil(M / b) row slabs (the last
//     one may be short), s their spike slabs, and tile k's source slab k.
//
// Bound on the card.  Both are memory-bound gathers: per fired row the card
// must read one weight row of Bj (or N) floats and does 2 flops per float
// (5 with the compensation below), far below the ~20 flop/byte float32
// ridge of an H100.  The least time is (fired rows x row bytes + spike and
// index bytes + output bytes) divided by the memory rate (3.35 TB/s on an
// H100 SXM).  Where few rows fire (1 % of 32,768 rows against 4,096
// columns: 5.4 MB, 1.6 us) the floor is latency instead: the compaction
// below, then each column's chain of dependent sums over the fired rows.
//
// The TPU kernel is a block-masked dense matmul: it reads every weight of
// a tile whose spike block has a positive spike, because the TPU has no
// cheap scatter.  Here only the weight rows whose spike is nonzero are read.
//
// Two launches per call:
//   compact_tiles_kernel  (tile k, rank d): the nonzero spikes of tile k's
//     source block, in ascending row order, as (row, value) lists and a
//     count, written once per call (warp ballots and a prefix sum); a
//     silent step costs one read of the spikes.
//   spike_accum_ring_kernel  (128-column tile, rank d), one thread per
//     output column: the block joins the rank's lists into one stream of
//     fired rows in (k, row) order (2,048 at a time in shared memory) and
//     streams each fired row's segment of 128 columns through a ring of 3
//     stages of 64 rows, filled by 16-byte cp.async copies (2 stages, 64 KB,
//     in flight while the threads sum the oldest from shared memory;
//     kernels/spike_accum.py: blocks_plan and dense_plan give the geometry).
//     One tile width serves both functions.  At spike_accum's N = 4,096 the
//     sums are bound by each column's chain over the fired rows, not by the
//     blocks in flight, and a fired row costs the least with 4 warps a
//     block: 32- and 64-column tiles, which give every SM a block, and
//     256-column ones were slower at every firing rate, and at N = 32,768
//     none was faster (development runs on an H100).
//
// Both sum each column in ascending (k, row) order with compensated
// (Kahan) summation and no atomics: the result is the same bit for bit
// from run to run, and its error stays near one rounding even when all
// 32,768 rows of a network fire at once (a plain float32 sum drifts by
// about sqrt(n) roundings there).  A column is one thread's chain, so the
// rows are never split across blocks.  For the sparse engine, whose tiles
// of one destination are sorted by source, the order is ascending global
// row order, the order spike_accum uses; both skip zero weights, so the
// two agree bit for bit on the same synapses.  Spikes are multiplied by
// their value (weighted spikes allowed, of either sign); zero padding
// tiles change nothing.
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

// Threads per block of the compaction kernel: more warps compact a spike
// block sooner.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
  // a 4,096-row block: every load of the count pass in flight at once
#pragma unroll 16
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

// grid (k_tiles, n_dev); block kThreads.  The nonzero spikes of tile k's
// source block s_blocks[d, src_ids[d, k]] as (fired_row, fired_val)[d, k, :]
// in ascending row order, their count in fired_n[d, k] (0 for a source
// outside [0, n_blocks)).  src_ids null: tile k's source is block k.  Every
// block holds b spikes but the last, which holds last_rows <= b.
__global__ void __launch_bounds__(kThreads)
    compact_tiles_kernel(const float* __restrict__ s_blocks, const int* __restrict__ src_ids,
                         int* __restrict__ fired_row, float* __restrict__ fired_val,
                         int* __restrict__ fired_n, int n_blocks, int b, int last_rows,
                         int k_tiles) {
  __shared__ int sh_warp[kWarps];
  const size_t slot = static_cast<size_t>(blockIdx.y) * k_tiles + blockIdx.x;
  const int src = src_ids ? src_ids[slot] : static_cast<int>(blockIdx.x);
  if (src < 0 || src >= n_blocks) {  // uniform across the block
    if (threadIdx.x == 0) fired_n[slot] = 0;
    return;
  }
  const float* s = s_blocks + (static_cast<size_t>(blockIdx.y) * n_blocks + src) * b;
  const int rows = src == n_blocks - 1 ? last_rows : b;
  const int total = compact_fired(s, rows, fired_row + slot * b, fired_val + slot * b, sh_warp);
  if (threadIdx.x == 0) fired_n[slot] = total;
}

constexpr int kColTile = 128;   // columns per block, one thread each
constexpr int kRingStages = 3;  // stages of the ring
constexpr int kRingRows = 64;   // fired rows per stage of the ring
constexpr int kListCap = 2048;  // fired rows listed in shared memory at once

// Shared memory of spike_accum_ring_kernel, the one owner of this size
// (the wrappers read it through spike_accum_ring_smem_bytes; their plans,
// kernels/spike_accum.py: blocks_plan and dense_plan, predict it for the
// CPU tests).
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

// The compaction of every (rank, tile), then the ring.
int launch(const float* s_blocks, const int* src_ids, const float* blocks, float* out,
           int* rows, float* vals, int* counts, int n_dev, int n_blocks, int b, int last_rows,
           int k_tiles, int bj, bool vec, cudaStream_t st) {
  compact_tiles_kernel<<<dim3(k_tiles, n_dev), kThreads, 0, st>>>(
      s_blocks, src_ids, rows, vals, counts, n_blocks, b, last_rows, k_tiles);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return vec ? launch_ring_as<true>(rows, vals, counts, blocks, out, n_dev, b, k_tiles, bj, st)
             : launch_ring_as<false>(rows, vals, counts, blocks, out, n_dev, b, k_tiles, bj, st);
}

}  // namespace

// Shared memory bytes of the ring kernel at k_tiles tiles (the wrappers
// raise before launch where they exceed what a block may hold).
extern "C" long long spike_accum_ring_smem_bytes(int k_tiles) {
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
  return launch(static_cast<const float*>(s_blocks), static_cast<const int*>(src_ids),
                static_cast<const float*>(blocks), static_cast<float*>(out),
                static_cast<int*>(fired_row), static_cast<float*>(fired_val),
                static_cast<int*>(fired_n), n_dev, n_blocks, b, b, k_tiles, bj, vec != 0,
                static_cast<cudaStream_t>(stream));
}

// s f32[m], w f32[m, n], out f32[n], all contiguous: W as k_tiles =
// ceil(m / b) row slabs of b rows (the last one m - (k_tiles - 1) * b),
// one rank; workspaces fired_row i32[m], fired_val f32[m], fired_n
// i32[k_tiles].  vec: n % 4 == 0 and w 16-byte aligned.
extern "C" int spike_accum_launch(const void* s, const void* w, void* out, void* fired_row,
                                  void* fired_val, void* fired_n, int m, int n, int b,
                                  int vec, void* stream) {
  if (m <= 0 || n <= 0 || b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_tiles = (m + b - 1) / b;
  return launch(static_cast<const float*>(s), nullptr, static_cast<const float*>(w),
                static_cast<float*>(out), static_cast<int*>(fired_row),
                static_cast<float*>(fired_val), static_cast<int*>(fired_n), 1, k_tiles, b,
                m - (k_tiles - 1) * b, k_tiles, n, vec != 0,
                static_cast<cudaStream_t>(stream));
}
