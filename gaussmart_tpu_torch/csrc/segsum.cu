// segsum: per-segment sums of gradient rows taken through a slot map.
//
// Replaces the TPU kernel gaussmart_tpu/render/segsum_pallas.py::_kernel
// (launched from segment_sum_sorted), which contracts 512-row chunks
// against a one-hot segment-selection matrix on the MXU, 128 segments per
// grid step, with the ids riding inside the rows at lane 20. The JAX
// backward first gathers the per-entry rows into splat-major work-slot
// order through binning's inverse permutation (inv_slots) and then sums
// each splat's run. Here the gather is part of the kernel: segment s owns
// the work slots [slot_starts[s], slot_starts[s+1]), slot k reads row
// order[k] (k itself when order is null), and no reordered copy of the
// rows is ever written. With a walk test (the backward's default compact
// route) slot k is read only if its row lies below its tile's walk limit,
// tile_limit[slot_tile[k]]: the backward writes no row past it, so the
// skipped rows are exact zeros, and a skipped slot adds 0.0f in its place.
//
// What bounds it on the card: bytes. Each read row is 80 bytes at F = 20,
// plus 4 bytes of order and 4 of slot_tile per slot; each segment writes
// one 80-byte row. What the design does about it:
// - No search: the segment bounds are slot_starts, two loads per segment.
// - A row is five 16-byte loads, one per lane: 5 lanes own a segment and
//   a warp holds 6 segments (30 of 32 lanes busy); the 6 segments'
//   30 output float4s are one contiguous 480-byte store.
// - Each lane adds its segment's rows in slot order, one add per element,
//   so the sum is the plain version's to the bit and two launches are
//   bit-equal; the loop is unrolled UNROLL deep with every index and row
//   load of a step issued before its adds, so a lane has UNROLL rows in
//   flight instead of a chain of dependent loads.
// (One warp per segment, 6 rows per step and the row groups combined by
// shuffles in a fixed order, was 31% slower on the default route's rows
// of a full-width training frame on an H100; PERF.md.)
//
// Rounding: adds only (-fmad=false changes nothing here).

#include <cuda_runtime.h>

namespace {

constexpr int F = 20;                  // floats per row
constexpr int PIECES = F / 4;          // float4 pieces per row: lanes per segment
constexpr int GROUPS = 32 / PIECES;    // segments per warp
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;

// the row that slot k reads, or -1 where the walk test skips it
template <bool ORDER, bool WALK>
__device__ __forceinline__ int slot_row(const int* __restrict__ order,
                                        const int* __restrict__ slot_tile,
                                        const int* __restrict__ tile_limit, int k) {
  const int r = ORDER ? __ldg(order + k) : k;
  if (WALK && r >= __ldg(tile_limit + __ldg(slot_tile + k))) return -1;
  return r;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// lane (g, c) of a warp: piece c of segment g's rows, added in slot order
// from 0, UNROLL slots' indices and rows loaded before their adds
template <bool ORDER, bool WALK>
__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float4* __restrict__ rows, const int* __restrict__ order,
              const int* __restrict__ slot_starts, const int* __restrict__ slot_tile,
              const int* __restrict__ tile_limit, int n_segments, int n_out,
              float4* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int g = lane / PIECES, c = lane % PIECES;
  const int seg = (blockIdx.x * WARPS + threadIdx.x / 32) * GROUPS + g;
  if (g >= GROUPS || seg >= n_out) return;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc = zero;
  if (seg < n_segments) {
    const int hi = __ldg(slot_starts + seg + 1);
    int k = __ldg(slot_starts + seg);
    for (; k + UNROLL <= hi; k += UNROLL) {
      int r[UNROLL];
      float4 v[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        r[j] = slot_row<ORDER, WALK>(order, slot_tile, tile_limit, k + j);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        v[j] = r[j] >= 0 ? __ldg(rows + (size_t)r[j] * PIECES + c) : zero;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) acc = add4(acc, v[j]);
    }
    for (; k < hi; ++k) {
      const int r = slot_row<ORDER, WALK>(order, slot_tile, tile_limit, k);
      acc = add4(acc, r >= 0 ? __ldg(rows + (size_t)r * PIECES + c) : zero);
    }
  }
  out[(size_t)seg * PIECES + c] = acc;
}

template <bool ORDER, bool WALK>
void launch(const void* rows, const void* order, const void* slot_starts,
            const void* slot_tile, const void* tile_limit, int n_segments, int n_out,
            void* out, cudaStream_t stream) {
  const int per_block = WARPS * GROUPS;
  segsum_kernel<ORDER, WALK><<<(n_out + per_block - 1) / per_block, THREADS, 0, stream>>>(
      (const float4*)rows, (const int*)order, (const int*)slot_starts,
      (const int*)slot_tile, (const int*)tile_limit, n_segments, n_out, (float4*)out);
}

}  // namespace

// rows [m, 20] f32, 16-byte aligned; order [w] i32 (row of each slot;
// null: slot k reads row k); slot_starts [n_segments + 1] i32
// non-decreasing, segment s owning slots [slot_starts[s],
// slot_starts[s+1]); slot_tile [w] i32 and tile_limit [tiles] i32, both
// null or both set: slot k is read only if its row < tile_limit[slot_tile
// [k]]. out [n_out, 20] f32 (n_out >= n_segments), 16-byte aligned: every
// row written, rows n_segments.. and empty segments with 0.
extern "C" int segsum(const void* rows, const void* order, const void* slot_starts,
                      const void* slot_tile, const void* tile_limit, int n_segments,
                      int n_out, void* out, void* stream) {
  if (n_out > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const bool walk = slot_tile != nullptr;
    if (order && walk)
      launch<true, true>(rows, order, slot_starts, slot_tile, tile_limit, n_segments,
                         n_out, out, s);
    else if (order)
      launch<true, false>(rows, order, slot_starts, slot_tile, tile_limit, n_segments,
                          n_out, out, s);
    else if (walk)
      launch<false, true>(rows, order, slot_starts, slot_tile, tile_limit, n_segments,
                          n_out, out, s);
    else
      launch<false, false>(rows, order, slot_starts, slot_tile, tile_limit, n_segments,
                           n_out, out, s);
  }
  return (int)cudaGetLastError();
}
