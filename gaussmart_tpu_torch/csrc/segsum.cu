// segsum: per-segment sums of rows grouped by non-decreasing segment ids.
//
// Replaces the TPU kernel gaussmart_tpu/render/segsum_pallas.py::_kernel
// (launched from segment_sum_sorted), which contracts 512-row chunks
// against a one-hot segment-selection matrix on the MXU, 128 segments per
// grid step, with the ids riding inside the rows at lane 20. Here the ids
// are their own tensor and there is no matrix product: one warp owns one
// segment, finds its row range [lo, hi) by two binary searches over the
// sorted ids, and lane j adds column j of rows lo..hi-1 in order, so the
// result is deterministic and needs no atomics.
//
// What bounds it on the card: bytes. Every row (80 bytes at F = 20) is
// read once and every output row written once, with one add per element;
// a warp's lanes read consecutive floats of a row, so the loads coalesce.
// The binary searches read log2(M) ids per segment, mostly from L2. In
// practice each warp waits on its loads one after another, so the row
// loop is unrolled to keep several loads in flight (the adds stay in row
// order); a segment of many thousand rows still takes one warp, so the
// caller leaves padding out of the segments (raster_tiled.grad_reduce).
//
// Rounding: each segment's sum is taken in row order, one rounding per
// add (-fmad=false is irrelevant: there is no multiply).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ int lower_bound(const int* __restrict__ ids, int m, int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (ids[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ rows, const int* __restrict__ ids,
              int m, int f, int n_segments, float* __restrict__ out) {
  const int seg = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= n_segments) return;
  const int lo = lower_bound(ids, m, seg);
  const int hi = lower_bound(ids, m, seg + 1);
  for (int c = lane; c < f; c += 32) {
    float acc = 0.0f;
#pragma unroll 4
    for (int r = lo; r < hi; ++r) acc = acc + rows[(size_t)r * f + c];
    out[(size_t)seg * f + c] = acc;
  }
}

}  // namespace

// rows [m, f] f32, ids [m] i32 non-decreasing; out [n_segments, f] f32,
// every element written (empty segments get 0).
extern "C" int segsum(const void* rows, const void* ids, int m, int f,
                      int n_segments, void* out, void* stream) {
  if (n_segments > 0) {
    const int blocks = (n_segments + WARPS - 1) / WARPS;
    segsum_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const int*)ids, m, f, n_segments, (float*)out);
  }
  return (int)cudaGetLastError();
}
