// binning: the frame's (splat, tile) pairs sorted by (tile, depth), K7.
//
// Replaces no TPU kernel: the JAX package's binning (gaussmart_tpu/render/
// raster_pallas.py::_binning) is XLA, not Pallas. Run eagerly by PyTorch,
// the same chain (render/raster_tiled.py::binning_plain, this kernel's
// plain twin) is about 35 launches, each a pass over every splat or over
// every rectangle pair of the frame, in int64. This file computes it in
// three launches around one torch.sort, with the same outputs to the bit
// (raster_tiled.py::Binned, every field and its length):
//
//   bin_count   one thread a splat: its clipped 16x16-tile rectangle from
//               (center2d, rx, ry, valid), then over each of its rectangle
//               rows the column interval of _x_extent on its conic row (the
//               binning_plain expressions, in their order); writes the
//               splat's live pair count, and adds the frame's rectangle and
//               live totals on the device. The host scans the counts
//               (slot_starts) and reads the totals in its one sync.
//   bin_emit    one thread a splat: its live pairs at slot_starts[s], its
//               tiles ascending (splat-major), each the key (tile << 32) |
//               depth bits and the splat id; with the reduction plan also
//               the slot's tile.
//   (torch.sort of the live keys, stable: equal keys keep slot order,
//   which is what the plain chain's stable sort of the padded buffer
//   gives its live prefix)
//   bin_finish  one thread a sorted position: the entry's splat id (N past
//               the live pairs), the tile ranges where adjacent keys change
//               tile, and with the plan the inverse permutation (the tail
//               fixed, as the padded sort leaves the dead slots) and the
//               dead slots' tiles (the plain chain's values).
//
// What bounds it on the card: bytes. Every visible splat's centre, radii,
// depth, valid flag and 8 conic terms are read twice (count, emit), about
// 2 x 53 bytes a splat; each live pair is written once as a 12-byte key
// and id (16 with the plan), then read sorted and written as a 4-byte
// entry id; the interval test is a few dozen float operations a rectangle
// row. What the design does about it:
// - Nothing the size of the rectangle pairs is ever made: the pairs are
//   counted first, so the buffers hold the live pairs only and the sort
//   runs over them alone (the plain chain sorts int64 keys over every
//   rectangle slot, 12-16% of them dead), and no pair is expanded,
//   searched for or gathered through int64 index arrays.
// - The row intervals are evaluated twice (count and emit) instead of
//   being stored: a row's interval costs less to recompute than to write
//   and read back.
// - The frame's totals reach the host in one 24-byte copy, binning's one
//   sync; the tile ranges come from the sorted keys in the finishing pass.
//
// Rounding: compiled with -fmad=false and IEEE division and square root,
// so each operation of the interval test rounds as binning_plain's PyTorch
// ops on the card; NaN propagates as in torch.clamp, clamp_min, maximum
// and minimum, and floats convert to int64 as PyTorch's .to(torch.int64).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 16;
constexpr int FC = 8;          // conic columns: A B ccx ccy D4 dx_m dy_r rd2
constexpr float BIGX = 1e9f;
constexpr unsigned FULL = 0xffffffffu;

#define F32(x) ((float)(x))   // a Python float as PyTorch rounds it

__device__ __forceinline__ float tclamp(float v, float lo, float hi) {   // torch.clamp
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {   // torch.clamp_min
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float tmax(float a, float b) {          // torch.maximum
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {          // torch.minimum
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ long long lclamp(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A splat's clipped tile rectangle: columns [tx0, tx0 + nx), rows [ty0,
// ty0 + ny); nx = ny = 0 for a splat that is not valid.
struct Rect {
  long long tx0, nx, ty0, ny;
};

__device__ __forceinline__ Rect splat_rect(float cx, float cy, float rx, float ry, bool valid,
                                           int tiles_x, int tiles_y) {
  Rect r;
  const float inv_t = 1.0f / (float)TILE;
  r.tx0 = (long long)tclamp(floorf((cx - rx) * inv_t), 0.0f, (float)tiles_x);
  const long long tx1 = (long long)tclamp(floorf((cx + rx) * inv_t) + 1.0f, 0.0f,
                                          (float)tiles_x);
  r.ty0 = (long long)tclamp(floorf((cy - ry) * inv_t), 0.0f, (float)tiles_y);
  const long long ty1 = (long long)tclamp(floorf((cy + ry) * inv_t) + 1.0f, 0.0f,
                                          (float)tiles_y);
  const bool v = valid && rx > 0.0f && ry > 0.0f;
  r.nx = v ? tx1 - r.tx0 : 0;
  r.ny = v ? ty1 - r.ty0 : 0;
  return r;
}

// The columns [cx0, cx0 + cnt) of tile row ty that the splat can touch:
// raster_tiled.py::_row_intervals, _x_extent over the row's 16 pixel rows
// on the splat's conic terms (c0, c1), clamped to its rectangle columns.
__device__ __forceinline__ void row_interval(float4 c0, float4 c1, float scx, float scy,
                                             long long ty, long long tx0, long long nx,
                                             long long* cx0, long long* cnt) {
  const float eA = c0.x, eB = c0.y, ccx = c0.z, ccy = c0.w;
  const float D4 = c1.x, dx_m = c1.y, dy_r = c1.z, rd2 = c1.w;
  float xlo = -BIGX, xhi = BIGX;   // no usable ellipse: the whole rectangle row
  if (eA > 0.0f) {
    const float b0 = (float)ty * (float)TILE;
    const float b1 = b0 + (float)(TILE - 1);
    const float d0 = b0 - ccy;
    const float d1 = b1 - ccy;
    const float dy_rc = tclamp(dy_r, d0, d1);
    const float dy_lc = tclamp(-dy_r, d0, d1);
    const float disc_r = 4.0f * eA - D4 * dy_rc * dy_rc;
    const float disc_l = 4.0f * eA - D4 * dy_lc * dy_lc;
    const float dy_near = tclamp(0.0f, d0, d1);
    const bool e_hit = D4 * dy_near * dy_near <= 4.0f * eA * F32(1.0 + 2e-2) + F32(1e-6);
    const float xhi_e = ccx + (-eB * dy_rc + sqrtf(clamp_min(disc_r, 0.0f))) / (2.0f * eA);
    const float xlo_e = ccx + (-eB * dy_lc - sqrtf(clamp_min(disc_l, 0.0f))) / (2.0f * eA);
    const float err_e = F32(2e-2) * (dx_m + fabsf(dy_rc) + fabsf(dy_lc)) + F32(0.51);
    const float dmin_d = clamp_min(tmax(b0 - scy, scy - b1), 0.0f);
    const bool d_hit = dmin_d * dmin_d <= rd2 * F32(1.0 + 1e-5) + F32(1e-5);
    const float hw = sqrtf(clamp_min(rd2 - dmin_d * dmin_d, 0.0f)) + F32(0.51);
    xlo = tmin(e_hit ? xlo_e - err_e : BIGX, d_hit ? scx - hw : BIGX);
    xhi = tmax(e_hit ? xhi_e + err_e : -BIGX, d_hit ? scx + hw : -BIGX);
  }
  const float inv_t = F32(1.0 / TILE);
  const long long lo = (long long)floorf(xlo * inv_t);
  const long long hi = (long long)floorf(xhi * inv_t) + 1;
  *cx0 = lclamp(lo, tx0, tx0 + nx);
  const long long cx1 = lclamp(hi, tx0, tx0 + nx);
  *cnt = cx1 - *cx0 > 0 ? cx1 - *cx0 : 0;
}

struct Inputs {
  const float* center2d;   // element (s, k) at s * cstride + k
  int cstride;
  const float* rx;
  const float* ry;
  const bool* valid;
  const float* conics;     // [N+1, 8], 16-byte aligned
  int n, tiles_x, tiles_y;
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_down_sync(FULL, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// totals: [0] rectangle pairs, [1] live pairs, [2] (s + 1) << 32 | base of
// the last splat s with rectangle rows, base = ty * tiles_x + cx0 + cnt of
// its last row: the plain chain gives dead slot k the tile base - live + k
__global__ void __launch_bounds__(THREADS) bin_count_kernel(Inputs in, int* __restrict__ counts,
                                                            int* __restrict__ slot_starts,
                                                            unsigned long long* __restrict__ totals) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  unsigned long long rect = 0, live = 0, last = 0;
  if (s < in.n) {
    const float cx = in.center2d[(size_t)s * in.cstride];
    const float cy = in.center2d[(size_t)s * in.cstride + 1];
    const Rect r = splat_rect(cx, cy, in.rx[s], in.ry[s], in.valid[s], in.tiles_x, in.tiles_y);
    long long n_live = 0;
    if (r.ny > 0) {
      const float4* c = reinterpret_cast<const float4*>(in.conics + (size_t)FC * s);
      const float4 c0 = c[0], c1 = c[1];
      long long cx0 = 0, cnt = 0;
      for (long long ty = r.ty0; ty < r.ty0 + r.ny; ++ty) {
        row_interval(c0, c1, cx, cy, ty, r.tx0, r.nx, &cx0, &cnt);
        n_live += cnt;
      }
      rect = (unsigned long long)(r.nx * r.ny);
      live = (unsigned long long)n_live;
      const long long base = (r.ty0 + r.ny - 1) * in.tiles_x + cx0 + cnt;
      last = ((unsigned long long)(s + 1) << 32) | (unsigned long long)(unsigned)base;
    }
    counts[s] = (int)n_live;
  }
  if (s == 0) slot_starts[0] = 0;
  __shared__ unsigned long long part[3][THREADS / 32];
  rect = warp_sum(rect);
  live = warp_sum(live);
  last = warp_max(last);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = rect;
    part[1][warp] = live;
    part[2][warp] = last;
  }
  __syncthreads();
  if (warp == 0) {
    rect = lane < THREADS / 32 ? part[0][lane] : 0;
    live = lane < THREADS / 32 ? part[1][lane] : 0;
    last = lane < THREADS / 32 ? part[2][lane] : 0;
    rect = warp_sum(rect);
    live = warp_sum(live);
    last = warp_max(last);
    if (lane == 0) {
      if (rect) atomicAdd(totals, rect);
      if (live) atomicAdd(totals + 1, live);
      if (last) atomicMax(totals + 2, last);
    }
  }
}

__global__ void __launch_bounds__(THREADS) bin_emit_kernel(Inputs in,
                                                           const float* __restrict__ depth,
                                                           const int* __restrict__ slot_starts,
                                                           long long* __restrict__ keys,
                                                           int* __restrict__ pair_sid,
                                                           int* __restrict__ slot_tile) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= in.n) return;
  int k = slot_starts[s];
  if (slot_starts[s + 1] == k) return;
  const float cx = in.center2d[(size_t)s * in.cstride];
  const float cy = in.center2d[(size_t)s * in.cstride + 1];
  const Rect r = splat_rect(cx, cy, in.rx[s], in.ry[s], in.valid[s], in.tiles_x, in.tiles_y);
  const float4* c = reinterpret_cast<const float4*>(in.conics + (size_t)FC * s);
  const float4 c0 = c[0], c1 = c[1];
  const long long bits = (long long)__float_as_int(depth[s]);   // sign-extended, as .to(int64)
  for (long long ty = r.ty0; ty < r.ty0 + r.ny; ++ty) {
    long long cx0, cnt;
    row_interval(c0, c1, cx, cy, ty, r.tx0, r.nx, &cx0, &cnt);
    for (long long tile = ty * in.tiles_x + cx0, end = tile + cnt; tile < end; ++tile, ++k) {
      keys[k] = (tile << 32) | bits;
      pair_sid[k] = s;
      if (slot_tile) slot_tile[k] = (int)tile;
    }
  }
}

// One thread per position i < max(n_rect, n_live + 1) of the sorted buffer.
__global__ void __launch_bounds__(THREADS) bin_finish_kernel(
    const long long* __restrict__ sorted_keys, const long long* __restrict__ perm,
    const int* __restrict__ pair_sid, const unsigned long long* __restrict__ totals,
    long long n_live, long long n_rect, int n, int n_tiles, int* __restrict__ entry_ids,
    int* __restrict__ tile_ranges, int* __restrict__ inv_slots, int* __restrict__ slot_tile) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n_rect) {
    if (i < n_live) {
      const long long slot = perm[i];
      entry_ids[i] = pair_sid[slot];
      if (inv_slots) inv_slots[slot] = (int)i;
    } else {
      entry_ids[i] = n;
      if (inv_slots) inv_slots[i] = (int)i;
      if (slot_tile) {
        const long long base = (long long)(unsigned)(totals[2] & 0xffffffffull);
        slot_tile[i] = (int)(base - n_live + i);
      }
    }
  }
  if (i <= n_live) {
    // tiles (prev, cur] start at i: the first sorted key of tile >= t
    const int cur = i < n_live ? (int)(sorted_keys[i] >> 32) : n_tiles;
    const int prev = i > 0 ? (int)(sorted_keys[i - 1] >> 32) : -1;
    for (int t = prev + 1; t <= cur; ++t) {
      if (t < n_tiles) tile_ranges[2 * t] = (int)i;
      if (t > 0) tile_ranges[2 * t - 1] = (int)i;
    }
  }
}

int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

Inputs inputs(const void* center2d, int cstride, const void* rx, const void* ry,
              const void* valid, const void* conics, int n, int tiles_x, int tiles_y) {
  return Inputs{(const float*)center2d, cstride, (const float*)rx, (const float*)ry,
                (const bool*)valid, (const float*)conics, n, tiles_x, tiles_y};
}

}  // namespace

// center2d: [N, 2] f32 with rows `cstride` floats apart; rx, ry [N] f32,
// valid [N] bool, conics [N+1, 8] f32 (16-byte aligned), each contiguous.
// Writes counts [N] i32 (each splat's live pairs), slot_starts[0] = 0 and
// totals [3] (see bin_count_kernel), which it zeroes first.
extern "C" int bin_count(const void* center2d, int cstride, const void* rx, const void* ry,
                         const void* valid, const void* conics, int n, int tiles_x,
                         int tiles_y, void* counts, void* slot_starts, void* totals,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(totals, 0, 3 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  bin_count_kernel<<<blocks_for(n > 0 ? n : 1), THREADS, 0, st>>>(
      inputs(center2d, cstride, rx, ry, valid, conics, n, tiles_x, tiles_y), (int*)counts,
      (int*)slot_starts, (unsigned long long*)totals);
  return (int)cudaGetLastError();
}

// The inputs of bin_count, depth [N] f32 and slot_starts [N+1] i32 (the
// exclusive scan of its counts). Writes keys [live] i64, pair_sid [live]
// i32 and, unless null, slot_tile's first live entries.
extern "C" int bin_emit(const void* center2d, int cstride, const void* rx, const void* ry,
                        const void* valid, const void* conics, int n, int tiles_x,
                        int tiles_y, const void* depth, const void* slot_starts, void* keys,
                        void* pair_sid, void* slot_tile, void* stream) {
  if (n == 0) return 0;
  bin_emit_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      inputs(center2d, cstride, rx, ry, valid, conics, n, tiles_x, tiles_y),
      (const float*)depth, (const int*)slot_starts, (long long*)keys, (int*)pair_sid,
      (int*)slot_tile);
  return (int)cudaGetLastError();
}

// sorted_keys [live] i64 and perm [live] i64 (torch.sort of bin_emit's
// keys, stable), pair_sid [live] i32, totals from bin_count. Writes
// entry_ids [rect] i32, tile_ranges [n_tiles, 2] i32 and, unless null,
// inv_slots [rect] i32 and slot_tile's dead tail [live, rect).
extern "C" int bin_finish(const void* sorted_keys, const void* perm, const void* pair_sid,
                          const void* totals, long long n_live, long long n_rect, int n,
                          int n_tiles, void* entry_ids, void* tile_ranges, void* inv_slots,
                          void* slot_tile, void* stream) {
  const long long threads = n_rect > n_live + 1 ? n_rect : n_live + 1;
  bin_finish_kernel<<<blocks_for(threads), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)sorted_keys, (const long long*)perm, (const int*)pair_sid,
      (const unsigned long long*)totals, n_live, n_rect, n, n_tiles, (int*)entry_ids,
      (int*)tile_ranges, (int*)inv_slots, (int*)slot_tile);
  return (int)cudaGetLastError();
}
