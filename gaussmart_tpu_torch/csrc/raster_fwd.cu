// raster_fwd: forward tile compositor of the 2DGS surfel rasterizer.
//
// Replaces the TPU kernel gaussmart_tpu/render/raster_pallas.py
// ::_make_fwd_kernel, launched in _core_fwd_impl: with_init=False (K1,
// entry point raster_fwd) and with_init=True (K3, entry point
// raster_fwd_seeded, the seeded compositor of Gaussian-sharded rendering
// and training, reached from _raster_core_seeded / _seeded_fwd). It
// computes that kernel's semantics, not its TPU layout: the 4-stream
// (8,128) sub-tile packing, 32-px groups, 128-lane row padding, K=64 DMA
// chunks with filler entries and the load-balancing tile order are gone.
//
// K3 is K1 with the walk started from a per-pixel seed (T0, M1_0, M2_0)
// instead of (1, 0, 0): a depth-contiguous stratum of a larger splat set
// then composites exactly against the global incoming transmittance and
// distortion moments. The seed is read once per pixel into registers; a
// seed T0 = 0 (a stratum past a termination) ends the pixel at its first
// considered entry with mt = 0, as the TPU kernel does.
//
// Shape: two blocks per 16x16 tile, each 8 rows of it, one thread per
// pixel (128 threads, 4 warps): a block holds its SM slot until its
// slowest warp is done, so a half tile frees it sooner than a whole one.
// A warp holds a 4x8 block of pixels (4 rows, 8 columns; the tile's warp
// w at rows 4 (w / 2), columns 8 (w % 2)): compact, so its pixels end at
// similar depths and fewer splats reach it than a 2x16 strip. Each pixel
// walks its tile's depth-sorted entries (splat ids into the [N+1, 20]
// blob, see render/raster_tiled.py::build_blob) front to back.
//
// What bounds it on the card: instruction issue. Every (entry, pixel)
// pair costs about 50 float32 operations of ray-splat geometry before the
// alpha test (an IEEE division and expf among them) and about 39 of
// blending where it contributes, each its own instruction under
// -fmad=false; the bytes are one 80-byte blob row per entry and 64 bytes
// of output per pixel. What the design does about it:
// - Batches. The walk goes through batches of BATCH entries. Batch k+1's
//   blob rows (and conic rows) are gathered into a second shared buffer
//   with 16-byte cp.async while batch k is walked, each copying thread
//   holding the entry id it copies one batch ahead in a register, so no
//   walk waits on a global load. One barrier per batch, a
//   __syncthreads_count of the finished pixels: the block leaves within
//   one batch of its last live pixel. A warp takes the batch's entries
//   32 at a time, one ballot each (below).
// - float4 rows. A staged row is read as five 16-byte broadcasts, not 20
//   scalar loads.
// - The band cull. Before a warp walks 32 entries of a batch, lane l
//   tests the l-th against the warp's 4x8 block of pixels (shifted as the
//   walk shifts each pixel) with the binning's conservative interval test
//   (raster_tiled.py::_x_extent: the c_cut-level conic and the filter
//   disc, the JAX package's margins, over the block's 4 rows instead of a
//   tile row's 16) on per-splat terms precomputed in the conic rows
//   (raster_tiled.py::build_conics); a ballot gives the entries the warp
//   walks. A culled entry fails the alpha test at all 32 pixels of the
//   warp, so skipping it changes no output.
//
// Rounding: compiled with -fmad=false and using expf and IEEE division, so
// each operation rounds as in composite_tiles_plain, which runs the same
// expressions in the same order one PyTorch op at a time: the outputs are
// equal to the bit.
//
// Outputs, image layout [C, H_pad, W_pad]:
//   fb   float32, 14 channels: C0 C1 C2 D A N0 N1 N2 med dist T M1 M2 mt
//   ints int32, 2 channels: n_contrib (last contributor + 1, relative to
//        the tile's list) and med_e (index of the median entry, -1 if none)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int BLOCK_ROWS = 8;                 // pixel rows of a tile per block
constexpr int PARTS = TILE / BLOCK_ROWS;        // blocks per tile
constexpr int THREADS = BLOCK_ROWS * TILE;
constexpr int F = 20;          // blob columns
constexpr int FC = 8;          // conic columns: A B ccx ccy D4 dx_m dy_r rd2
constexpr int CH = 14;         // float output channels
constexpr int WARP_ROWS = 4;   // a warp's pixels: 4 rows x 8 columns
constexpr int WARP_COLS = 8;
static_assert(WARP_ROWS * WARP_COLS == 32 && TILE % WARP_COLS == 0, "warp shape");
constexpr int BATCH = 64;      // entries per staged batch (a little faster than 32, PERF.md)
// resident blocks per SM the registers must allow: 32 warps (at most 64
// registers)
constexpr int MIN_BLOCKS = 32 / (THREADS / 32);
constexpr int PIECES = (F + FC) / 4;       // 16-byte copies per entry
constexpr int TPE = THREADS / BATCH;       // threads copying one entry
constexpr int COPIES = (PIECES + TPE - 1) / TPE;   // copies per thread
constexpr int WORDS = (BATCH + 31) / 32;   // ballot words per batch
static_assert(F % 4 == 0 && FC % 4 == 0, "rows of whole 16-byte pieces");
static_assert(THREADS % BATCH == 0, "whole threads per entry");
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_EPS = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float MAPPED_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)
constexpr float BIGX = 1e9f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Whether the entry (blob row r, conic row c) can pass the alpha test at
// a pixel of a warp's block: rows y0 .. y0 + WARP_ROWS - 1 and columns
// [x0, x0 + WARP_COLS), each shifted by the row's means2d shift as the
// walk shifts it. The same expressions as raster_tiled.py::_x_extent over
// the block's rows (the binning takes a tile row's 16) on the splat's
// _conic_terms (its conic row c), and the binning's column test over the
// block's columns.
__device__ __forceinline__ bool band_hit(const float* r, const float* c, float x0,
                                         float y0) {
  const float4 c0 = reinterpret_cast<const float4*>(c)[0];
  const float4 c1 = reinterpret_cast<const float4*>(c)[1];
  const float eA = c0.x, eB = c0.y, ccx = c0.z, ccy = c0.w;
  const float D4 = c1.x, dx_m = c1.y, dy_r = c1.z, rd2 = c1.w;
  if (!(eA > 0.0f)) return true;   // no usable ellipse: keep
  const float scx = r[9], scy = r[10];
  const float xl = x0 - r[11];
  const float b0 = y0 - r[12];
  const float b1 = b0 + (float)(WARP_ROWS - 1);
  const float d0 = b0 - ccy;
  const float d1 = b1 - ccy;
  const float dy_rc = fminf(fmaxf(dy_r, d0), d1);
  const float dy_lc = fminf(fmaxf(-dy_r, d0), d1);
  const float disc_r = 4.0f * eA - D4 * dy_rc * dy_rc;
  const float disc_l = 4.0f * eA - D4 * dy_lc * dy_lc;
  const float dy_near = fminf(fmaxf(0.0f, d0), d1);
  const bool e_hit = D4 * dy_near * dy_near <= 4.0f * eA * 1.02f + 1e-6f;
  const float xhi_e = ccx + (-eB * dy_rc + sqrtf(fmaxf(disc_r, 0.0f))) / (2.0f * eA);
  const float xlo_e = ccx + (-eB * dy_lc - sqrtf(fmaxf(disc_l, 0.0f))) / (2.0f * eA);
  const float err_e = 2e-2f * (dx_m + fabsf(dy_rc) + fabsf(dy_lc)) + 0.51f;
  const float dmin_d = fmaxf(fmaxf(b0 - scy, scy - b1), 0.0f);
  const bool d_hit = dmin_d * dmin_d <= rd2 * (1.0f + 1e-5f) + 1e-5f;
  const float hw = sqrtf(fmaxf(rd2 - dmin_d * dmin_d, 0.0f)) + 0.51f;
  const float xlo = fminf(e_hit ? xlo_e - err_e : BIGX, d_hit ? scx - hw : BIGX);
  const float xhi = fmaxf(e_hit ? xhi_e + err_e : -BIGX, d_hit ? scx + hw : -BIGX);
  return xlo < xl + (float)WARP_COLS && xhi >= xl;
}

template <bool SEEDED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
raster_fwd_kernel(const float* __restrict__ blob,
                  const float* __restrict__ conics,
                  const int* __restrict__ entry_ids,
                  const int* __restrict__ tile_ranges,
                  const float* __restrict__ init,
                  int tiles_x, int h_pad, int w_pad,
                  float* __restrict__ fb, int* __restrict__ ints) {
  __shared__ __align__(16) float rows[2][BATCH * F];
  __shared__ __align__(16) float cons[2][BATCH * FC];

  const int tile = blockIdx.x / PARTS;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = (blockIdx.x % PARTS) * (THREADS / 32) + tid / 32;   // in the tile
  // this warp's block of pixels, and this thread's pixel in it
  const int x0 = (tile % tiles_x) * TILE + (warp % (TILE / WARP_COLS)) * WARP_COLS;
  const int y0 = (tile / tiles_x) * TILE + (warp / (TILE / WARP_COLS)) * WARP_ROWS;
  const int x = x0 + lane % WARP_COLS;
  const int y = y0 + lane / WARP_COLS;
  const float px = (float)x;
  const float py = (float)y;
  const int start = tile_ranges[2 * tile];
  const int count = tile_ranges[2 * tile + 1] - start;
  const size_t plane = (size_t)h_pad * w_pad;
  const size_t p = (size_t)y * w_pad + x;

  float T = 1.0f, M1 = 0.0f, M2 = 0.0f, mt = 2.0f;
  if (SEEDED) {
    T = init[p];
    M1 = init[plane + p];
    M2 = init[2 * plane + p];
  }
  float C0 = 0.0f, C1 = 0.0f, C2 = 0.0f, D = 0.0f, A = 0.0f;
  float N0 = 0.0f, N1 = 0.0f, N2 = 0.0f, med = 0.0f, dist = 0.0f;
  int n_contrib = 0, med_e = -1;
  bool done = false;

  // thread t copies entry t / TPE of each batch: its 16-byte pieces
  // t % TPE + k TPE (pieces 0-4 of the blob row, 5-6 of the conic row)
  const int n_batches = (count + BATCH - 1) / BATCH;
  const int copy_e = tid / TPE;
  auto entry_id = [&](int b) {
    const int e = b * BATCH + copy_e;
    return (b < n_batches && e < count) ? entry_ids[start + e] : -1;
  };
  auto stage = [&](int buf, int id) {
    if (id >= 0) {
#pragma unroll
      for (int k = 0; k < COPIES; ++k) {
        const int c = tid % TPE + k * TPE;
        if (c < F / 4)
          cp_async16(&rows[buf][copy_e * F + 4 * c], blob + (size_t)id * F + 4 * c);
        else if (c < PIECES)
          cp_async16(&cons[buf][copy_e * FC + 4 * c - F], conics + (size_t)id * FC + 4 * c - F);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0, entry_id(0));
  int next_id = entry_id(1);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int b = 0; b < n_batches; ++b) {
    const int buf = b & 1;
    // every thread is past the walk of batch b-1, whose buffer this is
    if (b + 1 < n_batches) {
      stage(buf ^ 1, next_id);
      next_id = entry_id(b + 2);
    }
    const int lo = b * BATCH;
    const int n = min(BATCH, count - lo);
    if (__any_sync(FULL, !done)) {
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        // the entries of the batch's w-th 32 that can reach this warp's block
        const int lane_e = w * 32 + lane;
        const bool hit = lane_e < n && band_hit(rows[buf] + lane_e * F,
                                                cons[buf] + lane_e * FC, (float)x0,
                                                (float)y0);
        unsigned m = __ballot_sync(FULL, hit);
        while (m != 0u && !done) {
          const int e = w * 32 + __ffs(m) - 1;
          m &= m - 1u;
          const float4* r4 = reinterpret_cast<const float4*>(rows[buf] + e * F);
          const float4 q0 = r4[0], q1 = r4[1], q2 = r4[2], q3 = r4[3];
          const float b0 = q0.x, b1 = q0.y, b2 = q0.z, b3 = q0.w, b4 = q1.x;
          const float b5 = q1.y, b6 = q1.z, b7 = q1.w, b8 = q2.x;
          // ray-splat intersection in the splat's (u, v) frame
          const float pxe = px - q2.w;
          const float pye = py - q3.x;
          const float kx = pxe * b2 - b0;
          const float ky = pxe * b5 - b3;
          const float kz = pxe * b8 - b6;
          const float lx = pye * b2 - b1;
          const float ly = pye * b5 - b4;
          const float lz = pye * b8 - b7;
          const float p_x = ky * lz - kz * ly;
          const float p_y = kz * lx - kx * lz;
          const float p_z = kx * ly - ky * lx;
          const bool degenerate = fabsf(p_z) < 1e-12f;
          const float inv_pz = degenerate ? 0.0f : 1.0f / p_z;
          const float su = p_x * inv_pz;
          const float sv = p_y * inv_pz;
          const float rho3d = degenerate ? INFINITY : su * su + sv * sv;
          const float depth3d = su * b2 + sv * b5 + b8;
          // screen-space low-pass around the projected centre
          const float dx = q2.y - pxe;
          const float dy = q2.z - pye;
          const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
          const float rho = fminf(rho3d, rho2d);
          const float depth = rho3d <= rho2d ? depth3d : b8;
          const float alpha = fminf(q3.y * expf(-0.5f * rho), ALPHA_MAX);
          if (!(alpha >= ALPHA_EPS && depth >= NEAR_PLANE)) continue;

          const float test_T = T * (1.0f - alpha);
          mt = fminf(mt, test_T);
          if (test_T < T_EPS) {   // early termination: this entry is excluded
            done = true;
            break;
          }
          const int e_rel = lo + e;
          const float w_ = alpha * T;
          const float m_ = MAPPED_SCALE * (1.0f - (1.0f / depth) * NEAR_PLANE);
          const float A_before = 1.0f - T;
          dist = dist + (m_ * m_ * A_before + M2 - 2.0f * m_ * M1) * w_;
          M1 = M1 + m_ * w_;
          M2 = M2 + m_ * m_ * w_;
          if (T > 0.5f) {
            med = depth;
            med_e = e_rel;
          }
          const float4 q4 = r4[4];
          C0 = C0 + w_ * q3.z;
          C1 = C1 + w_ * q3.w;
          C2 = C2 + w_ * q4.x;
          N0 = N0 + w_ * q4.y;
          N1 = N1 + w_ * q4.z;
          N2 = N2 + w_ * q4.w;
          D = D + w_ * depth;
          A = A + w_;
          T = test_T;
          n_contrib = e_rel + 1;
        }
      }
    }
    // batch b+1 has landed, and batch b's buffer is free for batch b+2
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (__syncthreads_count(done) == THREADS) break;
  }

  const float out[CH] = {C0, C1, C2, D, A, N0, N1, N2, med, dist, T, M1, M2, mt};
#pragma unroll
  for (int c = 0; c < CH; ++c) fb[c * plane + p] = out[c];
  ints[p] = n_contrib;
  ints[plane + p] = med_e;
}

template <bool SEEDED>
int launch(const void* blob, const void* conics, const void* entry_ids,
           const void* tile_ranges, const void* init, int tiles_x, int tiles_y,
           void* fb, void* ints, void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles > 0) {
    raster_fwd_kernel<SEEDED><<<n_tiles * PARTS, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)blob, (const float*)conics, (const int*)entry_ids,
        (const int*)tile_ranges, (const float*)init, tiles_x, tiles_y * TILE,
        tiles_x * TILE, (float*)fb, (int*)ints);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// blob [N+1, 20] f32 and conics [N+1, 8] f32 (both 16-byte aligned; see
// render/raster_tiled.py::build_blob and build_conics), entry_ids [M] i32,
// tile_ranges [tiles_x*tiles_y, 2] i32 (start, end) into entry_ids;
// fb [14, h_pad, w_pad] f32 and ints [2, h_pad, w_pad] i32 with
// h_pad = 16*tiles_y, w_pad = 16*tiles_x.
extern "C" int raster_fwd(const void* blob, const void* conics, const void* entry_ids,
                          const void* tile_ranges, int tiles_x, int tiles_y,
                          void* fb, void* ints, void* stream) {
  return launch<false>(blob, conics, entry_ids, tile_ranges, nullptr, tiles_x,
                       tiles_y, fb, ints, stream);
}

// As raster_fwd, from the seed init [3, h_pad, w_pad] f32 (T0, M1_0, M2_0).
extern "C" int raster_fwd_seeded(const void* blob, const void* conics,
                                 const void* entry_ids, const void* tile_ranges,
                                 const void* init, int tiles_x, int tiles_y, void* fb,
                                 void* ints, void* stream) {
  return launch<true>(blob, conics, entry_ids, tile_ranges, init, tiles_x, tiles_y,
                      fb, ints, stream);
}
