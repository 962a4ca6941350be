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
// Shape: one block per 16x16 tile, one thread per pixel (256 threads).
// The tile's depth-sorted entries (splat ids into the [N+1, 20] blob, see
// render/raster_tiled.py::build_blob) are staged in shared memory in
// batches of 256 rows x 20 floats (20 KB): the block gathers the rows
// coalesced, then every pixel walks the batch front to back. A pixel that
// terminates stops; the block leaves once all 256 pixels have.
//
// What bounds it on the card: operations. Every (entry, pixel) pair costs
// about 45 float32 operations of ray-splat geometry before the alpha test,
// plus about 35 of blending where it contributes, while the bytes are one
// 80-byte blob row per entry for 256 pixels and 64 bytes of output per
// pixel. The design keeps the walk in registers and the entries in shared
// memory (a broadcast read per entry), so device memory is touched once per
// entry per tile; the open question is how close the plain per-pixel
// arithmetic gets to the float32 peak (PERF.md).
//
// Rounding: compiled with -fmad=false and using expf and IEEE division, so
// each operation rounds as in composite_tiles_plain, which runs the same
// expressions in the same order one PyTorch op at a time.
//
// Outputs, image layout [C, H_pad, W_pad]:
//   fb   float32, 14 channels: C0 C1 C2 D A N0 N1 N2 med dist T M1 M2 mt
//   ints int32, 2 channels: n_contrib (last contributor + 1, relative to
//        the tile's list) and med_e (index of the median entry, -1 if none)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int F = 20;          // blob columns
constexpr int CH = 14;         // float output channels
constexpr float ALPHA_EPS = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float MAPPED_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)

template <bool SEEDED>
__global__ void __launch_bounds__(THREADS)
raster_fwd_kernel(const float* __restrict__ blob,
                  const int* __restrict__ entry_ids,
                  const int* __restrict__ tile_ranges,
                  const float* __restrict__ init,
                  int tiles_x, int h_pad, int w_pad,
                  float* __restrict__ fb, int* __restrict__ ints) {
  __shared__ int ids[THREADS];
  __shared__ float rows[THREADS * F];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int x = (tile % tiles_x) * TILE + tid % TILE;
  const int y = (tile / tiles_x) * TILE + tid / TILE;
  const float px = (float)x;
  const float py = (float)y;
  const int start = tile_ranges[2 * tile];
  const int end = tile_ranges[2 * tile + 1];
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

  for (int base = start; base < end; base += THREADS) {
    const int n = min(THREADS, end - base);
    if (tid < n) ids[tid] = entry_ids[base + tid];
    __syncthreads();
    for (int j = tid; j < n * F; j += THREADS)
      rows[j] = blob[(size_t)ids[j / F] * F + j % F];
    __syncthreads();

    for (int e = 0; e < n && !done; ++e) {
      const float* r = rows + e * F;
      const float b0 = r[0], b1 = r[1], b2 = r[2], b3 = r[3], b4 = r[4];
      const float b5 = r[5], b6 = r[6], b7 = r[7], b8 = r[8];
      // ray-splat intersection in the splat's (u, v) frame
      const float pxe = px - r[11];
      const float pye = py - r[12];
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
      const float dx = r[9] - pxe;
      const float dy = r[10] - pye;
      const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
      const float rho = fminf(rho3d, rho2d);
      const float depth = rho3d <= rho2d ? depth3d : b8;
      const float alpha = fminf(r[13] * expf(-0.5f * rho), ALPHA_MAX);
      if (!(alpha >= ALPHA_EPS && depth >= NEAR_PLANE)) continue;

      const float test_T = T * (1.0f - alpha);
      mt = fminf(mt, test_T);
      if (test_T < T_EPS) {   // early termination: this entry is excluded
        done = true;
        break;
      }
      const int e_rel = base - start + e;
      const float w = alpha * T;
      const float m = MAPPED_SCALE * (1.0f - (1.0f / depth) * NEAR_PLANE);
      const float A_before = 1.0f - T;
      dist = dist + (m * m * A_before + M2 - 2.0f * m * M1) * w;
      M1 = M1 + m * w;
      M2 = M2 + m * m * w;
      if (T > 0.5f) {
        med = depth;
        med_e = e_rel;
      }
      C0 = C0 + w * r[14];
      C1 = C1 + w * r[15];
      C2 = C2 + w * r[16];
      N0 = N0 + w * r[17];
      N1 = N1 + w * r[18];
      N2 = N2 + w * r[19];
      D = D + w * depth;
      A = A + w;
      T = test_T;
      n_contrib = e_rel + 1;
    }
    if (__syncthreads_count(done) == THREADS) break;
  }

  const float out[CH] = {C0, C1, C2, D, A, N0, N1, N2, med, dist, T, M1, M2, mt};
#pragma unroll
  for (int c = 0; c < CH; ++c) fb[c * plane + p] = out[c];
  ints[p] = n_contrib;
  ints[plane + p] = med_e;
}

template <bool SEEDED>
int launch(const void* blob, const void* entry_ids, const void* tile_ranges,
           const void* init, int tiles_x, int tiles_y, void* fb, void* ints,
           void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles > 0) {
    raster_fwd_kernel<SEEDED><<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)blob, (const int*)entry_ids, (const int*)tile_ranges,
        (const float*)init, tiles_x, tiles_y * TILE, tiles_x * TILE, (float*)fb,
        (int*)ints);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// blob [N+1, 20] f32, entry_ids [M] i32, tile_ranges [tiles_x*tiles_y, 2]
// i32 (start, end) into entry_ids; fb [14, h_pad, w_pad] f32 and
// ints [2, h_pad, w_pad] i32 with h_pad = 16*tiles_y, w_pad = 16*tiles_x.
extern "C" int raster_fwd(const void* blob, const void* entry_ids,
                          const void* tile_ranges, int tiles_x, int tiles_y,
                          void* fb, void* ints, void* stream) {
  return launch<false>(blob, entry_ids, tile_ranges, nullptr, tiles_x, tiles_y,
                       fb, ints, stream);
}

// As raster_fwd, from the seed init [3, h_pad, w_pad] f32 (T0, M1_0, M2_0).
extern "C" int raster_fwd_seeded(const void* blob, const void* entry_ids,
                                 const void* tile_ranges, const void* init,
                                 int tiles_x, int tiles_y, void* fb, void* ints,
                                 void* stream) {
  return launch<true>(blob, entry_ids, tile_ranges, init, tiles_x, tiles_y, fb,
                      ints, stream);
}
