// raster_bwd: backward tile compositor of the 2DGS surfel rasterizer.
//
// Replaces the TPU kernel gaussmart_tpu/render/raster_pallas.py
// ::_make_bwd_kernel, with the per-entry geometry VJP of _geom_fwd_res /
// _geom_manual_bwd: with_init=False (K2, entry point raster_bwd, launched
// in _core_bwd) and with_init=True (K4, entry point raster_bwd_seeded,
// launched in _seeded_bwd: the backward of raster_fwd_seeded for
// Gaussian-sharded training). It computes that kernel's semantics, not its
// TPU layout: the 4-stream (8,128) packing, K=64 DMA chunks, F_PAD=128
// rows and the id lane are gone.
//
// Shape: one block per 16x16 tile, one thread per pixel (256 threads, 8
// warps of two pixel rows each). Each pixel walks its tile's entries back
// to front from the forward's final state (raster_fwd.cu):
//   T_before = T_cur / (1 - alpha) through one reciprocal, T_cur starting
//   at the forward's final T; the suffix S = sum over later entries of
//   w * dL/dw; TdT = T_final * dT hoisted out of the walk; an entry counts
//   where contrib = e < n_contrib && alpha > 0; the median term where
//   e == med_e (NEED_MED) and the distortion terms (NEED_DIST) are
//   compiled in only when the loss reads those channels.
// Each pixel's 20 per-field cotangents (T 3x3, centre, shift, opacity,
// colour, normal) are summed over the tile's 256 pixels into ONE row per
// (splat, tile) entry of rows [M', 20]: no atomics, deterministic. Rows of
// entries past the tile's walk bound stay as the wrapper zero-filled them.
// The per-splat reduction is a separate pass
// (render/raster_tiled.py::grad_reduce), as in the JAX package.
//
// What bounds it on the card: operations. Every (walked entry, pixel) pair
// costs about 50 float32 operations of forward geometry and about 110 of
// cotangents; the bytes are one 80-byte blob row read and one 80-byte
// gradient row written per walked entry, plus 14+2+11 planes read per
// pixel. What the design does about it:
// - Batches. The walk goes through batches of BATCH entries. Batch k-1's
//   blob rows are gathered into a second shared buffer with cp.async while
//   batch k is walked, each thread holding the entry id it copies one
//   batch ahead in a register, so no walk waits on a global load.
// - Warp partials, one barrier pair per batch. For each entry a warp sums
//   its 32 pixels' 20 fields by a reduce-scatter across lanes (warp_sum:
//   21 shuffles, lane l ends with the warp's sum of slot l) and stores
//   them in shared memory, partial[entry][warp][field]. After the batch
//   one barrier lets the block add the 8 warp partials in warp order and
//   write the batch's rows as contiguous floats.
// - Per-warp bounds. A warp evaluates an entry only below the largest
//   n_contrib of its own 32 pixels (entries past it contribute to none of
//   them: T and S do not change), and skips the sum of an entry that none
//   of its pixels takes (every field is 0). Its partial is then 0.
//
// K4 (SEEDED) differs in four places, derived in the TPU kernel's
// docstring from the seeded distortion written as the in-stratum pairwise
// sum plus the upstream cross term: the raw M1/M2 outputs carry cotangents
// (dM1, dM2: ct has 13 channels), adding m dM1 + m^2 dM2 to dL/dw and
// (dM1 + 2 m dM2) w dm/dd to dL/dd, so m is computed even without the
// distortion term; A_n becomes A_n + (1 - T0) in the distortion terms; and
// after the walk each pixel writes its seed gradient gi:
//   gT0 = (S_end + T_final dT) / max(T0, 1e-12) - dDist (M2_n - M2_0)
//   gM1 = dM1 - 2 dDist (M1_n - M1_0),   gM2 = dM2 + dDist A_n
// (the dDist terms only with NEED_DIST). The seed is read per pixel before
// the walk (for A_n + 1 - T0) and after it. T0 = 0 (a stratum past a
// termination) gives S_end = T_final = 0, so gT0 = 0 there. The mapped
// depth m and its derivative share one reciprocal of the depth.
//
// Rounding: compiled with -fmad=false, expf and IEEE division, with every
// per-pixel expression in composite_tiles_bwd_plain's order, so the
// per-pixel values round as the plain version's do; only the order of the
// 256-pixel sums differs, and it is fixed, so two launches on the same
// inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int WARPS = THREADS / 32;
constexpr int F = 20;          // blob / gradient-row columns
constexpr int CHUNKS = F / 4;  // 16-byte pieces of a row
constexpr int BATCH = 32;      // entries per staged batch
// resident blocks per SM the registers must allow: 3 (at most 80
// registers), 2 for the seeded variants with the distortion terms, which
// spill at 80
constexpr int MIN_BLOCKS = 3;
constexpr int MIN_BLOCKS_SEEDED_DIST = 2;
// partial[] stride per entry: WARPS * F floats, padded to 20 mod 32 so the
// batch's final sum (consecutive threads on consecutive (entry, field))
// reads 32 distinct banks
constexpr int PSTRIDE = 180;
static_assert(PSTRIDE >= WARPS * F && PSTRIDE % 32 == F, "partial stride");
static_assert(BATCH * CHUNKS <= THREADS, "one 16-byte copy per thread per batch");
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_EPS = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float NEAR_PLANE = 0.2f;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float MAPPED_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)
constexpr float FARNEAR = (float)((100.0 * 0.2) / (100.0 - 0.2));

// warp_sum's slots: the 20 fields sit in 32 slots, 5 in each 8 (slot % 8
// in {0, 1, 2, 4, 5}), so every halving step of the reduce-scatter moves
// as many real values from each half: 10 + 5 + 3 + 2 + 1 shuffles.
__host__ __device__ constexpr bool slot_real(int s) { return (s & 7) != 3 && (s & 7) < 6; }
__host__ __device__ constexpr int slot_of(int f) { return 8 * (f / 5) + f % 5 + (f % 5 >= 3); }
__host__ __device__ constexpr int field_of(int s) { return 5 * (s / 8) + (s & 7) - ((s & 7) >= 4); }
// bit j: whether pair j of the halving step over sets of 2H slots holds a
// real slot on some lane (a set starts at a multiple of 2H)
__host__ __device__ constexpr unsigned real_pairs(int H) {
  unsigned mask = 0;
  for (int j = 0; j < H; ++j)
    for (int s0 = 0; s0 < 32; s0 += 2 * H)
      if (slot_real(s0 + j) || slot_real(s0 + j + H)) mask |= 1u << j;
  return mask;
}

// One halving step: lanes with bit H keep the upper half of their slots
// and add their partner's copy (lane ^ H) of it.
template <int H>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  constexpr unsigned PAIRS = real_pairs(H);
  const bool upper = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if (!((PAIRS >> j) & 1u)) continue;
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// Reduce-scatter of 32 slots across the warp: returns the warp's sum of
// slot `lane` (0 for pad slots). The order of additions is fixed.
__device__ __forceinline__ float warp_sum(float (&v)[32], int lane) {
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
  return v[0];
}
static_assert(real_pairs(16) == 0x3737u && real_pairs(1) == 1u, "slot layout");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

template <bool NEED_DIST, bool NEED_MED, bool SEEDED>
__global__ void __launch_bounds__(THREADS, NEED_DIST && SEEDED ? MIN_BLOCKS_SEEDED_DIST
                                                                : MIN_BLOCKS)
raster_bwd_kernel(const float* __restrict__ blob,
                  const int* __restrict__ entry_ids,
                  const int* __restrict__ tile_ranges,
                  const float* __restrict__ fb, const int* __restrict__ ints,
                  const float* __restrict__ ct, const float* __restrict__ init,
                  int tiles_x, int h_pad, int w_pad, float* __restrict__ rows_out,
                  float* __restrict__ gi) {
  __shared__ __align__(16) float rows[2][BATCH * F];
  __shared__ float partial[BATCH * PSTRIDE];
  __shared__ int s_bound[WARPS];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int x = (tile % tiles_x) * TILE + tid % TILE;
  const int y = (tile / tiles_x) * TILE + tid / TILE;
  const float px = (float)x;
  const float py = (float)y;
  const int start = tile_ranges[2 * tile];
  const int count = tile_ranges[2 * tile + 1] - start;

  const size_t plane = (size_t)h_pad * w_pad;
  const size_t p = (size_t)y * w_pad + x;
  const float T_final = fb[10 * plane + p];
  const float M1_n = fb[11 * plane + p];
  const float M2_n = fb[12 * plane + p];
  const int n_contrib = ints[p];
  const int med_e = ints[plane + p];
  const float dC0 = ct[0 * plane + p], dC1 = ct[1 * plane + p], dC2 = ct[2 * plane + p];
  const float dD = ct[3 * plane + p], dA = ct[4 * plane + p];
  const float dN0 = ct[5 * plane + p], dN1 = ct[6 * plane + p], dN2 = ct[7 * plane + p];
  const float dMed = ct[8 * plane + p], dDist = ct[9 * plane + p];
  const float dT = ct[10 * plane + p];
  float dM1 = 0.0f, dM2 = 0.0f;
  if (SEEDED) {
    dM1 = ct[11 * plane + p];
    dM2 = ct[12 * plane + p];
  }
  // in-stratum alpha plus the upstream alpha 1 - T0 (A_n and the seed are
  // read again after the walk rather than held through it)
  const float A_eff = SEEDED ? fb[4 * plane + p] + (1.0f - init[p]) : fb[4 * plane + p];

  // walk bounds: this warp's largest n_contrib, and the block's (no
  // pixel of the tile takes an entry past it), clipped to the tile's list
  const int warp_bound = min(__reduce_max_sync(FULL, n_contrib), count);
  if (lane == 0) s_bound[warp] = warp_bound;
  __syncthreads();
  int bound = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) bound = max(bound, s_bound[k]);

  // thread t < BATCH * CHUNKS copies 16 bytes (piece t % CHUNKS of entry
  // t / CHUNKS) of each batch; batch b covers entries [b BATCH, min((b+1)
  // BATCH, bound)) and is walked in order nb-1 .. 0
  const int n_batches = (bound + BATCH - 1) / BATCH;
  const int copy_e = tid / CHUNKS;
  const int copy_c = tid % CHUNKS;
  auto entry_id = [&](int b) {
    const int e = b * BATCH + copy_e;
    return (b >= 0 && tid < BATCH * CHUNKS && e < bound) ? entry_ids[start + e] : -1;
  };
  auto stage = [&](int buf, int id) {
    if (id >= 0)
      cp_async16(&rows[buf][copy_e * F + copy_c * 4], blob + (size_t)id * F + copy_c * 4);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (n_batches > 0) stage(0, entry_id(n_batches - 1));
  int next_id = entry_id(n_batches - 2);

  float T_cur = T_final;
  float S = 0.0f;
  const float TdT = T_final * dT;

  for (int b = n_batches - 1; b >= 0; --b) {
    const int buf = (n_batches - 1 - b) & 1;
    const int lo = b * BATCH;
    const int hi = min(lo + BATCH, bound);
    // batch b's rows have landed, and every thread is past the walk of
    // batch b+1 and the sum of its partials
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (b > 0) {
      stage(buf ^ 1, next_id);
      next_id = entry_id(b - 2);
    }

    // entries of the batch past this warp's bound: no pixel of it takes them
    const int top = max(min(hi, warp_bound), lo);
    for (int e = hi - 1; e >= top; --e)
      if (lane < F) partial[(e - lo) * PSTRIDE + warp * F + lane] = 0.0f;

    for (int e = top - 1; e >= lo; --e) {
      const float* r = rows[buf] + (e - lo) * F;
      const float b0 = r[0], b1 = r[1], b2 = r[2], b3 = r[3], b4 = r[4];
      const float b5 = r[5], b6 = r[6], b7 = r[7], b8 = r[8];
      const float opacity = r[13];
      // forward geometry (raster_fwd.cu's expressions)
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
      const float u = p_x * inv_pz;
      const float v = p_y * inv_pz;
      const float rho3d = degenerate ? INFINITY : u * u + v * v;
      const float depth3d = u * b2 + v * b5 + b8;
      const float dxc = r[9] - pxe;
      const float dyc = r[10] - pye;
      const float rho2d = FILTER_INV_SQUARE * (dxc * dxc + dyc * dyc);
      const bool use3d = rho3d <= rho2d;
      const float depth = use3d ? depth3d : b8;
      const float g = expf(-0.5f * fminf(rho3d, rho2d));
      const float a_raw = opacity * g;
      const float alpha_cl = fminf(a_raw, ALPHA_MAX);
      const bool ok = alpha_cl >= ALPHA_EPS && depth >= NEAR_PLANE;
      const float live = (ok && a_raw < ALPHA_MAX) ? 1.0f : 0.0f;
      const float alpha = ok ? alpha_cl : 0.0f;

      const bool contrib = e < n_contrib && alpha > 0.0f;
      const bool is_med = med_e == e;
      const bool grad_any = NEED_MED ? (contrib || is_med) : contrib;
      // no pixel of the warp takes this entry: T and S are unchanged and
      // every field is 0
      if (!__any_sync(FULL, grad_any)) {
        if (lane < F) partial[(e - lo) * PSTRIDE + warp * F + lane] = 0.0f;
        continue;
      }

      // reverse compositing step
      const float alpha_c = contrib ? alpha : 0.0f;
      const float inv_oma = 1.0f / (1.0f - alpha_c);
      const float T_before = T_cur * inv_oma;
      const float w = contrib ? alpha_c * T_before : 0.0f;
      const float dsafe = contrib ? depth : 1.0f;
      float dLdw = r[14] * dC0 + r[15] * dC1 + r[16] * dC2 + depth * dD + dA
                   + r[17] * dN0 + r[18] * dN1 + r[19] * dN2;
      float m = 0.0f, dm_dd = 0.0f;
      if (NEED_DIST || SEEDED) {
        const float inv_d = 1.0f / dsafe;
        m = contrib ? MAPPED_SCALE * (1.0f - inv_d * NEAR_PLANE) : 0.0f;
        dm_dd = (inv_d * inv_d) * FARNEAR;
      }
      if (NEED_DIST) dLdw = dLdw + (m * m * A_eff + M2_n - 2.0f * m * M1_n) * dDist;
      if (SEEDED) dLdw = dLdw + m * dM1 + m * m * dM2;
      const float dLdalpha = contrib ? T_before * dLdw - (S + TdT) * inv_oma : 0.0f;
      float dLdd = w * dD;
      if (NEED_DIST) dLdd = dLdd + dDist * 2.0f * w * (m * A_eff - M1_n) * dm_dd;
      if (SEEDED) dLdd = dLdd + (dM1 + 2.0f * m * dM2) * w * dm_dd;
      if (NEED_MED) dLdd = dLdd + (is_med ? dMed : 0.0f);
      dLdd = grad_any ? dLdd : 0.0f;

      // cotangents of (alpha, depth) -> geometry (JAX _geom_manual_bwd),
      // the cross-product cotangents kept negated
      const float gop = dLdalpha * g * live;
      const float crho = -0.5f * opacity * gop;
      const float u3 = use3d ? 1.0f : 0.0f;
      const float crho3 = crho * u3;
      const float crho2 = crho - crho3;
      const float cdep3 = dLdd * u3;
      const float cd_b8 = dLdd - cdep3;
      const float f4x = 2.0f * FILTER_INV_SQUARE * dxc * crho2;
      const float f4y = 2.0f * FILTER_INV_SQUARE * dyc * crho2;
      const float cu = 2.0f * u * crho3 + b2 * cdep3;
      const float cv = 2.0f * v * crho3 + b5 * cdep3;
      const float ninv_pz = -inv_pz;
      const float ncpx = cu * ninv_pz;
      const float ncpy = cv * ninv_pz;
      const float ncpz = -(u * ncpx + v * ncpy);
      const float nckx = ly * ncpz - lz * ncpy;
      const float ncky = lz * ncpx - lx * ncpz;
      const float nckz = lx * ncpy - ly * ncpx;
      const float nclx = ncpy * kz - ncpz * ky;
      const float ncly = ncpz * kx - ncpx * kz;
      const float nclz = ncpx * ky - ncpy * kx;

      float field[F];
      field[0] = nckx;
      field[1] = nclx;
      field[2] = u * cdep3 - (pxe * nckx + pye * nclx);
      field[3] = ncky;
      field[4] = ncly;
      field[5] = v * cdep3 - (pxe * ncky + pye * ncly);
      field[6] = nckz;
      field[7] = nclz;
      field[8] = cdep3 + cd_b8 - (pxe * nckz + pye * nclz);
      field[9] = f4x;
      field[10] = f4y;
      field[11] = f4x + (nckx * b2 + ncky * b5 + nckz * b8);
      field[12] = f4y + (nclx * b2 + ncly * b5 + nclz * b8);
      field[13] = gop;
      field[14] = w * dC0;
      field[15] = w * dC1;
      field[16] = w * dC2;
      field[17] = w * dN0;
      field[18] = w * dN1;
      field[19] = w * dN2;

      S = S + (contrib ? w * dLdw : 0.0f);
      T_cur = T_before;

      // the warp's sum of each field, lane l holding slot l's
      float slots[32];
#pragma unroll
      for (int s = 0; s < 32; ++s) slots[s] = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) slots[slot_of(f)] = field[f];
      const float sum = warp_sum(slots, lane);
      if (slot_real(lane)) partial[(e - lo) * PSTRIDE + warp * F + field_of(lane)] = sum;
    }

    // the batch's rows: the 8 warp partials added in warp order
    __syncthreads();
    for (int q = tid; q < (hi - lo) * F; q += THREADS) {
      const float* pp = partial + (q / F) * PSTRIDE + q % F;
      float s = pp[0];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) s = s + pp[k * F];
      rows_out[(size_t)(start + lo) * F + q] = s;
    }
  }

  if (SEEDED) {
    float gT0 = (S + TdT) / fmaxf(init[p], 1e-12f);
    float gM1 = dM1, gM2 = dM2;
    if (NEED_DIST) {
      gT0 = gT0 - dDist * (M2_n - init[2 * plane + p]);
      gM1 = gM1 - 2.0f * dDist * (M1_n - init[plane + p]);
      gM2 = gM2 + dDist * fb[4 * plane + p];
    }
    gi[p] = gT0;
    gi[plane + p] = gM1;
    gi[2 * plane + p] = gM2;
  }
}

template <bool NEED_DIST, bool NEED_MED, bool SEEDED>
void launch(const void* blob, const void* entry_ids, const void* tile_ranges,
            const void* fb, const void* ints, const void* ct, const void* init,
            int tiles_x, int tiles_y, void* rows, void* gi, cudaStream_t stream) {
  raster_bwd_kernel<NEED_DIST, NEED_MED, SEEDED>
      <<<tiles_x * tiles_y, THREADS, 0, stream>>>(
          (const float*)blob, (const int*)entry_ids, (const int*)tile_ranges,
          (const float*)fb, (const int*)ints, (const float*)ct, (const float*)init,
          tiles_x, tiles_y * TILE, tiles_x * TILE, (float*)rows, (float*)gi);
}

template <bool SEEDED>
int dispatch(const void* blob, const void* entry_ids, const void* tile_ranges,
             const void* fb, const void* ints, const void* ct, const void* init,
             int tiles_x, int tiles_y, int need_dist, int need_med, void* rows,
             void* gi, void* stream) {
  if (tiles_x * tiles_y > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (need_dist && need_med)
      launch<true, true, SEEDED>(blob, entry_ids, tile_ranges, fb, ints, ct, init,
                                 tiles_x, tiles_y, rows, gi, s);
    else if (need_dist)
      launch<true, false, SEEDED>(blob, entry_ids, tile_ranges, fb, ints, ct, init,
                                  tiles_x, tiles_y, rows, gi, s);
    else if (need_med)
      launch<false, true, SEEDED>(blob, entry_ids, tile_ranges, fb, ints, ct, init,
                                  tiles_x, tiles_y, rows, gi, s);
    else
      launch<false, false, SEEDED>(blob, entry_ids, tile_ranges, fb, ints, ct, init,
                                   tiles_x, tiles_y, rows, gi, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// blob [N+1, 20] f32 (16-byte aligned), entry_ids [M'] i32, tile_ranges
// [tiles, 2] i32 as for raster_fwd; fb [14, h_pad, w_pad] f32 and ints [2,
// h_pad, w_pad] i32 from raster_fwd; ct [11, h_pad, w_pad] f32, the
// cotangents of fb's channels C0..2 D A N0..2 med dist T; rows [M', 20]
// f32, zero-filled by the caller, gets one gradient row per walked entry.
extern "C" int raster_bwd(const void* blob, const void* entry_ids,
                          const void* tile_ranges, const void* fb,
                          const void* ints, const void* ct, int tiles_x,
                          int tiles_y, int need_dist, int need_med, void* rows,
                          void* stream) {
  return dispatch<false>(blob, entry_ids, tile_ranges, fb, ints, ct, nullptr,
                         tiles_x, tiles_y, need_dist, need_med, rows, nullptr,
                         stream);
}

// As raster_bwd for raster_fwd_seeded's outputs: init [3, h_pad, w_pad]
// f32 is the forward's seed (T0, M1_0, M2_0), ct has 13 channels (also the
// raw M1 and M2), and gi [3, h_pad, w_pad] f32 gets the seed's gradient at
// every pixel.
extern "C" int raster_bwd_seeded(const void* blob, const void* entry_ids,
                                 const void* tile_ranges, const void* fb,
                                 const void* ints, const void* ct,
                                 const void* init, int tiles_x, int tiles_y,
                                 int need_dist, int need_med, void* rows, void* gi,
                                 void* stream) {
  return dispatch<true>(blob, entry_ids, tile_ranges, fb, ints, ct, init, tiles_x,
                        tiles_y, need_dist, need_med, rows, gi, stream);
}
