// preprocess_grad: the training step's per-splat preprocess as two kernels
// (K8), the forward and the VJP of render/preprocess_grad.py's
// PreprocessCore (a torch.autograd.Function, as RasterCore is for the
// compositor).
//
// Replaces no TPU kernel: on the TPU, XLA fused the chain (the activations
// of the raw parameters, render/raster_common.py::preprocess,
// raster_tiled.build_blob and build_conics) and its autodiff into a few
// loops over the splats. Run eagerly by PyTorch that chain is about 400
// launches forward and 360 in autograd's backward, each reading and
// writing every splat's intermediates through device memory; autograd
// also keeps those intermediates between the passes.
//
// preprocess_grad_fwd is K6's kernel (preprocess.cu) with the blob's shift
// columns means2d * (W/2, H/2), at SH degree min(active_degree, sh_degree):
// the bands above it are never read (the chain multiplies them by zero).
// Its outputs are bit-equal to the chain's.
//
// preprocess_bwd takes the blob's cotangent rows g_blob [N+1, 20] (from
// raster_tiled.grad_reduce) and writes each raw parameter's gradient in
// that parameter's own layout, and means2d's as g_shift * (W/2, H/2) (the
// chain's one multiply: bit-equal). One thread a splat recomputes the
// forward's intermediates in registers from the raw parameters
// (preprocess_splat.cuh::splat_backward); nothing but the parameters and
// `valid` is kept from the forward. A splat not valid, or whose cotangent
// row is zero (not binned, or past every tile's walk), gets zeros. No
// atomics: each splat's gradients are one thread's, so they are
// deterministic. They differ from autograd's through the chain by float32
// rounding (other orders of the same sums); the bands above the degree are
// exact zeros.
//
// What bounds the VJP on the card: memory. A splat reads 233 bytes (its
// parameters at degree 3, valid) and its 80-byte cotangent row, and writes
// 240 bytes of gradients, so 3M splats move 1.66 GB, 0.50 ms at 3.35 TB/s;
// its ~600 float operations a splat (the forward again and the walk back)
// are a fifth of that time. What the design does about it: as in K6, one
// thread a splat, 128 a block; the block's parameter spans and cotangent
// rows are staged into shared memory with 16-byte loads; each thread
// writes its gradients over its own parameters' slots there (no other
// thread reads them), and the block writes each gradient's span back with
// 16-byte stores.

#include <cuda_runtime.h>

#include "preprocess_splat.cuh"

namespace {

using namespace preprocess_splat;

// n_rest * 3 floats a row in global memory, the first `w` of a row at a
// stride of `sd` floats in shared src: `rows` rows back to dst (global),
// the columns past w zero; one span where both strides are w
__device__ __forceinline__ void unstage_rows(float* dst, int sw, const float* src, int sd,
                                             int w, int rows) {
  if (sw == w && sd == w) {
    unstage(dst, src, w * rows);
  } else {
    for (int i = threadIdx.x; i < sw * rows; i += THREADS) {
      const int r = i / sw, c = i % sw;
      dst[(size_t)r * sw + c] = c < w ? src[r * sd + c] : 0.0f;
    }
  }
}

// blocks of the VJP an SM holds at once, by degree: ptxas's register cap
// is 65536 / (BLOCKS * THREADS). These are the occupancies its own choice
// gives (80, 96, 123 and 159 registers at degrees 0, 2, 3 and 4), but at
// degree 1, where it chose 6 blocks and spilled; without any (a cap of
// 255) it takes more registers and runs 17% slower at degree 3 (on an
// H100 at 700 W, 3M splats).
template <int DEG>
struct BwdBlocks {
  static constexpr int N = DEG == 0 ? 6 : DEG <= 2 ? 5 : DEG == 3 ? 4 : 3;
};

template <int DEG>
__global__ void __launch_bounds__(THREADS, BwdBlocks<DEG>::N) preprocess_bwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ scaling,
    const float* __restrict__ rotation, const float* __restrict__ opacity,
    const float* __restrict__ features_dc, const float* __restrict__ features_rest,
    const unsigned char* __restrict__ valid, const float* __restrict__ world_view, int wv_s0,
    int wv_s1, const float* __restrict__ full_proj, int fp_s0, int fp_s1,
    const float* __restrict__ camera_center, const float* __restrict__ g_blob, int n,
    int n_rest, int width, int height, float scale_modifier, float* __restrict__ g_xyz,
    float* __restrict__ g_scaling, float* __restrict__ g_rotation,
    float* __restrict__ g_opacity, float* __restrict__ g_features_dc,
    float* __restrict__ g_features_rest, float* __restrict__ g_means2d) {
  constexpr int REST = Bands<DEG>::REST, SR = Bands<DEG>::SR;
  extern __shared__ float4 smem4[];
  float* s_g = reinterpret_cast<float*>(smem4);   // 16-byte aligned rows
  float* s_xyz = s_g + F * THREADS;
  float* s_scl = s_xyz + 3 * THREADS;
  float* s_rot = s_scl + 2 * THREADS;
  float* s_op = s_rot + 4 * THREADS;
  float* s_dc = s_op + THREADS;
  float* s_m2d = s_dc + 3 * THREADS;
  float* s_rest = s_m2d + 2 * THREADS;
  __shared__ float s_cam[CAM];

  const int t = threadIdx.x;
  const int base = blockIdx.x * THREADS;
  const int rows = max(0, min(THREADS, n - base));

  stage_camera(s_cam, world_view, wv_s0, wv_s1, full_proj, fp_s0, fp_s1, camera_center, width,
               height);
  stage(s_g, g_blob + (size_t)F * base, F * rows);
  stage(s_xyz, xyz + 3 * base, 3 * rows);
  stage(s_scl, scaling + 2 * base, 2 * rows);
  stage(s_rot, rotation + 4 * base, 4 * rows);
  stage(s_op, opacity + base, rows);
  stage(s_dc, features_dc + 3 * base, 3 * rows);
  if (REST > 0)
    stage_rows(s_rest, SR, features_rest + (size_t)3 * n_rest * base, 3 * n_rest, REST, rows);
  __syncthreads();

  const int i = base + t;
  if (i < n) {
    const float* g = s_g + F * t;
    float* px = s_xyz + 3 * t;
    float* ps = s_scl + 2 * t;
    float* pr = s_rot + 4 * t;
    float* pd = s_dc + 3 * t;
    float* pf = s_rest + SR * t;
    s_m2d[2 * t] = g[11] * F32(0.5 * width);
    s_m2d[2 * t + 1] = g[12] * F32(0.5 * height);
    bool any = false;
#pragma unroll
    for (int c = 0; c < F; ++c) any = any || g[c] != 0.0f;
    if (valid[i] && any) {
      // the gradients overwrite the splat's own parameter slots: each is
      // written after splat_backward's last read of it
      splat_backward<DEG>(s_cam, width, height, scale_modifier, px, ps, pr, s_op[t], pd, pf, g,
                          px, ps, pr, s_op + t, pd, pf);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) px[c] = pd[c] = 0.0f;
      ps[0] = ps[1] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) pr[c] = 0.0f;
      s_op[t] = 0.0f;
#pragma unroll
      for (int c = 0; c < REST; ++c) pf[c] = 0.0f;
    }
  }
  __syncthreads();
  unstage(g_xyz + 3 * base, s_xyz, 3 * rows);
  unstage(g_scaling + 2 * base, s_scl, 2 * rows);
  unstage(g_rotation + 4 * base, s_rot, 4 * rows);
  unstage(g_opacity + base, s_op, rows);
  unstage(g_features_dc + 3 * base, s_dc, 3 * rows);
  unstage(g_means2d + 2 * base, s_m2d, 2 * rows);
  if (n_rest > 0)
    unstage_rows(g_features_rest + (size_t)3 * n_rest * base, 3 * n_rest, s_rest, SR, REST,
                 rows);
}

template <int DEG>
int launch_bwd(const void* xyz, const void* scaling, const void* rotation, const void* opacity,
               const void* features_dc, const void* features_rest, const void* valid,
               const void* world_view, int wv_s0, int wv_s1, const void* full_proj, int fp_s0,
               int fp_s1, const void* camera_center, const void* g_blob, int n, int n_rest,
               int width, int height, float scale_modifier, void* g_xyz, void* g_scaling,
               void* g_rotation, void* g_opacity, void* g_features_dc, void* g_features_rest,
               void* g_means2d, void* stream) {
  if (n == 0) return 0;
  const size_t smem =
      sizeof(float) * THREADS * (F + 3 + 2 + 4 + 1 + 3 + 2 + Bands<DEG>::SR);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        preprocess_bwd_kernel<DEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  preprocess_bwd_kernel<DEG><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)scaling, (const float*)rotation, (const float*)opacity,
      (const float*)features_dc, (const float*)features_rest, (const unsigned char*)valid,
      (const float*)world_view, wv_s0, wv_s1, (const float*)full_proj, fp_s0, fp_s1,
      (const float*)camera_center, (const float*)g_blob, n, n_rest, width, height,
      scale_modifier, (float*)g_xyz, (float*)g_scaling, (float*)g_rotation, (float*)g_opacity,
      (float*)g_features_dc, (float*)g_features_rest, (float*)g_means2d);
  return (int)cudaGetLastError();
}

#define PARAMS                                                                            \
  const void *xyz, const void *scaling, const void *rotation, const void *opacity,        \
      const void *features_dc, const void *features_rest, const void *active,             \
      const void *means2d, const void *world_view, int wv_s0, int wv_s1,                  \
      const void *full_proj, int fp_s0, int fp_s1, const void *camera_center, int n,      \
      int n_rest, int width, int height, float scale_modifier, void *blob, void *conics,  \
      void *aux, void *valid, void *stream
#define ARGS                                                                               \
  xyz, scaling, rotation, opacity, features_dc, features_rest, active, means2d, world_view, \
      wv_s0, wv_s1, full_proj, fp_s0, fp_s1, camera_center, n, n_rest, width, height,      \
      scale_modifier, blob, conics, aux, valid, stream
#define BWD_ARGS                                                                          \
  xyz, scaling, rotation, opacity, features_dc, features_rest, valid, world_view, wv_s0,  \
      wv_s1, full_proj, fp_s0, fp_s1, camera_center, g_blob, n, n_rest, width, height,    \
      scale_modifier, g_xyz, g_scaling, g_rotation, g_opacity, g_features_dc,             \
      g_features_rest, g_means2d, stream

}  // namespace

// degree = min(active_degree, sh_degree) <= 4 with (degree+1)^2 - 1 <=
// n_rest; xyz [N,3], scaling [N,2] (log), rotation [N,4], opacity [N,1]
// (logit), features_dc [N,1,3], features_rest [N,n_rest,3], means2d [N,2]
// f32 and active [N] bool, each contiguous; world_view and full_proj [4,4]
// f32 (element (r, c) at r * s0 + c * s1), camera_center [3]. Writes blob
// [N+1, 20] and conics [N+1, 8] (16-byte aligned), aux [4, N] f32
// (radius, depth, rx, ry) and valid [N] bool.
extern "C" int preprocess_grad_fwd(int degree, PARAMS) {
  switch (degree) {
    case 0: return launch_rows<0, true>(ARGS);
    case 1: return launch_rows<1, true>(ARGS);
    case 2: return launch_rows<2, true>(ARGS);
    case 3: return launch_rows<3, true>(ARGS);
    case 4: return launch_rows<4, true>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The parameters and the camera as preprocess_grad_fwd took them, its
// valid [N] bool and the blob's cotangent g_blob [N+1, 20] f32 (16-byte
// aligned). Writes the gradients g_xyz [N,3], g_scaling [N,2], g_rotation
// [N,4], g_opacity [N,1], g_features_dc [N,1,3], g_features_rest
// [N,n_rest,3] (zero in the bands above degree) and g_means2d [N,2] f32,
// each contiguous.
extern "C" int preprocess_bwd(int degree, const void *xyz, const void *scaling, const void *rotation, const void *opacity, const void *features_dc, const void *features_rest, const void *valid, const void *world_view, int wv_s0, int wv_s1, const void *full_proj, int fp_s0, int fp_s1, const void *camera_center, const void *g_blob, int n, int n_rest, int width, int height, float scale_modifier, void *g_xyz, void *g_scaling, void *g_rotation, void *g_opacity, void *g_features_dc, void *g_features_rest, void *g_means2d, void *stream) {
  switch (degree) {
    case 0: return launch_bwd<0>(BWD_ARGS);
    case 1: return launch_bwd<1>(BWD_ARGS);
    case 2: return launch_bwd<2>(BWD_ARGS);
    case 3: return launch_bwd<3>(BWD_ARGS);
    case 4: return launch_bwd<4>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
