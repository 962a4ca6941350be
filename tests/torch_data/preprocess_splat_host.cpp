// The per-splat math of gaussmart_tpu_torch/csrc/preprocess_splat.cuh on the
// host, splat after splat, for tests/test_torch_preprocess_grad.py: the
// kernels' per-thread work (K8's forward rows, its VJP with the gradients
// written over copies of the parameters, as the kernel writes them over its
// staged parameters) without the staging. Built there with g++:
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC -I<csrc> <this file>

#include "preprocess_splat.cuh"

using namespace preprocess_splat;

template <int DEG>
static void host_fwd_t(int n, int n_rest, const float* xyz, const float* scl, const float* rot,
                       const float* op, const float* dc, const float* rest,
                       const unsigned char* active, const float* means2d, const float* cam,
                       int width, int height, float sm, float* blob, float* conics,
                       float* aux, unsigned char* valid) {
  for (int i = 0; i < n; ++i) {
    Splat<DEG> s;
    splat_forward<DEG>(cam, width, height, sm, xyz + 3 * i, scl + 2 * i, rot + 4 * i, op[i],
                       active[i] != 0, dc + 3 * i, rest + (size_t)3 * n_rest * i, s);
    splat_blob_row<DEG>(s, means2d[2 * i] * F32(0.5 * width),
                        means2d[2 * i + 1] * F32(0.5 * height), blob + F * i);
    for (int c = 0; c < FC; ++c) conics[FC * i + c] = s.conic[c];
    aux[i] = s.radius;
    aux[n + i] = s.z_view;
    aux[2 * n + i] = s.rx;
    aux[3 * n + i] = s.ry;
    valid[i] = s.valid;
  }
  for (int c = 0; c < F; ++c) blob[F * n + c] = 0.0f;
  for (int c = 0; c < FC; ++c) conics[FC * n + c] = 0.0f;
}

// as the kernel: the gradients overwrite copies of the parameters in place
template <int DEG>
static void host_bwd_t(int n, int n_rest, const float* op, const unsigned char* valid,
                       const float* g_blob, const float* cam, int width, int height, float sm,
                       float* g_xyz, float* g_scl, float* g_rot, float* g_op, float* g_dc,
                       float* g_rest, float* g_m2d) {
  constexpr int REST = Bands<DEG>::REST;
  for (int i = 0; i < n; ++i) {
    const float* g = g_blob + F * i;
    g_m2d[2 * i] = g[11] * F32(0.5 * width);
    g_m2d[2 * i + 1] = g[12] * F32(0.5 * height);
    bool any = false;
    for (int c = 0; c < F; ++c) any = any || g[c] != 0.0f;
    float* pf = g_rest + (size_t)3 * n_rest * i;
    if (valid[i] && any) {
      splat_backward<DEG>(cam, width, height, sm, g_xyz + 3 * i, g_scl + 2 * i, g_rot + 4 * i,
                          op[i], g_dc + 3 * i, pf, g, g_xyz + 3 * i, g_scl + 2 * i,
                          g_rot + 4 * i, g_op + i, g_dc + 3 * i, pf);
    } else {
      for (int c = 0; c < 3; ++c) g_xyz[3 * i + c] = g_dc[3 * i + c] = 0.0f;
      g_scl[2 * i] = g_scl[2 * i + 1] = 0.0f;
      for (int c = 0; c < 4; ++c) g_rot[4 * i + c] = 0.0f;
      g_op[i] = 0.0f;
      for (int c = 0; c < REST; ++c) pf[c] = 0.0f;
    }
    for (int c = REST; c < 3 * n_rest; ++c) pf[c] = 0.0f;
  }
}

extern "C" void host_camera(const float* wv, int wv_s0, int wv_s1, const float* fp, int fp_s0,
                            int fp_s1, const float* cc, int width, int height, float* cam) {
  for (int i = 0; i < CAM; ++i)
    cam[i] = camera_entry(i, wv, wv_s0, wv_s1, fp, fp_s0, fp_s1, cc, width, height);
}

#define FWD_ARGS n, n_rest, xyz, scl, rot, op, dc, rest, active, means2d, cam, width, height, sm, \
    blob, conics, aux, valid
extern "C" int host_fwd(int deg, int n, int n_rest, const float* xyz, const float* scl,
                        const float* rot, const float* op, const float* dc, const float* rest,
                        const unsigned char* active, const float* means2d, const float* cam,
                        int width, int height, float sm, float* blob, float* conics,
                        float* aux, unsigned char* valid) {
  switch (deg) {
    case 0: host_fwd_t<0>(FWD_ARGS); return 0;
    case 1: host_fwd_t<1>(FWD_ARGS); return 0;
    case 2: host_fwd_t<2>(FWD_ARGS); return 0;
    case 3: host_fwd_t<3>(FWD_ARGS); return 0;
    case 4: host_fwd_t<4>(FWD_ARGS); return 0;
  }
  return 1;
}

#define BWD_ARGS n, n_rest, op, valid, g_blob, cam, width, height, sm, g_xyz, g_scl, g_rot, \
    g_op, g_dc, g_rest, g_m2d
extern "C" int host_bwd(int deg, int n, int n_rest, const float* op, const unsigned char* valid,
                        const float* g_blob, const float* cam, int width, int height, float sm,
                        float* g_xyz, float* g_scl, float* g_rot, float* g_op, float* g_dc,
                        float* g_rest, float* g_m2d) {
  switch (deg) {
    case 0: host_bwd_t<0>(BWD_ARGS); return 0;
    case 1: host_bwd_t<1>(BWD_ARGS); return 0;
    case 2: host_bwd_t<2>(BWD_ARGS); return 0;
    case 3: host_bwd_t<3>(BWD_ARGS); return 0;
    case 4: host_bwd_t<4>(BWD_ARGS); return 0;
  }
  return 1;
}
