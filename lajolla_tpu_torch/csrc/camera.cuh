// The camera ray of the fused kernels (K1 in path_kernels.cu, K8 in
// volpath_kernels.cu): the device form of
// lajolla_tpu_torch/scene/camera.py `sample_primary_t`, itself the
// port of lajolla_tpu path_megakernel._primary (src/camera.cpp:23-47),
// with filter importance sampling for the box, tent and gaussian filters.
#pragma once

#include <cstdint>

#include "path_advance.cuh"

namespace lj {

// The scalars derived from Python floats are rounded to fp32 on the
// host, as the plain form rounds them.
struct Camera {
  float m[32];          // sample_to_cam (4x4) | cam_to_world (4x4)
  float inv_w, inv_h;   // fp32(1/w), fp32(1/h)
  float fparam;         // filter width (box, tent) or stddev (gaussian)
  float fhalf;          // fp32(fparam / 2)
  int ftype;            // FILTER_BOX 0, FILTER_TENT 1, FILTER_GAUSSIAN 2
};

__device__ __forceinline__ float tent_warp(float r, float fh) {
  return r < 0.5f ? fh * (sqrtf(2.0f * r) - 1.0f)
                  : fh * (1.0f - sqrtf(mx(1.0f - 2.0f * (r - 0.5f), 0.0f)));
}

// Camera ray for one work item of pixel (px, py); su is the stream root
// the caller's integrator hands the camera.
__device__ __forceinline__ void primary(const Camera& cam, uint32_t su,
                                        long long item, float px, float py,
                                        V3& org, V3& dir) {
  uint32_t hp = pcg_hash((uint32_t)item ^ pcg_hash(su ^ 0xCAFEF00Du));
  float u0 = u01(pcg_hash(hp + kGold));
  float u1 = u01(pcg_hash(hp + 2u * kGold));
  float ox, oy;
  if (cam.ftype == 0) {
    ox = (2.0f * u0 - 1.0f) * cam.fhalf;
    oy = (2.0f * u1 - 1.0f) * cam.fhalf;
  } else if (cam.ftype == 1) {
    ox = tent_warp(u0, cam.fhalf);
    oy = tent_warp(u1, cam.fhalf);
  } else {
    float r = cam.fparam * sqrtf(-2.0f * logf(mx(u0, 1e-8f)));
    ox = r * cosf(kTwoPi * u1);
    oy = r * sinf(kTwoPi * u1);
  }
  float x = (px + 0.5f + ox) * cam.inv_w;
  float y = (py + 0.5f + oy) * cam.inv_h;
  const float* m = cam.m;
  float rx = m[0] * x + m[1] * y + m[3];
  float ry = m[4] * x + m[5] * y + m[7];
  float rz = m[8] * x + m[9] * y + m[11];
  float rw = m[12] * x + m[13] * y + m[15];
  float inv_w = 1.0f / rw;
  V3 c = norm3(v3(rx * inv_w, ry * inv_w, rz * inv_w));
  dir = norm3(v3(m[16] * c.x + m[17] * c.y + m[18] * c.z,
                 m[20] * c.x + m[21] * c.y + m[22] * c.z,
                 m[24] * c.x + m[25] * c.y + m[26] * c.z));
  org = v3(m[19], m[23], m[27]);
}

}  // namespace lj
