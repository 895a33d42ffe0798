// Pieces the volumetric kernels K8 (volpath_kernels.cu) and K9
// (volpath_grid_kernels.cu) share: the draw-site salts and the sub-stream
// uniform of lajolla_tpu_torch/integrators/volpath.py (`_S_*`, `_IT0`,
// `_u`, `_uit`).
#pragma once

#include <cstdint>

#include "path_advance.cuh"

namespace lj {

constexpr float kInv4Pi = 0.07957747154594767f;

// Draw-site salts (integrators/volpath.py _S_*, _IT0).
struct VolSalts {
  uint32_t ff, nee, nee_seg, phase, bsdf, rr, surf_nee, it0;
};

// dim-th U[0,1) of the sub-stream rooted at hs (volpath._u)
__device__ __forceinline__ float u_dim(uint32_t hs, uint32_t dim) {
  return u01(pcg_hash(hs + dim * kGold));
}

// k-th uniform of tracking iteration it (volpath._uit)
__device__ __forceinline__ float u_it(uint32_t hs, uint32_t it, uint32_t k,
                                      uint32_t it0) {
  return u_dim(pcg_hash(hs ^ pcg_hash(it + it0)), k + 1u);
}

__device__ __forceinline__ float max3(V3 v) { return mx(mx(v.x, v.y), v.z); }

}  // namespace lj
