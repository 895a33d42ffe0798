// CUDA kernels of the path integrator's main path, with a plain C
// interface for ctypes (lajolla_tpu_torch/kernels.py builds this file
// with nvcc for sm_90a and binds it).
//
// K1 render_fused_kernel replaces lajolla_tpu's Pallas megakernel
//    (lajolla_tpu/integrators/path_megakernel.py `_kernel`, launched by
//    `render_fused`): the whole persistent wavefront for nspp samples of
//    every pixel in one launch.
// K2 advance_kernel replaces the per-bounce Pallas kernel
//    (lajolla_tpu/integrators/path_kernel.py `_kernel`, launched by
//    `advance_kernel_t`): one path vertex for a batch of lanes.
//
// Both are one thread per lane around lj::advance_vertex
// (path_advance.cuh). K1 needs no lockstep: each thread walks its own
// queue item = pixel + k*n, k = s0 .. s0+nspp-1, regenerating at once
// when a path ends, and sums its pixel in registers in sample order —
// the same per-lane sequence as the TPU kernel. It is bounded by
// per-thread ALU work and divergence (path lengths differ between the
// threads of a warp, and a warp runs until its longest queue is done);
// film traffic is one (3, n) store. K2 moves (3+3+3+3+1+1+3+8+1) floats
// in and 14 out per lane per vertex on top of the same work. Staging the
// scene tables in shared memory, and a wavefront redesign that regroups
// lanes by path length and material, are later work (ROADMAP; PAPERS.md
// "Megakernel vs Wavefront GPU Path Tracing").
//
// Every entry returns cudaGetLastError() after its launch; the kernels
// launch on the caller's stream and do not synchronise.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "camera.cuh"
#include "path_advance.cuh"

namespace {

using lj::Camera;
using lj::primary;

constexpr int kThreads = 128;

__device__ __forceinline__ void vertex_uniforms(uint32_t su, long long item,
                                                int nv, float un[8]) {
  uint32_t hb = lj::pcg_hash((uint32_t)item ^ lj::pcg_hash((uint32_t)nv ^ su));
#pragma unroll
  for (int k = 0; k < 8; ++k)
    un[k] = lj::u01(lj::pcg_hash(hb + (uint32_t)(k + 1) * lj::kGold));
}

// K1: one thread per pixel, nspp samples each; film is (3, n).
template <int MATS, bool QUADS, bool SPH>
__global__ void __launch_bounds__(kThreads)
render_fused_kernel(lj::Tables tb, Camera cam, int n, int w, uint32_t su,
                    long long s0, int nspp, float* __restrict__ film) {
  using namespace lj;
  const int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= n) return;
  const float px = (float)(pixel % w), py = (float)(pixel / w);
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  for (long long k = s0; k < s0 + nspp; ++k) {
    const long long item = pixel + k * n;
    Lane st;
    primary(cam, su, item, px, py, st.o, st.d);
    st.prev = st.o;
    st.thr = v3(1.0f, 1.0f, 1.0f);
    st.rad = v3(0.0f, 0.0f, 0.0f);
    st.dir_pdf = 0.0f;
    for (int nv = 2;; ++nv) {
      float un[8];
      vertex_uniforms(su, item, nv, un);
      if (!advance_vertex<MATS, QUADS, SPH>(tb, st, (float)nv, un, true)) {
        // whole-sample NaN/Inf exclusion (render.cpp:140-143)
        if (isfinite(st.rad.x) && isfinite(st.rad.y) && isfinite(st.rad.z)) {
          acc.x += st.rad.x;
          acc.y += st.rad.y;
          acc.z += st.rad.z;
        }
        break;
      }
      st.prev = st.o;
    }
  }
  film[pixel] = acc.x;
  film[n + pixel] = acc.y;
  film[2 * (long long)n + pixel] = acc.z;
}

// K2: one vertex for each of n lanes; vectors are (3, n) rows, un (8, n).
template <int MATS, bool QUADS, bool SPH>
__global__ void __launch_bounds__(kThreads)
advance_kernel(lj::Tables tb, int n, const float* __restrict__ org,
               const float* __restrict__ dir, const float* __restrict__ thr,
               const float* __restrict__ rad, const float* __restrict__ nv,
               const float* __restrict__ dir_pdf,
               const float* __restrict__ prev, const float* __restrict__ un,
               const bool* __restrict__ act, float* __restrict__ org_o,
               float* __restrict__ dir_o, float* __restrict__ thr_o,
               float* __restrict__ rad_o, float* __restrict__ dp_o,
               bool* __restrict__ alive_o) {
  using namespace lj;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long n2 = 2 * (long long)n;
  auto row3 = [&](const float* a) { return v3(a[i], a[n + i], a[n2 + i]); };
  Lane st;
  st.o = row3(org);
  st.d = row3(dir);
  st.thr = row3(thr);
  st.rad = row3(rad);
  st.prev = row3(prev);
  st.dir_pdf = dir_pdf[i];
  float u[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = un[k * (long long)n + i];
  const bool alive = advance_vertex<MATS, QUADS, SPH>(tb, st, nv[i], u, act[i]);
  auto put3 = [&](float* a, V3 v) {
    a[i] = v.x;
    a[n + i] = v.y;
    a[n2 + i] = v.z;
  };
  put3(org_o, st.o);
  put3(dir_o, st.d);
  put3(thr_o, st.thr);
  put3(rad_o, st.rad);
  dp_o[i] = st.dir_pdf;
  alive_o[i] = alive;
}

// Calls f(M, Q, S) with the kernel specialisation as integral constants.
template <class F>
cudaError_t dispatch(int mats, int quads, int sph, F f) {
  auto by_sph = [&](auto M, auto Q) {
    return sph ? f(M, Q, std::true_type{}) : f(M, Q, std::false_type{});
  };
  auto by_quads = [&](auto M) {
    return quads ? by_sph(M, std::true_type{}) : by_sph(M, std::false_type{});
  };
  switch (mats) {
    case lj::kLambertian:
      return by_quads(std::integral_constant<int, lj::kLambertian>{});
    case lj::kRoughPlastic:
      return by_quads(std::integral_constant<int, lj::kRoughPlastic>{});
    case lj::kLambertian | lj::kRoughPlastic:
      return by_quads(
          std::integral_constant<int, lj::kLambertian | lj::kRoughPlastic>{});
  }
  return cudaErrorInvalidValue;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// K1. mats: bit 0 Lambertian, bit 1 RoughPlastic.
int lj_render_fused(const lj::Tables* tb, const lj::Camera* cam, int mats,
                    int quads, int sph, int n, int w, uint32_t su,
                    long long s0, int nspp, float* film, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = dispatch(mats, quads, sph, [&](auto M, auto Q, auto S) {
    render_fused_kernel<decltype(M)::value, decltype(Q)::value,
                        decltype(S)::value>
        <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *tb, *cam, n, w, su, s0, nspp, film);
    return cudaGetLastError();
  });
  return (int)e;
}

// K2.
int lj_advance(const lj::Tables* tb, int mats, int quads, int sph, int n,
               const float* org, const float* dir, const float* thr,
               const float* rad, const float* nv, const float* dir_pdf,
               const float* prev, const float* un, const bool* act,
               float* org_o, float* dir_o, float* thr_o, float* rad_o,
               float* dp_o, bool* alive_o, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = dispatch(mats, quads, sph, [&](auto M, auto Q, auto S) {
    advance_kernel<decltype(M)::value, decltype(Q)::value, decltype(S)::value>
        <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            *tb, n, org, dir, thr, rad, nv, dir_pdf, prev, un, act, org_o,
            dir_o, thr_o, rad_o, dp_o, alive_o);
    return cudaGetLastError();
  });
  return (int)e;
}

}  // extern "C"
