// Hopper relaxation kernel: outer x (phi/ksi + inner Jacobi sweeps) for one
// pyramid level, called from JAX through the XLA FFI.
//
// Contract: tpuflow.solver.bucketed._relax_dyn (the XLA engine). The math is
// the single-source math of tpuflow/ops/sweep_core.py (sweep_update_T) and
// tpuflow/ops/solver_ops.py (compute_phi_ksi_dyn), in the same expression
// order.
//
// Boundary: the XLA engine keeps mirror ghost rows/cols at the valid extent
// (ch, cw) of the bucket arrays (maintain_mirror1 after every update). A
// ghost value always equals the value two rows/cols inside, so for every
// pixel of the valid region the engine computes exactly the relaxation of
// the (ch, cw) image with reflect boundary. This kernel computes that
// directly: neighbour indices are reflected at the valid edge and nothing
// is stored in the ghosts. Output pixels outside the valid region are 0.
//
// Two launch shapes (tpuflow/ops/relax_cuda.py picks one per bucket):
//   * whole level: one block holds u, v, du, dv, phi of the whole valid
//     region in shared memory and runs all outer x inner iterations in one
//     launch (coarse buckets, valid region <= 56 x 120);
//   * tiled: one launch per outer iteration; each block owns a TH x TW tile
//     and recomputes an (inner + 1)-pixel halo around it, so phi/ksi and all
//     inner sweeps of that outer iteration run out of shared memory. The
//     margin shrinks by one pixel per stencil pass (phi feeds the
//     half-point weights of the first sweep), exactly the arithmetic of
//     tpuflow/parallel/halo.py's fused block.
//
// Build: python -m tpuflow.ops.relax_cuda --build

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kSmallThreads = 512;
constexpr int kSmallMaxP = 14;  // 512 * 14 >= 56 * 120
constexpr int kTiledThreads = 256;
constexpr int kTiledMaxP = 14;  // 256 * 14 >= (32 + 12) * (64 + 12)
constexpr int kFields = 5;      // u, v, du, dv, phi in shared memory

struct Level {
  int cw, ch;
  float div2hx, div2hy, ahx2, ahy2;
};

__device__ __forceinline__ Level load_level(const float* __restrict__ p) {
  Level L;
  L.cw = static_cast<int>(p[0]);
  L.ch = static_cast<int>(p[1]);
  L.div2hx = p[2];
  L.div2hy = p[3];
  L.ahx2 = p[4];
  L.ahy2 = p[5];
  return L;
}

// Reflect at the valid edge (x < 0 -> -x, x >= n -> 2n - x - 2), then clamp
// into the block's region [r0, r0 + rn): a clamped read only happens in the
// halo margin, whose values are discarded.
__device__ __forceinline__ int nb(int g, int d, int n, int r0, int rn) {
  int y = g + d;
  y = y < 0 ? -y : (y >= n ? 2 * n - y - 2 : y);
  y -= r0;
  return y < 0 ? 0 : (y >= rn ? rn - 1 : y);
}

template <bool kGrey, int kThreads, int kMaxP>
__global__ void __launch_bounds__(kThreads)
relax_kernel(const float* __restrict__ params,
             const float* __restrict__ fx, const float* __restrict__ fy,
             const float* __restrict__ ft,
             const float* __restrict__ j11, const float* __restrict__ j22,
             const float* __restrict__ j12, const float* __restrict__ j13,
             const float* __restrict__ j23,
             const float* __restrict__ u, const float* __restrict__ v,
             const float* __restrict__ du_in, const float* __restrict__ dv_in,
             float* __restrict__ du_out, float* __restrict__ dv_out,
             int wb, int tile_h, int tile_w, int halo,
             int n_outer, int inner, float e_s2, float e_d2) {
  extern __shared__ float smem[];
  const Level L = load_level(params);
  const int tid = threadIdx.x;

  // Owned tile (bucket coordinates) and the region computed for it.
  const int oy0 = blockIdx.y * tile_h, ox0 = blockIdx.x * tile_w;
  const int oy1 = oy0 + tile_h, ox1 = ox0 + tile_w;
  const int ry0 = max(0, oy0 - halo), ry1 = min(L.ch, oy1 + halo);
  const int rx0 = max(0, ox0 - halo), rx1 = min(L.cw, ox1 + halo);
  const int rh = ry1 - ry0, rw = rx1 - rx0;
  const int n = (rh > 0 && rw > 0) ? rh * rw : 0;
  const int cap = n;  // field stride in shared memory
  float* s_u = smem;
  float* s_v = smem + cap;
  float* s_du = smem + 2 * cap;
  float* s_dv = smem + 3 * cap;
  float* s_phi = smem + 4 * cap;

  if (n > 0) {
    for (int i = tid; i < n; i += kThreads) {
      const int g = (ry0 + i / rw) * wb + rx0 + i % rw;
      s_u[i] = u[g];
      s_v[i] = v[g];
      s_du[i] = du_in ? du_in[g] : 0.0f;
      s_dv[i] = dv_in ? dv_in[g] : 0.0f;
    }
  }
  __syncthreads();

  float r_a[kMaxP], r_b[kMaxP], r_ksi[kMaxP];
  for (int o = 0; o < n_outer && n > 0; ++o) {
    // ---- phi / ksi (compute_phi_ksi_dyn) ----
#pragma unroll
    for (int k = 0; k < kMaxP; ++k) {
      const int i = tid + k * kThreads;
      if (i < n) {
        const int ly = i / rw, lx = i % rw;
        const int gy = ry0 + ly, gx = rx0 + lx;
        const int xp = ly * rw + nb(gx, 1, L.cw, rx0, rw);
        const int xm = ly * rw + nb(gx, -1, L.cw, rx0, rw);
        const int yp = nb(gy, 1, L.ch, ry0, rh) * rw + lx;
        const int ym = nb(gy, -1, L.ch, ry0, rh) * rw + lx;
        const float dux = (s_u[xp] - s_u[xm] + s_du[xp] - s_du[xm]) / L.div2hx;
        const float duy = (s_u[yp] - s_u[ym] + s_du[yp] - s_du[ym]) / L.div2hy;
        const float dvx = (s_v[xp] - s_v[xm] + s_dv[xp] - s_dv[xm]) / L.div2hx;
        const float dvy = (s_v[yp] - s_v[ym] + s_dv[yp] - s_dv[ym]) / L.div2hy;
        r_a[k] = 1.0f / (2.0f * sqrtf(dux * dux + duy * duy + dvx * dvx +
                                      dvy * dvy + e_s2));
        const int g = gy * wb + gx;
        const float gx_ = fx[g], gy_ = fy[g], gt_ = ft[g];
        const float J11 = gx_ * gx_, J22 = gy_ * gy_, J33 = gt_ * gt_;
        const float J12 = gx_ * gy_, J13 = gx_ * gt_, J23 = gy_ * gt_;
        const float duc = s_du[i], dvc = s_dv[i];
        float s = (J11 * duc + J12 * dvc + J13) * duc +
                  (J12 * duc + J22 * dvc + J23) * dvc +
                  (J13 * duc + J23 * dvc + J33);
        s = fmaxf(s, 0.0f);
        r_ksi[k] = 1.0f / (2.0f * sqrtf(s + e_d2));
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxP; ++k) {
      const int i = tid + k * kThreads;
      if (i < n) s_phi[i] = r_a[k];
    }
    __syncthreads();

    // ---- inner Jacobi sweeps (sweep_update_T) ----
    for (int it = 0; it < inner; ++it) {
#pragma unroll
      for (int k = 0; k < kMaxP; ++k) {
        const int i = tid + k * kThreads;
        if (i < n) {
          const int ly = i / rw, lx = i % rw;
          const int gy = ry0 + ly, gx = rx0 + lx;
          const int xp = ly * rw + nb(gx, 1, L.cw, rx0, rw);
          const int xm = ly * rw + nb(gx, -1, L.cw, rx0, rw);
          const int yp = nb(gy, 1, L.ch, ry0, rh) * rw + lx;
          const int ym = nb(gy, -1, L.ch, ry0, rh) * rw + lx;
          const float w_xp = gx < L.cw - 1 ? L.ahx2 : 0.0f;
          const float w_xm = gx > 0 ? L.ahx2 : 0.0f;
          const float w_yp = gy < L.ch - 1 ? L.ahy2 : 0.0f;
          const float w_ym = gy > 0 ? L.ahy2 : 0.0f;
          const float phc = s_phi[i];
          const float pw_xp = (s_phi[xp] + phc) * 0.5f * w_xp;
          const float pw_xm = (s_phi[xm] + phc) * 0.5f * w_xm;
          const float pw_yp = (s_phi[yp] + phc) * 0.5f * w_yp;
          const float pw_ym = (s_phi[ym] + phc) * 0.5f * w_ym;
          const float sumH = pw_xp + pw_xm + pw_yp + pw_ym;
          const int g = gy * wb + gx;
          float J11, J22, J12, J13, J23;
          if (kGrey) {
            const float gx_ = fx[g], gy_ = fy[g], gt_ = ft[g];
            J11 = gx_ * gx_;
            J22 = gy_ * gy_;
            J12 = gx_ * gy_;
            J13 = gx_ * gt_;
            J23 = gy_ * gt_;
          } else {
            J11 = j11[g];
            J22 = j22[g];
            J12 = j12[g];
            J13 = j13[g];
            J23 = j23[g];
          }
          const float ksi = r_ksi[k];
          const float a12 = ksi * J12, a13 = ksi * J13, a23 = ksi * J23;
          const float dnu = ksi * J11 + sumH, dnv = ksi * J22 + sumH;
          const float uc = s_u[i], vc = s_v[i];
          const float sumU = pw_xp * (s_u[xp] + s_du[xp] - uc) +
                             pw_xm * (s_u[xm] + s_du[xm] - uc) +
                             pw_yp * (s_u[yp] + s_du[yp] - uc) +
                             pw_ym * (s_u[ym] + s_du[ym] - uc);
          const float sumV = pw_xp * (s_v[xp] + s_dv[xp] - vc) +
                             pw_xm * (s_v[xm] + s_dv[xm] - vc) +
                             pw_yp * (s_v[yp] + s_dv[yp] - vc) +
                             pw_ym * (s_v[ym] + s_dv[ym] - vc);
          const float ndu = (-a13 - a12 * s_dv[i] + sumU) / dnu;
          r_a[k] = ndu;
          r_b[k] = (-a23 - a12 * ndu + sumV) / dnv;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMaxP; ++k) {
        const int i = tid + k * kThreads;
        if (i < n) {
          s_du[i] = r_a[k];
          s_dv[i] = r_b[k];
        }
      }
      __syncthreads();
    }
  }

  // Write the owned tile: valid pixels from shared memory, the rest 0.
  const int th = tile_h, tw = tile_w;
  const int hb_ = gridDim.y * tile_h;  // >= hb; rows past hb are skipped
  for (int i = tid; i < th * tw; i += kThreads) {
    const int gy = oy0 + i / tw, gx = ox0 + i % tw;
    if (gy >= hb_ || gx >= wb) continue;
    const int g = gy * wb + gx;
    if (gy < L.ch && gx < L.cw && n > 0) {
      const int l = (gy - ry0) * rw + gx - rx0;
      du_out[g] = s_du[l];
      dv_out[g] = s_dv[l];
    } else {
      du_out[g] = 0.0f;
      dv_out[g] = 0.0f;
    }
  }
}

template <bool kGrey, int kThreads, int kMaxP>
cudaError_t launch(cudaStream_t stream, dim3 grid, size_t smem,
                   const float* params, const float* const* c,
                   const float* u, const float* v, const float* du_in,
                   const float* dv_in, float* du_out, float* dv_out, int wb,
                   int tile_h, int tile_w, int halo, int n_outer, int inner,
                   float e_s2, float e_d2) {
  auto* fn = relax_kernel<kGrey, kThreads, kMaxP>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<grid, kThreads, smem, stream>>>(params, c[0], c[1], c[2], c[3], c[4],
                                       c[5], c[6], c[7], u, v, du_in, dv_in,
                                       du_out, dv_out, wb, tile_h, tile_w,
                                       halo, n_outer, inner, e_s2, e_d2);
  return cudaGetLastError();
}

ffi::Error Relax(cudaStream_t stream, ffi::Buffer<ffi::F32> params,
                 ffi::Buffer<ffi::F32> fx, ffi::Buffer<ffi::F32> fy,
                 ffi::Buffer<ffi::F32> ft, ffi::Buffer<ffi::F32> j11,
                 ffi::Buffer<ffi::F32> j22, ffi::Buffer<ffi::F32> j12,
                 ffi::Buffer<ffi::F32> j13, ffi::Buffer<ffi::F32> j23,
                 ffi::Buffer<ffi::F32> u, ffi::Buffer<ffi::F32> v,
                 ffi::ResultBuffer<ffi::F32> du, ffi::ResultBuffer<ffi::F32> dv,
                 ffi::ResultBuffer<ffi::F32> du_tmp,
                 ffi::ResultBuffer<ffi::F32> dv_tmp, int64_t outer,
                 int64_t inner, int64_t grey, int64_t whole, int64_t tile_h,
                 int64_t tile_w, float e_s2, float e_d2) {
  auto dims = u.dimensions();
  if (dims.size() != 2) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "expected 2-D fields");
  }
  const int hb = static_cast<int>(dims[0]), wb = static_cast<int>(dims[1]);
  const float* c[8] = {fx.typed_data(),  fy.typed_data(),  ft.typed_data(),
                       j11.typed_data(), j22.typed_data(), j12.typed_data(),
                       j13.typed_data(), j23.typed_data()};
  float* out_u = du->typed_data();
  float* out_v = dv->typed_data();
  float* tmp_u = du_tmp->typed_data();
  float* tmp_v = dv_tmp->typed_data();
  const float* p = params.typed_data();
  cudaError_t err = cudaSuccess;

  if (whole) {
    // One block, all iterations; the region is the valid extent, at most
    // (hb - 8) x (wb - 8) (bucket slack).
    const size_t smem = sizeof(float) * kFields * (hb - 8) * (wb - 8);
    err = grey ? launch<true, kSmallThreads, kSmallMaxP>(
                     stream, dim3(1, 1), smem, p, c, u.typed_data(),
                     v.typed_data(), nullptr, nullptr, out_u, out_v, wb, hb,
                     wb, 0, static_cast<int>(outer), static_cast<int>(inner),
                     e_s2, e_d2)
               : launch<false, kSmallThreads, kSmallMaxP>(
                     stream, dim3(1, 1), smem, p, c, u.typed_data(),
                     v.typed_data(), nullptr, nullptr, out_u, out_v, wb, hb,
                     wb, 0, static_cast<int>(outer), static_cast<int>(inner),
                     e_s2, e_d2);
  } else {
    const int th = static_cast<int>(tile_h), tw = static_cast<int>(tile_w);
    const int halo = static_cast<int>(inner) + 1;
    const dim3 grid((wb + tw - 1) / tw, (hb + th - 1) / th);
    const size_t smem =
        sizeof(float) * kFields * (th + 2 * halo) * (tw + 2 * halo);
    const float* src_u = nullptr;
    const float* src_v = nullptr;
    for (int k = 0; k < outer && err == cudaSuccess; ++k) {
      // Ping-pong so that the last outer iteration lands in the result.
      const bool to_out = ((outer - 1 - k) % 2) == 0;
      float* dst_u = to_out ? out_u : tmp_u;
      float* dst_v = to_out ? out_v : tmp_v;
      err = grey ? launch<true, kTiledThreads, kTiledMaxP>(
                       stream, grid, smem, p, c, u.typed_data(),
                       v.typed_data(), src_u, src_v, dst_u, dst_v, wb, th, tw,
                       halo, 1, static_cast<int>(inner), e_s2, e_d2)
                 : launch<false, kTiledThreads, kTiledMaxP>(
                       stream, grid, smem, p, c, u.typed_data(),
                       v.typed_data(), src_u, src_v, dst_u, dst_v, wb, th, tw,
                       halo, 1, static_cast<int>(inner), e_s2, e_d2);
      src_u = dst_u;
      src_v = dst_v;
    }
  }
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TpuflowRelax, Relax,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()  // params
        .Arg<ffi::Buffer<ffi::F32>>()  // fx
        .Arg<ffi::Buffer<ffi::F32>>()  // fy
        .Arg<ffi::Buffer<ffi::F32>>()  // ft
        .Arg<ffi::Buffer<ffi::F32>>()  // J11
        .Arg<ffi::Buffer<ffi::F32>>()  // J22
        .Arg<ffi::Buffer<ffi::F32>>()  // J12
        .Arg<ffi::Buffer<ffi::F32>>()  // J13
        .Arg<ffi::Buffer<ffi::F32>>()  // J23
        .Arg<ffi::Buffer<ffi::F32>>()  // u
        .Arg<ffi::Buffer<ffi::F32>>()  // v
        .Ret<ffi::Buffer<ffi::F32>>()  // du
        .Ret<ffi::Buffer<ffi::F32>>()  // dv
        .Ret<ffi::Buffer<ffi::F32>>()  // du scratch (tiled ping-pong)
        .Ret<ffi::Buffer<ffi::F32>>()  // dv scratch
        .Attr<int64_t>("outer")
        .Attr<int64_t>("inner")
        .Attr<int64_t>("grey")
        .Attr<int64_t>("whole")
        .Attr<int64_t>("tile_h")
        .Attr<int64_t>("tile_w")
        .Attr<float>("e_s2")
        .Attr<float>("e_d2"));
