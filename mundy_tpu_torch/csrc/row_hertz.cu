// Masked full-stencil Hertzian forces on the row layout (kernel K6).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/row_hertz.py
// (row_hertzian_forces / _kernel) and keeps its contract:
//   * input: (ny, nz, R, 3) positions in the periodic box and a (ny, nz, R)
//     validity mask; a pair counts only when both slots are valid, and a
//     slot never meets itself. No sentinel is relied on and no candidate row
//     is pre-shifted: every pair takes the minimum image on all three axes,
//     d -= L * rint(d / L) (rint is round-half-even, as jnp.round);
//   * over the full 9-row stencil (y+dy, z+dz), dy, dz in {-1, 0, 1};
//   * r2 is clamped at 1e-24; f_i = sum_j mag / d * (x_i - x_j) with the
//     Hertz magnitude mag = (4/3) E* sqrt(R*) delta^{3/2}, E* = E / (2 (1 -
//     nu^2)).
// The kernel reads a per-slot radius plane (zero on invalid slots) and takes
// R* = ro rc / max(ro + rc, 1e-12) and delta = max(ro + rc - d, 0) per pair:
// the polydisperse law of driver/apps/spheres_rows.py. The reference's
// monodisperse law (R* = r / 2, contact at 2r) is the same law on a constant
// plane, which the wrapper (ops/kernels/row_hertz.py) builds, so one kernel
// serves both.
//
// Design: K1's (csrc/row_central.cu). One thread block per (iy, iz) row
// stages its 9 candidate rows as structure-of-arrays planes in shared memory
// (x, y, z, the mask as a 0/1 value and the radii: 9R x 5 values, 17 KB in
// float32 at R = 96); one thread owns one slot (looping when R > blockDim)
// and sums its force over all 9R candidates in registers, each read a
// shared-memory broadcast. One-sided: every off-row pair is evaluated from
// both sides, and no partner sum crosses threads or blocks, so the result is
// deterministic, with no atomics. Beside K1 the per-pair work gains the mask
// test, two more rint minimum images and the contact distance ro + rc; a
// pair out of contact stops there, before the division and the square
// roots (its force is exactly zero, as max(delta, 0) makes it).
//
// Dropped from the TPU kernel, because they exist only for the TPU: the
// three y-plane BlockSpecs, the pltpu.roll z-neighbours through VMEM
// scratch, the z-chunk loop and the (R, R) pair blocks.
//
// Arithmetic. The kernels build with -fmad=false (ops/kernels/_build.py);
// this kernel writes the fused multiply-adds of r2 and of the sums out
// (fma_), as K1 does, within the 5e-5 contract of its plain version.
//
// Bound: per pair out of contact about 22 FP32 operations, per pair in
// contact about 26 more with one rsqrt, one division and two square roots,
// and no memory traffic beyond the staged rows, so the FP32 and SFU pipes
// bound it, not bytes (chip_smoke.py counts both kinds of pair).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__device__ __forceinline__ T min_image(T d, T l, T inv_l) {
  return d - l * rint_(d * inv_l);
}

template <typename T>
__global__ void row_hertz_full_kernel(const T* __restrict__ pos,
                                      const bool* __restrict__ valid,
                                      const T* __restrict__ radii,
                                      T* __restrict__ out, int ny, int nz,
                                      int R, T lx, T inv_lx, T ly, T inv_ly,
                                      T lz, T inv_lz, T coef) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cx = reinterpret_cast<T*>(smem_raw);
  T* cy = cx + 9 * R;
  T* cz = cy + 9 * R;
  T* cv = cz + 9 * R;
  T* cr = cv + 9 * R;

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;

  // Stage the 9 candidate rows (wrapped, not shifted); block b =
  // (dy + 1) * 3 + (dz + 1), the order of rows._candidate_planes.
  for (int b = 0; b < 9; ++b) {
    const int jy = (iy + b / 3 - 1 + ny) % ny;
    const int jz = (iz + b % 3 - 1 + nz) % nz;
    const size_t base = (static_cast<size_t>(jy) * nz + jz) * R;
    for (int k = threadIdx.x; k < R; k += blockDim.x) {
      cx[b * R + k] = pos[3 * (base + k)];
      cy[b * R + k] = pos[3 * (base + k) + 1];
      cz[b * R + k] = pos[3 * (base + k) + 2];
      cv[b * R + k] = valid[base + k] ? T(1) : T(0);
      cr[b * R + k] = radii[base + k];
    }
  }
  __syncthreads();

  const int n_cand = 9 * R;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    const int self = 4 * R + i;  // own row = centre block
    T fx = T(0), fy = T(0), fz = T(0);
    if (cv[self] != T(0)) {
      const T ox = cx[self];
      const T oy = cy[self];
      const T oz = cz[self];
      const T ro = cr[self];
      for (int j = 0; j < n_cand; ++j) {
        if (cv[j] == T(0) || j == self) continue;
        const T dx = min_image(ox - cx[j], lx, inv_lx);
        const T dy = min_image(oy - cy[j], ly, inv_ly);
        const T dz = min_image(oz - cz[j], lz, inv_lz);
        const T r2 = fmax(fma_(dz, dz, fma_(dy, dy, dx * dx)), T(1e-24));
        const T rc = cr[j];
        const T s = ro + rc;
        const T rinv = rsqrt_(r2);
        const T delta = s - r2 * rinv;
        if (!(delta > T(0))) continue;  // out of contact: max(delta, 0) = 0
        const T c = coef * sqrt_((ro * rc) / fmax(s, T(1e-12)));
        const T w = (c * delta * sqrt_(delta)) * rinv;
        fx = fma_(w, dx, fx);
        fy = fma_(w, dy, fy);
        fz = fma_(w, dz, fz);
      }
    }
    T* o = out + (static_cast<size_t>(row) * R + i) * 3;
    o[0] = fx;
    o[1] = fy;
    o[2] = fz;
  }
}

template <typename T>
int launch(const void* pos, const void* valid, const void* radii, void* out,
           int ny, int nz, int R, double lx, double ly, double lz, double coef,
           void* stream) {
  const int threads = R >= 256 ? 256 : ((R + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(9) * R * 5 * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_hertz_full_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  row_hertz_full_kernel<T><<<ny * nz, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const bool*>(valid),
      static_cast<const T*>(radii), static_cast<T*>(out), ny, nz, R, T(lx),
      T(1.0 / lx), T(ly), T(1.0 / ly), T(lz), T(1.0 / lz), T(coef));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// valid: (ny, nz, R) bytes, nonzero where a slot holds a sphere; radii: the
// (ny, nz, R) radius plane in the positions' dtype; coef = (4/3) E*.
// Returns cudaGetLastError() after the launch (0 = launched).
int row_hertzian_forces_f32(const void* pos, const void* valid,
                            const void* radii, void* out, int ny, int nz, int R,
                            double lx, double ly, double lz, double coef,
                            void* stream) {
  return launch<float>(pos, valid, radii, out, ny, nz, R, lx, ly, lz, coef,
                       stream);
}

int row_hertzian_forces_f64(const void* pos, const void* valid,
                            const void* radii, void* out, int ny, int nz, int R,
                            double lx, double ly, double lz, double coef,
                            void* stream) {
  return launch<double>(pos, valid, radii, out, ny, nz, R, lx, ly, lz, coef,
                        stream);
}

}  // extern "C"
