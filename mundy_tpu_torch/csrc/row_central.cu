// Hertzian central forces on the dense row layout (kernel K1).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/row_central.py
// (row_hertzian_forces_sym / _sym_kernel) and keeps its arithmetic contract:
//   * input: (ny, nz, R, 3) positions from build_rows; invalid slots hold a
//     sentinel far outside the box, so no validity mask is read: a sentinel
//     pair lies beyond the contact distance and a self-pair has sep = 0;
//   * candidate rows (y+dy, z+dz) are pre-shifted to the periodic image
//     nearest the own row (as rows._roll_image_shift does), so a pair needs a
//     minimum image along x only, by round-half-even (rint);
//   * r2 is clamped at 1e-24; w = -(4/3) E* sqrt(R*) delta^{3/2} / d with
//     delta = max(2r - d, 0); f_i = sum_j w_ij (x_j - x_i).
//
// Design. One thread block per (iy, iz) row. The block stages its 9
// candidate rows, image-shifted, as structure-of-arrays planes in shared
// memory (27 R values: 9.5 KB in float32 at R = 88); one thread owns one slot
// (looping when R > blockDim) and sums its force over all 9R candidates in
// registers. Every off-row pair is thus evaluated from both sides (1.8x the
// pairs of the half stencil), but no partner sum crosses threads or blocks:
// the result is deterministic, with no atomics, and needs no second pass.
// All threads read the same candidate at once, a shared-memory broadcast.
//
// Dropped from the TPU kernel, because they exist only for the TPU: the
// nz % 8 requirement, the VMEM z-chunk planner, the lane-concatenated
// (nz, 5R) scratch and the three partner planes rolled outside the kernel.
//
// Arithmetic. The kernels build with -fmad=false (ops/kernels/_build.py),
// so no product and sum contract on their own; this kernel writes its fused
// multiply-adds out (fma_), as the 2e-5 contract with the TPU kernel's
// rsqrt arithmetic allows.
//
// Bound: per pair about 20 FP32 operations plus one rsqrt and one sqrt, and
// no memory traffic beyond the staged rows, so the SFU and FP32 pipes bound
// it, not bytes. A half-stencil variant with a deterministic in-block
// partner reduction would halve the off-row pairs.

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
__global__ void row_hertz_kernel(const T* __restrict__ pos, T* __restrict__ out,
                                 int ny, int nz, int R, T lx, T inv_lx, T ly,
                                 T lz, T two_r, T coef) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cx = reinterpret_cast<T*>(smem_raw);
  T* cy = cx + 9 * R;
  T* cz = cy + 9 * R;

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;

  // Stage the 9 candidate rows; block b = (dy + 1) * 3 + (dz + 1).
  for (int b = 0; b < 9; ++b) {
    int jy = iy + b / 3 - 1;
    int jz = iz + b % 3 - 1;
    T sy = T(0), sz = T(0);
    if (jy >= ny) { jy -= ny; sy = ly; } else if (jy < 0) { jy += ny; sy = -ly; }
    if (jz >= nz) { jz -= nz; sz = lz; } else if (jz < 0) { jz += nz; sz = -lz; }
    const T* src = pos + (static_cast<size_t>(jy) * nz + jz) * R * 3;
    for (int k = threadIdx.x; k < R; k += blockDim.x) {
      cx[b * R + k] = src[3 * k];
      cy[b * R + k] = src[3 * k + 1] + sy;
      cz[b * R + k] = src[3 * k + 2] + sz;
    }
  }
  __syncthreads();

  const int n_cand = 9 * R;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    const T ox = cx[4 * R + i];  // own row = centre block, unshifted
    const T oy = cy[4 * R + i];
    const T oz = cz[4 * R + i];
    T fx = T(0), fy = T(0), fz = T(0);
    for (int j = 0; j < n_cand; ++j) {
      T dx = cx[j] - ox;
      dx = fma_(-lx, rint_(dx * inv_lx), dx);
      const T dy = cy[j] - oy;
      const T dz = cz[j] - oz;
      const T r2 = fmax(fma_(dz, dz, fma_(dy, dy, dx * dx)), T(1e-24));
      const T rinv = rsqrt_(r2);
      const T delta = fmax(fma_(-r2, rinv, two_r), T(0));  // 2r - |d|
      const T w = -(coef * delta * sqrt_(delta)) * rinv;
      fx = fma_(w, dx, fx);
      fy = fma_(w, dy, fy);
      fz = fma_(w, dz, fz);
    }
    T* o = out + (static_cast<size_t>(row) * R + i) * 3;
    o[0] = fx;
    o[1] = fy;
    o[2] = fz;
  }
}

template <typename T>
int launch(const void* pos, void* out, int ny, int nz, int R, double lx,
           double ly, double lz, double two_r, double coef, void* stream) {
  const int threads = R >= 256 ? 256 : ((R + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(27) * R * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_hertz_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_hertz_kernel<T><<<ny * nz, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<T*>(out), ny, nz, R, T(lx),
      T(1.0 / lx), T(ly), T(lz), T(two_r), T(coef));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int row_hertzian_forces_f32(const void* pos, void* out, int ny, int nz, int R,
                            double lx, double ly, double lz, double two_r,
                            double coef, void* stream) {
  return launch<float>(pos, out, ny, nz, R, lx, ly, lz, two_r, coef, stream);
}

int row_hertzian_forces_f64(const void* pos, void* out, int ny, int nz, int R,
                            double lx, double ly, double lz, double two_r,
                            double coef, void* stream) {
  return launch<double>(pos, out, ny, nz, R, lx, ly, lz, two_r, coef, stream);
}

}  // extern "C"
