// Strided-block segmented sum (kernel K3) and the fused i-side Delassus
// half-apply built on it (kernel K3t).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/seg_onehot.py
// (strided_onehot_segment_sum / _kernel) and keeps its contract:
//   out[b, c, s] = sum over w with loc[b, w] == s of values[b, c, w],
// values (nb, 3, W), loc (nb, W) int32, out (nb, 3, B); ids outside [0, B)
// are dropped, so pad values need not be zero. Each sum runs over w in
// increasing order from zero, exactly as the plain version
// (ops/kernels/seg_onehot.strided_segment_sum_plain) adds, so the two agree
// bit for bit.
//
// Design. One thread block per body block b, one thread per local segment s
// (looping over segment groups when B > blockDim). The block stages loc and
// the three value planes of a W tile in shared memory (2048 slots = 32 KB
// in float32, 1024 = 28 KB in float64); every thread then walks the tile,
// each loc read a shared-memory broadcast, and adds the values whose id is
// its own. Right for any loc, sorted or not (the TPU kernel's contract does
// not promise sorted ids), deterministic, and free of atomics.
//
// Dropped from the TPU kernel: the (W, B) bf16 one-hot in VMEM and the
// hi/mid/lo three-term bf16 split that carried the f32 mantissa through the
// MXU. Here the sum is direct in float32 (float64 in the f64 instantiation).
//
// Bound: the bytes are ~16 W + 12 B per block (~22 MB at 1M bodies, ~7 us
// at 3.35 TB/s), but the design spends W compares per segment (W * B per
// block, ~0.64G at 1M), so integer compare issue bounds it, not bytes.
//
// K3t replaces mundy_tpu/ops/pallas/seg_onehot.py (strided_onehot_t /
// _t_kernel) and keeps its contract: gamma (nb, W), normals (nb, 3, W), loc
// (nb, W) int32 ->
//   t[b, w] = -(n_w . F[loc_w]),  F[s] = sum over w' with loc_w' == s of
//   -gamma_w' n_w',
// both within body block b; a slot whose id lies outside [0, B) gets t = 0.
// One block per body block. Phase 1 is K3's per-segment sum of -gamma n
// (each value rounded as (-gamma) * n, each sum in increasing slot order
// from zero) into a (3, B) array in shared memory (12 KB at B = 1024 in
// float32); after a block sync, phase 2 gives each slot one thread that
// reads F[loc] from shared memory and writes t = -((nx Fx + ny Fy) + nz Fz),
// every product and sum rounded on its own (-fmad=false). The plain version
// (ops/kernels/seg_onehot.strided_t_plain) adds and multiplies in that
// order, so the two agree bit for bit. No global gather of F, no atomics,
// one launch. Dropped from the TPU kernel: the two bf16 one-hot matmul
// families with their hi/mid/lo splits and the VMEM budget check.
//
// Bound: 24 W bytes per block in float32 (read gamma, normals, loc once,
// write t once: ~15 MB at 1M bodies, ~5 us), but phase 1 spends K3's W * B
// compares per block, so, as for K3, compare issue bounds it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

template <typename T>
struct Tile {
  static constexpr int W = sizeof(T) == 4 ? 2048 : 1024;
};

template <typename T>
__global__ void seg_sum_kernel(const T* __restrict__ values,
                               const int* __restrict__ loc,
                               T* __restrict__ out, int W, int B) {
  constexpr int TW = Tile<T>::W;
  __shared__ int sloc[TW];
  __shared__ T sv[3][TW];
  const int b = blockIdx.x;
  const int* lrow = loc + static_cast<size_t>(b) * W;
  const T* vrow = values + static_cast<size_t>(b) * 3 * W;
  T* orow = out + static_cast<size_t>(b) * 3 * B;

  for (int s0 = 0; s0 < B; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    T ax = T(0), ay = T(0), az = T(0);
    for (int w0 = 0; w0 < W; w0 += TW) {
      const int tw = W - w0 < TW ? W - w0 : TW;
      __syncthreads();  // the previous tile is consumed
      for (int k = threadIdx.x; k < tw; k += blockDim.x) {
        sloc[k] = lrow[w0 + k];
        sv[0][k] = vrow[w0 + k];
        sv[1][k] = vrow[W + w0 + k];
        sv[2][k] = vrow[2 * W + w0 + k];
      }
      __syncthreads();
      if (s < B) {
        for (int k = 0; k < tw; ++k) {
          if (sloc[k] == s) {
            ax += sv[0][k];
            ay += sv[1][k];
            az += sv[2][k];
          }
        }
      }
    }
    if (s < B) {
      orow[s] = ax;
      orow[B + s] = ay;
      orow[2 * B + s] = az;
    }
  }
}

// K3t's slot tiles: with F's (3, B) array beside them (12 KB in float32,
// 24 KB in float64 at B = 1024) the block stays within the 48 KB every
// block gets.
template <typename T>
struct TTile {
  static constexpr int W = sizeof(T) == 4 ? 2048 : 512;
};

template <typename T>
__global__ void strided_t_kernel(const T* __restrict__ gamma,
                                 const T* __restrict__ normals,
                                 const int* __restrict__ loc,
                                 T* __restrict__ t_out, int W, int B) {
  constexpr int TW = TTile<T>::W;
  __shared__ int sloc[TW];
  __shared__ T sv[3][TW];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* F = reinterpret_cast<T*>(smem_raw);  // (3, B)
  const int b = blockIdx.x;
  const int* lrow = loc + static_cast<size_t>(b) * W;
  const T* grow = gamma + static_cast<size_t>(b) * W;
  const T* nrow = normals + static_cast<size_t>(b) * 3 * W;
  T* trow = t_out + static_cast<size_t>(b) * W;

  // phase 1: F[s] = sum of -gamma n over the slots of segment s, in slot order
  for (int s0 = 0; s0 < B; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    T ax = T(0), ay = T(0), az = T(0);
    for (int w0 = 0; w0 < W; w0 += TW) {
      const int tw = W - w0 < TW ? W - w0 : TW;
      __syncthreads();  // the previous tile is consumed
      for (int k = threadIdx.x; k < tw; k += blockDim.x) {
        const T ng = -grow[w0 + k];
        sloc[k] = lrow[w0 + k];
        sv[0][k] = ng * nrow[w0 + k];
        sv[1][k] = ng * nrow[W + w0 + k];
        sv[2][k] = ng * nrow[2 * W + w0 + k];
      }
      __syncthreads();
      if (s < B) {
        for (int k = 0; k < tw; ++k) {
          if (sloc[k] == s) {
            ax += sv[0][k];
            ay += sv[1][k];
            az += sv[2][k];
          }
        }
      }
    }
    if (s < B) {
      F[s] = ax;
      F[B + s] = ay;
      F[2 * B + s] = az;
    }
  }
  __syncthreads();

  // phase 2: one thread per slot, t = -(n . F[loc]) from shared memory
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int l = lrow[w];
    T t = T(0);
    if (l >= 0 && l < B) {
      t = -((nrow[w] * F[l] + nrow[W + w] * F[B + l]) + nrow[2 * W + w] * F[2 * B + l]);
    }
    trow[w] = t;
  }
}

template <typename T>
int launch_t(const void* gamma, const void* normals, const void* loc, void* t,
             int nb, int W, int B, void* stream) {
  const int threads = B >= 1024 ? 1024 : ((B + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(3) * B * sizeof(T);
  const size_t smem_static = static_cast<size_t>(TTile<T>::W) * (sizeof(int) + 3 * sizeof(T));
  if (smem + smem_static > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        strided_t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  strided_t_kernel<T><<<nb, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gamma), static_cast<const T*>(normals),
      static_cast<const int*>(loc), static_cast<T*>(t), W, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* values, const void* loc, void* out, int nb, int W, int B,
           void* stream) {
  const int threads = B >= 1024 ? 1024 : ((B + 31) / 32) * 32;
  seg_sum_kernel<T><<<nb, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int*>(loc),
      static_cast<T*>(out), W, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int strided_segment_sum_f32(const void* values, const void* loc, void* out,
                            int nb, int W, int B, void* stream) {
  return launch<float>(values, loc, out, nb, W, B, stream);
}

int strided_segment_sum_f64(const void* values, const void* loc, void* out,
                            int nb, int W, int B, void* stream) {
  return launch<double>(values, loc, out, nb, W, B, stream);
}

int strided_t_f32(const void* gamma, const void* normals, const void* loc,
                  void* t, int nb, int W, int B, void* stream) {
  return launch_t<float>(gamma, normals, loc, t, nb, W, B, stream);
}

int strided_t_f64(const void* gamma, const void* normals, const void* loc,
                  void* t, int nb, int W, int B, void* stream) {
  return launch_t<double>(gamma, normals, loc, t, nb, W, B, stream);
}

}  // extern "C"
