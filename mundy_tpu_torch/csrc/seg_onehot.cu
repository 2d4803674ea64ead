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
// Design. The strided layout the LCP line builds
// (constraints/collision.active_pair_subset_strided) fills block b's slots
// in cumsum order over the ordered pair list, which is sorted by body, and
// pads the rest with id N, past every valid id of the block: each block's
// loc is nondecreasing, so each segment's slots are one contiguous run. One
// block per body block, 256 threads:
//   * one pass over adjacent slot pairs and __syncthreads_or find whether
//     loc is nondecreasing over the whole window (ids compared as raw ints,
//     out-of-range and negative ones included);
//   * sorted block: in passes of 1024 segments, the first and last slot of
//     each run are marked in shared memory (a run starts where loc changes,
//     so one slot writes each bound and no atomics are needed); then one
//     thread per segment adds its run's values, read from device memory, in
//     increasing slot order from +0, and writes +0 for a segment with no
//     slot. Ids outside [0, B) have no thread and are dropped;
//   * unsorted block (any loc; the TPU kernel's contract does not promise
//     sorted ids): the first design's scan, in the same kernel. Loc and the
//     three value planes are staged in tiles of 512 slots, and every thread
//     walks each tile and adds the values whose id is its own segment's.
// Both paths add each segment's values in slot order from +0, the order
// of the plain version, so the two agree bit for bit, with no atomics.
// At the LCP line's shape (977 blocks) all blocks are resident at once
// (8 blocks of 256 threads on each of 132 SMs), so no block takes more
// than one body block.
//
// Dropped from the TPU kernel: the (W, B) bf16 one-hot in VMEM and the
// hi/mid/lo three-term bf16 split that carried the f32 mantissa through the
// MXU. Here the sum is direct in float32 (float64 in the f64 instantiation).
//
// Bound: the bytes, ~16 W + 12 B per block in float32 (read loc and the
// values once, write the sums once: ~22 MB at 1M bodies, ~7 us at 3.35
// TB/s); 3 adds per active pair are far less. The sorted path reads loc
// twice (the second time from L1) and each value once; the first design
// spent W compares per segment (W * B per block, ~0.64G at 1M), which the
// unsorted path still does.
//
// K3t replaces mundy_tpu/ops/pallas/seg_onehot.py (strided_onehot_t /
// _t_kernel) and keeps its contract: gamma (nb, W), normals (nb, 3, W), loc
// (nb, W) int32 ->
//   t[b, w] = -(n_w . F[loc_w]),  F[s] = sum over w' with loc_w' == s of
//   -gamma_w' n_w',
// both within body block b; a slot whose id lies outside [0, B) gets t = 0.
// One block of 256 threads per body block, in two phases:
//   * phase 1 is K3's sum of (-gamma) n (the same device helpers,
//     seg_sum_runs and seg_sum_scan, over a loader that reads (-gamma) n
//     where K3's reads its value planes), each product rounded on its own,
//     each segment summed in increasing slot order from +0, into F's (3, B)
//     array in shared memory (12 KB at B = 1024 in float32), by K3's two
//     paths: __syncthreads_or finds whether the block's loc is
//     nondecreasing; a sorted block marks its runs' bounds in passes of 1024
//     segments (8 KB) and sums each run with one thread per segment, reading
//     gamma and n from device memory; any other block takes the first
//     design's scan, staging loc and (-gamma) n in tiles of 512 (float32) or
//     256 (float64) slots in the same 8 KB, so the bits never depend on the
//     premise. The strided layout of the LCP line is sorted in every block
//     (see K3 above);
//   * after a block sync, phase 2 gives each slot one thread that reads
//     F[loc] from shared memory and writes t = -((nx Fx + ny Fy) + nz Fz),
//     every product and sum rounded on its own (-fmad=false).
// The plain version (ops/kernels/seg_onehot.strided_t_plain) adds and
// multiplies in that order, so the two agree bit for bit. No global gather
// of F, no atomics, one launch. Dropped from the TPU kernel: the two bf16
// one-hot matmul families with their hi/mid/lo splits and the VMEM budget
// check.
//
// Bound: 24 W bytes per block in float32 (read gamma, normals, loc once,
// write t once: ~15 MB at 1M bodies, ~5 us at 3.35 TB/s). The sorted path
// reads loc three times (twice from L1) and gamma and n once each; the
// first design scanned W * B compares per block on every block, which only
// an unsorted block still does.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kSegThreads = 256;
constexpr int kScanTile = 512;   // slots per tile of the unsorted path
constexpr int kRunPass = 1024;   // segments per pass of the sorted path

// A slot's three values, read from device memory: K3's value planes as
// they are, K3t's (-gamma) n with each product rounded on its own.
template <typename T>
struct PlaneValues {
  const T* __restrict__ v;  // (3, W)
  int W;
  __device__ void operator()(int w, T& x, T& y, T& z) const {
    x = v[w];
    y = v[W + w];
    z = v[2 * W + w];
  }
};

template <typename T>
struct DragValues {
  const T* __restrict__ gamma;  // (W,)
  const T* __restrict__ n;      // (3, W)
  int W;
  __device__ void operator()(int w, T& x, T& y, T& z) const {
    const T ng = -gamma[w];
    x = ng * n[w];
    y = ng * n[W + w];
    z = ng * n[2 * W + w];
  }
};

// Whether any adjacent pair of the block's loc decreases (every thread
// gets the answer; a block sync).
__device__ bool block_unsorted(const int* __restrict__ lrow, int W) {
  int down = 0;
  for (int w = threadIdx.x + 1; w < W; w += blockDim.x) down |= lrow[w - 1] > lrow[w];
  return __syncthreads_or(down);
}

// The unsorted path: the first design's scan over tiles of TW slots staged
// in sloc and sv (3, TW), each segment's sum in slot order from +0, written
// to out's (3, B) array.
template <int TW, typename T, typename Load>
__device__ void seg_sum_scan(Load load, const int* __restrict__ lrow, T* __restrict__ out,
                             int W, int B, int* sloc, T* sv) {
  for (int s0 = 0; s0 < B; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    T ax = T(0), ay = T(0), az = T(0);
    for (int w0 = 0; w0 < W; w0 += TW) {
      const int tw = W - w0 < TW ? W - w0 : TW;
      __syncthreads();  // the previous tile is consumed
      for (int k = threadIdx.x; k < tw; k += blockDim.x) {
        sloc[k] = lrow[w0 + k];
        load(w0 + k, sv[k], sv[TW + k], sv[2 * TW + k]);
      }
      __syncthreads();
      if (s < B) {
        for (int k = 0; k < tw; ++k) {
          if (sloc[k] == s) {
            ax += sv[k];
            ay += sv[TW + k];
            az += sv[2 * TW + k];
          }
        }
      }
    }
    if (s < B) {
      out[s] = ax;
      out[B + s] = ay;
      out[2 * B + s] = az;
    }
  }
}

// The sorted path: each segment's slots are one run; mark the runs' bounds
// in passes of kRunPass segments (run_lo, run_hi), then one thread per
// segment sums its run in slot order from +0 into out's (3, B) array.
template <typename T, typename Load>
__device__ void seg_sum_runs(Load load, const int* __restrict__ lrow, T* __restrict__ out,
                             int W, int B, int* run_lo, int* run_hi) {
  for (int s0 = 0; s0 < B; s0 += kRunPass) {
    const int ns = B - s0 < kRunPass ? B - s0 : kRunPass;
    __syncthreads();  // the previous pass's bounds are consumed
    for (int s = threadIdx.x; s < ns; s += blockDim.x) {
      run_lo[s] = 0;
      run_hi[s] = 0;
    }
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const int l = lrow[w];
      if (l >= s0 && l < s0 + ns) {
        if (w == 0 || lrow[w - 1] != l) run_lo[l - s0] = w;
        if (w == W - 1 || lrow[w + 1] != l) run_hi[l - s0] = w + 1;
      }
    }
    __syncthreads();
    for (int s = threadIdx.x; s < ns; s += blockDim.x) {
      T ax = T(0), ay = T(0), az = T(0);
      const int hi = run_hi[s];
      for (int w = run_lo[s]; w < hi; ++w) {
        T x, y, z;
        load(w, x, y, z);
        ax += x;
        ay += y;
        az += z;
      }
      out[s0 + s] = ax;
      out[B + s0 + s] = ay;
      out[2 * B + s0 + s] = az;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSegThreads)
seg_sum_kernel(const T* __restrict__ values, const int* __restrict__ loc,
               T* __restrict__ out, int W, int B) {
  // The two paths never meet in one block, so they share one buffer: the
  // unsorted path's tile (loc and three value planes) or the sorted path's
  // run bounds.
  constexpr int kScanBytes = kScanTile * static_cast<int>(sizeof(int) + 3 * sizeof(T));
  constexpr int kRunBytes = 2 * kRunPass * static_cast<int>(sizeof(int));
  __shared__ __align__(16) unsigned char smem[kScanBytes > kRunBytes ? kScanBytes : kRunBytes];
  const int b = blockIdx.x;
  const int* lrow = loc + static_cast<size_t>(b) * W;
  const PlaneValues<T> load{values + static_cast<size_t>(b) * 3 * W, W};
  T* orow = out + static_cast<size_t>(b) * 3 * B;
  int* buf = reinterpret_cast<int*>(smem);
  if (block_unsorted(lrow, W)) {
    seg_sum_scan<kScanTile>(load, lrow, orow, W, B, buf,
                            reinterpret_cast<T*>(buf + kScanTile));
  } else {
    seg_sum_runs(load, lrow, orow, W, B, buf, buf + kRunPass);
  }
}

// K3t's scan tile (its unsorted path): loc and three value planes of
// TScan<T>::W slots fill the 8 KB that the sorted path spends on its run
// bounds.
template <typename T>
struct TScan {
  static constexpr int W = sizeof(T) == 4 ? 512 : 256;
};
constexpr int kTScratch = 2 * kRunPass * static_cast<int>(sizeof(int));
static_assert(TScan<float>::W * (sizeof(int) + 3 * sizeof(float)) <= kTScratch, "tile");
static_assert(TScan<double>::W * (sizeof(int) + 3 * sizeof(double)) <= kTScratch, "tile");

template <typename T>
__global__ void __launch_bounds__(kSegThreads)
strided_t_kernel(const T* __restrict__ gamma, const T* __restrict__ normals,
                 const int* __restrict__ loc, T* __restrict__ t_out, int W, int B) {
  // dynamic shared memory: kTScratch bytes of run bounds or scan tile, then
  // F's (3, B) array
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* F = reinterpret_cast<T*>(smem_raw + kTScratch);
  const int b = blockIdx.x;
  const int* lrow = loc + static_cast<size_t>(b) * W;
  const T* nrow = normals + static_cast<size_t>(b) * 3 * W;
  const DragValues<T> load{gamma + static_cast<size_t>(b) * W, nrow, W};
  T* trow = t_out + static_cast<size_t>(b) * W;

  // phase 1: F[s] = sum of (-gamma) n over the slots of segment s, in slot
  // order from +0, by K3's two paths
  int* buf = reinterpret_cast<int*>(smem_raw);
  constexpr int TW = TScan<T>::W;
  if (block_unsorted(lrow, W)) {
    seg_sum_scan<TW>(load, lrow, F, W, B, buf, reinterpret_cast<T*>(buf + TW));
  } else {
    seg_sum_runs(load, lrow, F, W, B, buf, buf + kRunPass);
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
  const size_t smem = kTScratch + static_cast<size_t>(3) * B * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        strided_t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  strided_t_kernel<T><<<nb, kSegThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gamma), static_cast<const T*>(normals),
      static_cast<const int*>(loc), static_cast<T*>(t), W, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* values, const void* loc, void* out, int nb, int W, int B,
           void* stream) {
  seg_sum_kernel<T><<<nb, kSegThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
