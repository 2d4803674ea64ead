// K nearest in-cutoff neighbors per row slot (kernel K2).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/row_extract.py
// (row_neighbor_extract / _extract_kernel) and computes what its plain
// version, the XLA extraction branch of neighbor_matrix_rows, computes:
//   * input: (ny, nz, R, 3) positions, (ny, nz, R) int32 gids and bool
//     validity from build_rows; invalid slots hold a sentinel far outside
//     the box, so no candidate-side mask is read;
//   * candidate rows (y+dy, z+dz) are pre-shifted to the periodic image
//     nearest the own row (rows._candidate_planes), so a pair needs a minimum
//     image along x only: dx -= lx * rint(dx * (1/lx));
//   * r2 = (dx*dx + dy*dy) + dz*dz, every product and sum rounded on its own
//     (the kernels build with -fmad=false, ops/kernels/_build.py: no
//     contraction into FMA), exactly as the plain version's separate
//     elementwise passes round them;
//   * a hit is r2 < cut2 with a different gid; a slot keeps its K nearest
//     hits ordered by (r2, candidate lane), argmin's first-index rule, and
//     counts all hits. Output: ids (ny, nz, R, K) int32 padded with n, count
//     (ny, nz, R) int32; invalid own slots get all-n ids and count 0.
// With that, ids, order and counts are bit-equal to the plain version.
// The radius variant (the polydisperse broad phase, kRadii) takes a
// (ny, nz, R) search-radius plane as well, stages it beside the positions,
// and tests r2 < (s_own + s_cand) * (s_own + s_cand) in place of cut2, as
// the plain version computes it; ties and order are unchanged.
//
// Design. One thread block per (iy, iz) row. The block stages its 9
// candidate rows, image-shifted, as structure-of-arrays planes plus their
// gids in shared memory (9R * 16 B = 13.8 KB in float32 at R = 96, the 1M
// LCP shape; 9R * 20 B with the radius plane); one thread owns one slot
// (looping when R > blockDim) and scans all 9R candidates, every read a
// shared-memory broadcast. Its top-K list is an insertion-sorted array in
// local memory: the scan visits lanes in increasing order, so a new hit
// goes after every kept hit of equal r2, and a full list rejects r2 >= its
// worst at once. Hits are ~7 per slot at the 1M shape, so insertion costs
// little next to the 9R distances.
//
// Dropped from the TPU kernel, because they exist only for the TPU: the
// nz % 8 requirement, the VMEM z-chunk planner, the unrolled own-slot
// chunks, the K select-reduce passes over resident (R, 9R) blocks and the
// lane-id mantissa clobber that broke ties there (order at near-ties now
// follows the plain version exactly), and the (K, R) sublane output layout.
//
// Bound: about 11 FP32 operations per candidate distance (9R per own
// slot) and almost no memory traffic (read the rows once, write K ids per
// slot), so FP32 issue bounds it, not bytes.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }

template <typename T, int KMAX, bool kRadii>
__global__ void row_extract_kernel(const T* __restrict__ pos,
                                   const int* __restrict__ gid,
                                   const bool* __restrict__ valid,
                                   const T* __restrict__ srad,
                                   int* __restrict__ ids_out,
                                   int* __restrict__ cnt_out, int ny, int nz,
                                   int R, int K, int n, T lx, T inv_lx, T ly,
                                   T lz, T cut2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cx = reinterpret_cast<T*>(smem_raw);
  T* cy = cx + 9 * R;
  T* cz = cy + 9 * R;
  T* cs = cz + 9 * R;  // search radii, staged in the radius variant only
  int* cg = reinterpret_cast<int*>(cs + (kRadii ? 9 * R : 0));

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;

  // Stage the 9 candidate rows; block b = (dy + 1) * 3 + (dz + 1), the order
  // of rows._candidate_planes.
  for (int b = 0; b < 9; ++b) {
    int jy = iy + b / 3 - 1;
    int jz = iz + b % 3 - 1;
    T sy = T(0), sz = T(0);
    if (jy >= ny) { jy -= ny; sy = ly; } else if (jy < 0) { jy += ny; sy = -ly; }
    if (jz >= nz) { jz -= nz; sz = lz; } else if (jz < 0) { jz += nz; sz = -lz; }
    const size_t base = static_cast<size_t>(jy) * nz + jz;
    const T* src = pos + base * R * 3;
    const int* gsrc = gid + base * R;
    for (int k = threadIdx.x; k < R; k += blockDim.x) {
      cx[b * R + k] = src[3 * k];
      cy[b * R + k] = src[3 * k + 1] + sy;
      cz[b * R + k] = src[3 * k + 2] + sz;
      cg[b * R + k] = gsrc[k];
      if constexpr (kRadii) cs[b * R + k] = srad[base * R + k];
    }
  }
  __syncthreads();

  const int n_cand = 9 * R;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    const size_t slot = static_cast<size_t>(row) * R + i;
    int* ids = ids_out + slot * K;
    if (!valid[slot]) {
      for (int k = 0; k < K; ++k) ids[k] = n;
      cnt_out[slot] = 0;
      continue;
    }
    const T ox = cx[4 * R + i];  // own row = centre block, unshifted
    const T oy = cy[4 * R + i];
    const T oz = cz[4 * R + i];
    const int og = cg[4 * R + i];
    const T os = kRadii ? cs[4 * R + i] : T(0);
    T best_r2[KMAX];
    int best_lane[KMAX];
    int kept = 0, count = 0;
    for (int j = 0; j < n_cand; ++j) {
      T dx = cx[j] - ox;
      dx = dx - lx * rint_(dx * inv_lx);
      const T dy = cy[j] - oy;
      const T dz = cz[j] - oz;
      const T r2 = (dx * dx + dy * dy) + dz * dz;
      T pair_cut2 = cut2;
      if constexpr (kRadii) {
        const T cut = os + cs[j];
        pair_cut2 = cut * cut;
      }
      if (!(r2 < pair_cut2) || cg[j] == og) continue;
      ++count;
      if (kept == K && !(r2 < best_r2[K - 1])) continue;
      int p = kept < K ? kept++ : K - 1;  // a full list drops its worst
      while (p > 0 && best_r2[p - 1] > r2) {
        best_r2[p] = best_r2[p - 1];
        best_lane[p] = best_lane[p - 1];
        --p;
      }
      best_r2[p] = r2;
      best_lane[p] = j;
    }
    for (int k = 0; k < K; ++k) ids[k] = k < kept ? cg[best_lane[k]] : n;
    cnt_out[slot] = count;
  }
}

template <typename T, int KMAX, bool kRadii>
int launch_k(const void* pos, const void* gid, const void* valid,
             const void* srad, void* ids, void* cnt, int ny, int nz, int R,
             int K, int n, double lx, double ly, double lz, double cut2,
             void* stream) {
  const int threads = R >= 256 ? 256 : ((R + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(9) * R *
                      ((kRadii ? 4 : 3) * sizeof(T) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_extract_kernel<T, KMAX, kRadii>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  row_extract_kernel<T, KMAX, kRadii><<<ny * nz, threads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const int*>(gid),
      static_cast<const bool*>(valid), static_cast<const T*>(srad),
      static_cast<int*>(ids), static_cast<int*>(cnt), ny, nz, R, K, n, T(lx),
      T(1.0 / lx), T(ly), T(lz), T(cut2));
  return static_cast<int>(cudaGetLastError());
}

// K is a runtime argument; the list lives in a local array sized by the
// smallest bucket that holds it. Regrow raises K = min(max_neighbors,
// rows_k) geometrically; from the defaults (32, 20) it stays <= 512 through
// six regrows, and a larger K is refused.
template <typename T, bool kRadii>
int launch(const void* pos, const void* gid, const void* valid,
           const void* srad, void* ids, void* cnt, int ny, int nz, int R,
           int K, int n, double lx, double ly, double lz, double cut2,
           void* stream) {
#define ROW_EXTRACT_BUCKET(KB)                                                \
  if (K <= KB)                                                                \
    return launch_k<T, KB, kRadii>(pos, gid, valid, srad, ids, cnt, ny, nz, R, \
                                   K, n, lx, ly, lz, cut2, stream);
  ROW_EXTRACT_BUCKET(16)
  ROW_EXTRACT_BUCKET(32)
  ROW_EXTRACT_BUCKET(64)
  ROW_EXTRACT_BUCKET(128)
  ROW_EXTRACT_BUCKET(256)
  ROW_EXTRACT_BUCKET(512)
#undef ROW_EXTRACT_BUCKET
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int row_neighbor_extract_f32(const void* pos, const void* gid, const void* valid,
                             void* ids, void* cnt, int ny, int nz, int R, int K,
                             int n, double lx, double ly, double lz,
                             double cut2, void* stream) {
  return launch<float, false>(pos, gid, valid, nullptr, ids, cnt, ny, nz, R, K,
                              n, lx, ly, lz, cut2, stream);
}

int row_neighbor_extract_f64(const void* pos, const void* gid, const void* valid,
                             void* ids, void* cnt, int ny, int nz, int R, int K,
                             int n, double lx, double ly, double lz,
                             double cut2, void* stream) {
  return launch<double, false>(pos, gid, valid, nullptr, ids, cnt, ny, nz, R, K,
                               n, lx, ly, lz, cut2, stream);
}

// The radius variant: srad is the (ny, nz, R) search-radius plane in the
// positions' dtype; cut2 is not read.
int row_neighbor_extract_radii_f32(const void* pos, const void* gid,
                                   const void* valid, const void* srad,
                                   void* ids, void* cnt, int ny, int nz, int R,
                                   int K, int n, double lx, double ly,
                                   double lz, double cut2, void* stream) {
  return launch<float, true>(pos, gid, valid, srad, ids, cnt, ny, nz, R, K, n,
                             lx, ly, lz, cut2, stream);
}

int row_neighbor_extract_radii_f64(const void* pos, const void* gid,
                                   const void* valid, const void* srad,
                                   void* ids, void* cnt, int ny, int nz, int R,
                                   int K, int n, double lx, double ly,
                                   double lz, double cut2, void* stream) {
  return launch<double, true>(pos, gid, valid, srad, ids, cnt, ny, nz, R, K, n,
                              lx, ly, lz, cut2, stream);
}

}  // extern "C"
