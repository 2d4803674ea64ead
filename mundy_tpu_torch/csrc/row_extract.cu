// K nearest in-cutoff neighbors per row slot (kernel K2).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/row_extract.py
// (row_neighbor_extract / _extract_kernel) and computes what its plain
// version, the XLA extraction branch of neighbor_matrix_rows, computes:
//   * input: (ny, nz, R, 3) positions, (ny, nz, R) int32 gids and bool
//     validity from build_rows; invalid slots hold a sentinel far outside
//     the box, so an invalid candidate is never a hit (the plain version
//     reads no candidate-side mask);
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
// Design. The first design gave every slot of a row one thread and
// scanned all 9R staged candidates, padding included (1.47 ms at config
// #2's 1M spheres: 144 x 144 rows of R = 104 over lx = 219, where a sphere
// has ~430 occupied candidates and ~6 within the cut (1.45) in x).
// This design visits those and little else; one block of 128 threads per
// (iy, iz) row:
//   * padding: a warp per staged row packs that row's occupied slots, in
//     slot order, into shared memory by ballot (x, y, z image-shifted as
//     rows._candidate_planes shifts them, the search radius in the radius
//     variant, and the slot's index in its row), so only occupied slots are
//     own slots or candidates. An invalid slot holds build_rows' sentinel,
//     ~1e6 box heights away, so it was never a hit;
//   * lanes per own slot: L = 8 lanes (a group) share one own slot, and a
//     warp serves G = 4 neighbouring own slots (neighbours in x since the
//     last sort) at a time. A chunk is L packed slots, one per lane of a
//     group;
//   * chunk x-window: per chunk the least and greatest x (and in the radius
//     variant the greatest |search radius|), taken from the current
//     positions, so rows that drifted out of their x order since the last
//     sort stay exact. The warp's lanes test 32 chunks at a time against
//     the interval [p, q] of its own slots' x (chunk_visit), and the warp
//     visits the chunks whose x range, under the minimum image the pairs
//     take, can come within the cut in x of that interval. Every loop is
//     uniform across the warp: groups that each ran their own windows
//     would diverge and run one after another (in trials on the card at
//     config #2's shape, per-group tests of L chunks at a time, diverged or
//     in lockstep, took about twice as long);
//   * order: a visited chunk's lanes evaluate one candidate each; a lane
//     whose r2 passes the cut, other than the own slot itself, reads the
//     candidate's gid (from device memory, by its slot index: gids are not
//     staged) and compares it with the own gid, and the hits are
//     found by ballot. Each group counts its own, and its first lane inserts
//     them one by one in candidate order (shuffled from the lane that holds
//     each) into its sorted top-K list, an array in local memory: a new hit
//     goes after every kept hit of equal r2, and a full list rejects r2 >=
//     its worst at once.
// Each group meets its candidates in the first design's order, candidate
// rows b = 0..8 and slots in order, with only chunks left out that hold no
// hit for any own slot of the warp (a visited chunk beyond one group's
// reach finds no hit for it: the pair test decides); the top-K list is the
// K smallest hits by (r2, candidate lane) and the count is that of all
// hits, so ids, order and counts are bit for bit the first design's and
// the plain version's, and two launches are bit-equal (no atomics).
// Every own slot writes its K ids and its count; an invalid one n and 0.
//
// Why a skipped chunk holds no hit. A pair's x separation is RN(d -
// RN(lx k)) with d = RN(x - ox) and k = rint(RN(d inv_lx)), every
// operation rounded on its own (the kernels build with -fmad=false): d is
// monotonic in x, k is monotonic in d and, for one k, the separation is
// monotonic in d. So for a chunk whose slots have x in [a, b] and own
// slots with x in [p, q], every d lies in [RN(a - q), RN(b - p)] (rounding
// is monotonic in each operand); every pair of image ka = k(RN(a - q)) has
// separation >= sa, the value chunk_visit takes from RN(a - q) by the same
// operations, and every pair of image kb = k(RN(b - p)) has separation <=
// sb, taken from RN(b - p). When kb is ka, or the next value above ka (kb
// == RN(ka + 1): no k lies between), every pair has |dx| >= m, m as
// chunk_visit takes it; more images than two are always visited. Then r2 =
// RN(RN(RN(dx^2) + RN(dy^2)) + RN(dz^2)) >= RN(dx^2) >= RN(m^2), since
// rounding is monotonic and the terms are not negative. A hit needs r2 <
// cut2; in the radius variant r2 < RN(c^2) with c = RN(s_own + s_cand),
// and |c| <= C = RN(S + M) for S >= |s_own| over the warp's own slots and
// M >= |s_cand| over the chunk, so RN(c^2) <= RN(C^2). A chunk with
// !(RN(m^2) < cut2), or RN(C^2) in the radius variant, holds no hit: the
// skip is exact, with no margin. The bounds a, b and M are kept as floats, rounded outward in
// float64 (a <= every x, b >= every x, M >= every |s|), which the argument
// allows: they need not be attained. The CPU tests hold the plain version
// to no hit in any chunk that ops/kernels/row_extract.chunk_visit (this
// test, operation for operation) rejects.
//
// Dropped from the TPU kernel, because they exist only for the TPU: the
// nz % 8 requirement, the VMEM z-chunk planner, the unrolled own-slot
// chunks, the K select-reduce passes over resident (R, 9R) blocks and the
// lane-id mantissa clobber that broke ties there (order at near-ties now
// follows the plain version exactly), and the (K, R) sublane output layout.
//
// Bound. Counted from the algorithm (chip_smoke.py [7] and [27]): 13 FP32
// operations per ordered pair of occupied slots within the cut in x (the
// x image 5, dy and dz 2, r2 5, the cut test), 15 with the per-pair cut
// of the radius variant: ~0.0001 ms at config #2, so the bytes bound it:
// the valid byte and the K ids and count of every slot, the position and
// gid (and search radius) of each occupied slot (~131 MB, ~0.039 ms at
// 3.35 TB/s). What the design does beyond that: each row is staged 9 times
// (once per neighbouring block, from L2), every pair is evaluated from both
// sides, a visited chunk costs 32 lanes (4 own slots x 8 candidates) for
// its few pairs within the cut, and each slot's K ids are written by one
// lane.
//
// Shared memory: 9 R (3 itemsize + 2) + 72 ceil(R / 8) + 72 bytes per
// block, 9 R (4 itemsize + 2) + 108 ceil(R / 8) + 72 in the radius variant
// (ops/kernels/row_extract.shared_bytes; the first design's 9 R (3
// itemsize + 4) and 9 R (4 itemsize + 4)): the largest R on an H100 is 1679
// in float32 and 943 in float64, 1298 and 719 with radii (was 1614, 922,
// 1291 and 717).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }
// Chunk bounds are floats in both dtypes, rounded outward from float64.
__device__ __forceinline__ float down_(float x) { return x; }
__device__ __forceinline__ float down_(double x) { return __double2float_rd(x); }
__device__ __forceinline__ float up_(float x) { return x; }
__device__ __forceinline__ float up_(double x) { return __double2float_ru(x); }
template <typename T>
__device__ __forceinline__ T inf_();
template <>
__device__ __forceinline__ float inf_<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double inf_<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// Lanes per own slot and packed slots per chunk; own slots per warp.
constexpr int L = 8;
static_assert(32 % L == 0 && L < 32, "a group is part of one warp");
constexpr int G = 32 / L;
constexpr int kThreads = 128;

// Can a chunk whose slots have x in [a, b] (a > b when it is empty) hold a
// pair within cut2 of an own slot with x in [p, q]? The x separation is
// taken as the pair arithmetic takes it, RN(d - RN(lx k)) with d = RN(x -
// ox) and k = rint(RN(d inv_lx)); d lies in [RN(a - q), RN(b - p)] (see
// the note above). Branch-free: in one image sa <= sb, and m is sa > 0,
// -sb > 0 or 0.
template <typename T>
__device__ __forceinline__ bool chunk_visit(T a, T b, T p, T q, T cut2, T lx, T inv_lx) {
  const T da = a - q;
  const T db = b - p;
  const T ka = rint_(da * inv_lx);
  const T kb = rint_(db * inv_lx);
  const T sa = da - lx * ka;
  const T sb = db - lx * kb;
  const T one = fmax(sa, fmax(-sb, T(0)));
  const T flip = fmin(fmax(sa, T(0)), fmax(-sb, T(0)));
  const T m = ka == kb ? one : (kb == ka + T(1) ? flip : T(0));
  return a <= b && m * m < cut2;
}

template <typename T, int KMAX, bool kRadii>
__global__ void __launch_bounds__(kThreads)
row_extract_kernel(const T* __restrict__ pos, const int* __restrict__ gid,
                   const bool* __restrict__ valid, const T* __restrict__ srad,
                   int* __restrict__ ids_out, int* __restrict__ cnt_out, int ny, int nz,
                   int R, int K, int n, T lx, T inv_lx, T ly, T lz, T cut2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (R + L - 1) / L;  // chunks per staged row
  T* cx = reinterpret_cast<T*>(smem_raw);  // [9][R] packed slots, planar
  T* cy = cx + 9 * R;
  T* cz = cy + 9 * R;
  T* cs = cz + 9 * R;  // search radii, staged in the radius variant only
  float* klo = reinterpret_cast<float*>(cs + (kRadii ? 9 * R : 0));  // [9][nc]
  float* khi = klo + 9 * nc;
  float* ksm = khi + 9 * nc;  // greatest |search radius|, radius variant only
  int* count = reinterpret_cast<int*>(ksm + (kRadii ? 9 * nc : 0));  // [9] packed slots
  int* rows = count + 9;  // [9] jy * nz + jz of each staged row
  uint16_t* slot = reinterpret_cast<uint16_t*>(rows + 9);  // [9][R] slot in its row

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  // Pack the occupied slots of the 9 candidate rows, image-shifted, one row
  // per warp at a time; block b = (dy + 1) * 3 + (dz + 1), the order of
  // rows._candidate_planes.
  for (int b = warp; b < 9; b += nw) {
    int jy = iy + b / 3 - 1;
    int jz = iz + b % 3 - 1;
    T sy = T(0), sz = T(0);
    if (jy >= ny) { jy -= ny; sy = ly; } else if (jy < 0) { jy += ny; sy = -ly; }
    if (jz >= nz) { jz -= nz; sz = lz; } else if (jz < 0) { jz += nz; sz = -lz; }
    const int rb = jy * nz + jz;
    const size_t base = static_cast<size_t>(rb) * R;
    const T* src = pos + base * 3;
    int m = 0;
    for (int k0 = 0; k0 < R; k0 += 32) {
      const int k = k0 + lane;
      const bool v = k < R && valid[base + k];
      const unsigned took = __ballot_sync(0xffffffffu, v);
      if (v) {
        const int at = b * R + m + __popc(took & ((1u << lane) - 1u));
        cx[at] = src[3 * k];
        cy[at] = src[3 * k + 1] + sy;
        cz[at] = src[3 * k + 2] + sz;
        if constexpr (kRadii) cs[at] = srad[base + k];
        slot[at] = static_cast<uint16_t>(k);
      }
      m += __popc(took);
    }
    if (lane == 0) {
      count[b] = m;
      rows[b] = rb;
    }
  }
  int* ids_row = ids_out + static_cast<size_t>(row) * R * K;
  int* cnt_row = cnt_out + static_cast<size_t>(row) * R;
  const bool* vrow = valid + static_cast<size_t>(row) * R;
  for (int k = threadIdx.x; k < R; k += blockDim.x) {  // invalid own slots
    if (!vrow[k]) {
      for (int e = 0; e < K; ++e) ids_row[static_cast<size_t>(k) * K + e] = n;
      cnt_row[k] = 0;
    }
  }
  __syncthreads();

  for (int q = threadIdx.x; q < 9 * nc; q += blockDim.x) {
    const int b = q / nc;
    const int from = b * R + (q - b * nc) * L;
    const int to = b * R + min((q - b * nc) * L + L, count[b]);
    T lo = inf_<T>(), hi = -inf_<T>(), sm = T(0);
    for (int j = from; j < to; ++j) {
      lo = fmin(lo, cx[j]);
      hi = fmax(hi, cx[j]);
      if constexpr (kRadii) sm = fmax(sm, fabs(cs[j]));
    }
    klo[q] = down_(lo);
    khi[q] = up_(hi);
    if constexpr (kRadii) ksm[q] = up_(sm);
  }
  __syncthreads();

  // A group of L lanes per own slot, G groups per warp on neighbouring own
  // slots. The warp's lanes test 32 chunks at a time against the interval
  // of its own slots' x, and the warp visits those that pass, each lane
  // evaluating one candidate of a chunk for its group's own slot. Every
  // loop below is uniform across the warp, so its groups run in lockstep
  // (groups whose loops diverged would run one after another); a chunk
  // outside a group's own window only costs it the pair tests, which find
  // no hit there.
  const int gl = lane % L;  // lane within the group; lane gl = 0 keeps its list
  const unsigned gmask = ((1u << L) - 1u) << (lane - gl);
  const int n_own = count[4];
  const int n_chunks = 9 * nc;
  // row of chunk q, q / nc: (q + 1/2) / nc lies >= 1/(2 nc) from an
  // integer, far beyond the float product's error at these sizes
  const float inv_nc = 1.0f / static_cast<float>(nc);
  for (int t0 = warp * G; t0 < n_own; t0 += nw * G) {
    const int t = t0 + lane / L;
    const bool active = t < n_own;  // an idle group hits nothing
    const int o = 4 * R + (active ? t : t0);  // own row = centre block, unshifted
    const T ox = cx[o];
    const T oy = cy[o];
    const T oz = cz[o];
    const T os = kRadii ? cs[o] : T(0);
    const int oslot = slot[o];
    const int og = gid[static_cast<size_t>(row) * R + oslot];
    T xlo = ox, xhi = ox, smax = fabs(os);  // over the warp's own slots
    for (int w = L; w < 32; w <<= 1) {
      xlo = fmin(xlo, __shfl_xor_sync(0xffffffffu, xlo, w));
      xhi = fmax(xhi, __shfl_xor_sync(0xffffffffu, xhi, w));
      if constexpr (kRadii) smax = fmax(smax, __shfl_xor_sync(0xffffffffu, smax, w));
    }
    T best_r2[KMAX];
    int best_id[KMAX];
    int kept = 0, hit_count = 0;
    for (int q0 = 0; q0 < n_chunks; q0 += 32) {
      bool vis = false;
      if (q0 + lane < n_chunks) {
        const int q = q0 + lane;
        T ccut2 = cut2;
        if constexpr (kRadii) {
          const T C = smax + T(ksm[q]);
          ccut2 = C * C;
        }
        vis = chunk_visit(T(klo[q]), T(khi[q]), xlo, xhi, ccut2, lx, inv_lx);
      }
      unsigned todo = __ballot_sync(0xffffffffu, vis);
      while (todo) {
        const int q = q0 + __ffs(todo) - 1;
        todo &= todo - 1u;
        const int b = static_cast<int>((static_cast<float>(q) + 0.5f) * inv_nc);
        const int j = (q - b * nc) * L + gl;
        bool hit = false;
        T r2 = T(0);
        int cg = 0;
        if (active && j < count[b]) {
          const int at = b * R + j;
          T dx = cx[at] - ox;
          dx = dx - lx * rint_(dx * inv_lx);
          const T dy = cy[at] - oy;
          const T dz = cz[at] - oz;
          r2 = (dx * dx + dy * dy) + dz * dz;
          T pair_cut2 = cut2;
          if constexpr (kRadii) {
            const T c = os + cs[at];
            pair_cut2 = c * c;
          }
          if (r2 < pair_cut2 && at != o) {  // the own slot itself has gid og
            cg = gid[static_cast<size_t>(rows[b]) * R + slot[at]];
            hit = cg != og;
          }
        }
        unsigned hits = __ballot_sync(0xffffffffu, hit);
        hit_count += __popc(hits & gmask);
        while (hits) {  // each group's hits in candidate order
          const int src = __ffs(hits) - 1;
          hits &= hits - 1u;
          const T hr2 = __shfl_sync(0xffffffffu, r2, src);
          const int hg = __shfl_sync(0xffffffffu, cg, src);
          if (lane != src - src % L || (kept == K && !(hr2 < best_r2[K - 1]))) continue;
          int p = kept < K ? kept++ : K - 1;  // a full list drops its worst
          while (p > 0 && best_r2[p - 1] > hr2) {
            best_r2[p] = best_r2[p - 1];
            best_id[p] = best_id[p - 1];
            --p;
          }
          best_r2[p] = hr2;
          best_id[p] = hg;
        }
      }
    }
    if (active && gl == 0) {
      int* ids = ids_row + static_cast<size_t>(oslot) * K;
      for (int k = 0; k < K; ++k) ids[k] = k < kept ? best_id[k] : n;
      cnt_row[oslot] = hit_count;
    }
  }
}

template <typename T, bool kRadii>
size_t smem_bytes(int R) {
  const int nc = (R + L - 1) / L;
  return static_cast<size_t>(9) * R * ((kRadii ? 4 : 3) * sizeof(T) + sizeof(uint16_t)) +
         static_cast<size_t>(9) * nc * (kRadii ? 3 : 2) * sizeof(float) + 18 * sizeof(int);
}

template <typename T, int KMAX, bool kRadii>
int launch_k(const void* pos, const void* gid, const void* valid,
             const void* srad, void* ids, void* cnt, int ny, int nz, int R,
             int K, int n, double lx, double ly, double lz, double cut2,
             void* stream) {
  const size_t smem = smem_bytes<T, kRadii>(R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_extract_kernel<T, KMAX, kRadii>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  row_extract_kernel<T, KMAX, kRadii><<<ny * nz, kThreads, smem,
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
// six regrows, and a larger K is refused. A slot index is 16 bits: any R
// whose rows fit in shared memory (row_extract.fits) is far below 65536.
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
