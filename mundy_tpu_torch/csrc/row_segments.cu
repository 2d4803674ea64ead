// Segment-segment row contact (kernel K4): Hertzian contact between
// segments on the dense row layout, with two pair ops, the rods op (force
// and torque) and the filaments op (force split to the segment's nodes).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/row_segments.py
// (row_segment_pairs_sym / _seg_kernel), with the rods closures of
// driver/apps/rods_rows.py or the filaments closures of
// driver/apps/filaments.py, and computes what its plain version,
// neighbor/rows.pair_accumulate_segments with that out_fn, computes:
//   * input: (ny, nz, R, 3) midpoints from build_rows (invalid slots hold a
//     sentinel far outside the box), (ny, nz, R, 3) half-edges (zero on
//     invalid slots) and the (ny, nz, R) valid mask; the filaments op also
//     takes the (ny, nz, R) int32 segment gids;
//   * candidate rows (y+dy, z+dz) are pre-shifted to the periodic image
//     nearest the own row, so a pair needs a minimum image along x only:
//     sx -= lx * rint(sx * (1/lx)) (round half to even);
//   * per pair the clamped Lumelsky closest points, then the best of five
//     candidates (the clamped solution and four endpoint projections) by
//     strict `<` on the expanded quadratic, then the coincident-pair noise
//     floor (32 eps)^2 (a + c + w2): closest vector D and d2 exactly zero
//     below it;
//   * the rods op: w = -mag(dist - 2r) / dist on D (d2 clamped at 1e-24,
//     where mag * rinv stays finite and multiplies an exact zero), torque of
//     the own contact point (2s - 1) e_own + radius D / dist. Output
//     (ny, nz, R, 6) = force (3) then torque (3) per own slot;
//   * the filaments op: the same push w, zeroed between adjacent segments
//     of one filament (|g_own - g_cand| == 1 and min(g) mod E != E - 1, E
//     segments per filament), split to the own segment's start node by
//     1 - s and to its end node by s. Output (ny, nz, R, 6) = start-node
//     force (3) then end-node force (3). The reference carries the gid as a
//     float payload (exact to 2^24) with -10 on invalid slots; this op reads
//     the int32 gids and stages -10 on invalid slots, which gives the same
//     exclusion for every segment count below 2^24 (and for any count the
//     int32 gid holds).
//
// Arithmetic. Like every kernel of the package, the file is built with
// -fmad=false (ops/kernels/_build.py): no product and sum contract into an
// FMA, so every product and sum rounds on its own, in the plain version's order,
// exactly as its separate elementwise passes round them. So the closest
// point choice (the five-way tie-break and the noise floor) is the plain
// version's, and only the summation order over candidates differs. The own
// slot of the centre row is skipped: the plain version gives that self pair
// an exact zero through the noise floor. float64 uses the double rsqrt,
// sqrt and division.
//
// Design. One thread block per (iy, iz) row. The block stages its 9
// candidate rows as structure-of-arrays planes in shared memory: midpoint
// x, y, z (image-shifted) and half-edge x, y, z, 6 values x 9R slots (33 KB
// in float32 at R = 152, 66 KB in float64, where the dynamic shared-memory
// opt-in above 48 KB is taken), plus the gid plane for the filaments op
// (9R (6 itemsize + 4) bytes: 183 KB in float32 at R = 728, float64 fits
// up to R = 496), and each row's
// extent, 1 + its last valid slot (its occupancy, as build_rows packs valid
// slots first). One thread owns one slot (looping when R > blockDim) and
// sums its six outputs in
// registers over the candidates within the 9 extents, one-sidedly: every
// off-row pair is evaluated from both sides, and the result is
// deterministic with no atomic sums and no second pass. Slots past the extents
// hold the sentinel and add exact zeros, so the plain version, which visits
// all 9R, gives the same sums. All threads read the same candidate at once,
// a shared-memory broadcast. What a pair contributes, how many outputs
// there are and whether the gid plane is staged are the compile-time Op of
// one kernel body (`if constexpr` keeps the rods op's instantiation free of
// the gid plane). Past the card's opt-in shared memory the launch fails
// and its error is returned; there is no fallback.
//
// Dropped from the TPU kernel, because they exist only for the TPU: the
// half stencil with its partner planes rolled outside the kernel, the
// nz % 8 requirement, the VMEM z-chunk planner and the lane-concatenated
// (nz, 5R) scratch.
//
// Bound: the rods op needs about 187 FP32 operations per occupied pair of
// the half stencil, both sides' outputs (counted from the algorithm in
// chip_smoke.py, K4_OPS, with per-rod quantities hoisted), the filaments op
// about 163 (K4F_OPS), and no memory traffic beyond reading the mask of
// every slot and the payload of the occupied ones once and writing the sums
// once. The FP32 rate bounds both: the rods op at 1M rods, and the
// filaments op at 2000 x 50, whose 15.7M pairs outweigh its 77 MB even on
// rows 3% occupied (98k of 3M slots). This kernel does about 220 per
// ordered pair for the rods op (closest points 178, the Hertz push and
// torque 41): it recomputes per-rod quantities, evaluates the endpoint
// quadratics in full, and takes every off-row pair twice. The filaments
// op's time is set by its fullest rows: straight chains along x put a whole
// filament in one row (R = 728 at 2000 x 50 for a mean occupancy of 24),
// and one block per row leaves those few blocks as the tail; spreading a
// row's work over several blocks is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)
template <typename T>
__device__ __forceinline__ T clip_(T x, T lo, T hi) {
  return fmin(fmax(x, lo), hi);
}

// The closest points of one pair: arc parameters and closest vector.
template <typename T>
struct PairGeom {
  T s, t, dx, dy, dz, d2;
};

// Clamped segment-segment closest points, operation for operation as
// neighbor/rows._segment_pair_chunk. (sx, sy, sz): candidate midpoint minus
// own midpoint (minimum image); (oex..), (cex..): half-edges; a: the own
// 4 |e|^2.
template <typename T>
__device__ __forceinline__ PairGeom<T> closest(T sx, T sy, T sz, T oex,
                                               T oey, T oez, T a, T cex,
                                               T cey, T cez, T eps,
                                               T noise_c) {
  const T wx = (cex - oex) - sx;
  const T wy = (cey - oey) - sy;
  const T wz = (cez - oez) - sz;
  const T c = T(4) * ((cex * cex + cey * cey) + cez * cez);
  const T b = T(4) * ((oex * cex + oey * cey) + oez * cez);
  const T d = T(2) * ((oex * wx + oey * wy) + oez * wz);
  const T e = T(2) * ((cex * wx + cey * wy) + cez * wz);
  const T D = a * c - b * b;

  T sN = b * e - c * d;
  T tN = a * e - b * d;
  T sD = D > T(0) ? D : T(1);
  T tD = sD;
  const bool s_lo = sN < T(0);
  const bool s_hi = sN > sD;
  tN = s_lo ? e : (s_hi ? e + b : tN);
  tD = (s_lo || s_hi) ? c : tD;
  sN = clip_(sN, T(0), sD);
  const bool t_lo = tN < T(0);
  const bool t_hi = tN > tD;
  sN = t_lo ? clip_(-d, T(0), a) : (t_hi ? clip_(b - d, T(0), a) : sN);
  sD = (t_lo || t_hi) ? fmax(a, eps) : sD;
  tN = clip_(tN, T(0), tD);
  T s = sN / fmax(sD, eps);
  T t = tN / fmax(tD, eps);

  // best of five on d2(s,t) = w2 + s^2 a + t^2 c + 2sd - 2te - 2stb
  const T w2 = (wx * wx + wy * wy) + wz * wz;
  const T inv_a = T(1) / fmax(a, eps);
  const T inv_c = T(1) / fmax(c, eps);
  auto q = [&](T ss, T tt) {
    return ((((w2 + ss * ss * a) + tt * tt * c) + T(2) * ss * d) -
            T(2) * tt * e) -
           T(2) * ss * tt * b;
  };
  T best = q(s, t);
  const T cs[4] = {T(0), T(1), clip_(-d * inv_a, T(0), T(1)),
                   clip_((b - d) * inv_a, T(0), T(1))};
  const T ct[4] = {clip_(e * inv_c, T(0), T(1)),
                   clip_((e + b) * inv_c, T(0), T(1)), T(0), T(1)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T v = q(cs[k], ct[k]);
    if (v < best) {
      s = cs[k];
      t = ct[k];
      best = v;
    }
  }

  // closest vector own -> cand: c2 - c1 = -(w + s u - t v)
  PairGeom<T> g;
  g.s = s;
  g.t = t;
  g.dx = T(2) * (t * cex - s * oex) - wx;
  g.dy = T(2) * (t * cey - s * oey) - wy;
  g.dz = T(2) * (t * cez - s * oez) - wz;
  g.d2 = (g.dx * g.dx + g.dy * g.dy) + g.dz * g.dz;
  const T noise2 = noise_c * ((a + c) + w2);
  if (!(g.d2 > noise2)) {
    g.dx = T(0);
    g.dy = T(0);
    g.dz = T(0);
    g.d2 = T(0);
  }
  return g;
}

// The rods op (driver/apps/rods_rows.py out_fn): Hertzian push on the
// closest vector and its torque about the own centre.
template <typename T>
struct RodsOp {
  static constexpr int kOut = 6;
  static constexpr bool kGid = false;
  T two_r, radius, coef;  // coef = 4/3 E* sqrt(R*), rounded as the plain version

  __device__ __forceinline__ void operator()(const PairGeom<T>& g, T oex,
                                             T oey, T oez, T* acc) const {
    const T d2c = fmax(g.d2, T(1e-24));
    const T rinv = rsqrt_(d2c);
    const T dist = d2c * rinv;
    const T delta = fmax(-(dist - two_r), T(0));
    const T mag = coef * delta * sqrt_(delta);
    const T w = -(mag * rinv);
    const T fx = w * g.dx, fy = w * g.dy, fz = w * g.dz;
    const T u2 = T(2) * g.s - T(1);
    const T rr = radius * rinv;
    const T px = u2 * oex + rr * g.dx;
    const T py = u2 * oey + rr * g.dy;
    const T pz = u2 * oez + rr * g.dz;
    acc[0] += fx;
    acc[1] += fy;
    acc[2] += fz;
    acc[3] += py * fz - pz * fy;
    acc[4] += pz * fx - px * fz;
    acc[5] += px * fy - py * fx;
  }
};

// The filaments op (driver/apps/filaments.py out_fn): the Hertzian push,
// zeroed between adjacent segments of one filament, split to the own
// segment's start (1 - s) and end (s) nodes.
template <typename T>
struct FilamentsOp {
  static constexpr int kOut = 6;
  static constexpr bool kGid = true;
  T two_r, coef;  // coef = 4/3 E* sqrt(R*), rounded as the plain version
  int n_edges;    // segments per filament

  __device__ __forceinline__ void operator()(const PairGeom<T>& g, int own_g,
                                             int cand_g, T* acc) const {
    const T d2c = fmax(g.d2, T(1e-24));
    const T rinv = rsqrt_(d2c);
    const T dist = d2c * rinv;
    const T delta = fmax(-(dist - two_r), T(0));
    const T mag = coef * delta * sqrt_(delta);
    const int dg = cand_g - own_g;
    const int min_g = min(own_g, cand_g);
    const bool adjacent = (dg == 1 || dg == -1) && min_g % n_edges != n_edges - 1;
    const T w = adjacent ? T(0) : -(mag * rinv);
    const T fx = w * g.dx, fy = w * g.dy, fz = w * g.dz;
    const T ws = T(1) - g.s, we = g.s;
    acc[0] += ws * fx;
    acc[1] += ws * fy;
    acc[2] += ws * fz;
    acc[3] += we * fx;
    acc[4] += we * fy;
    acc[5] += we * fz;
  }
};

template <typename T, typename Op>
__global__ void row_segment_kernel(const T* __restrict__ mid,
                                   const T* __restrict__ hedge,
                                   const unsigned char* __restrict__ valid,
                                   const int* __restrict__ gid,
                                   T* __restrict__ out, int ny, int nz, int R,
                                   T lx, T inv_lx, T ly, T lz, T eps,
                                   T noise_c, Op op) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cx = reinterpret_cast<T*>(smem_raw);
  T* cy = cx + 9 * R;
  T* cz = cy + 9 * R;
  T* ex = cz + 9 * R;
  T* ey = ex + 9 * R;
  T* ez = ey + 9 * R;
  int* cg = reinterpret_cast<int*>(ez + 9 * R);  // the filaments op's gids
  __shared__ int extent[9];  // 1 + the last valid slot of each staged row

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;
  if (threadIdx.x < 9) extent[threadIdx.x] = 0;
  __syncthreads();

  // Stage the 9 candidate rows; block b = (dy + 1) * 3 + (dz + 1), the
  // order of rows._candidate_planes.
  for (int b = 0; b < 9; ++b) {
    int jy = iy + b / 3 - 1;
    int jz = iz + b % 3 - 1;
    T sy = T(0), sz = T(0);
    if (jy >= ny) { jy -= ny; sy = ly; } else if (jy < 0) { jy += ny; sy = -ly; }
    if (jz >= nz) { jz -= nz; sz = lz; } else if (jz < 0) { jz += nz; sz = -lz; }
    const size_t base = (static_cast<size_t>(jy) * nz + jz) * R;
    const T* m = mid + base * 3;
    const T* h = hedge + base * 3;
    for (int k = threadIdx.x; k < R; k += blockDim.x) {
      cx[b * R + k] = m[3 * k];
      cy[b * R + k] = m[3 * k + 1] + sy;
      cz[b * R + k] = m[3 * k + 2] + sz;
      ex[b * R + k] = h[3 * k];
      ey[b * R + k] = h[3 * k + 1];
      ez[b * R + k] = h[3 * k + 2];
      if constexpr (Op::kGid) cg[b * R + k] = valid[base + k] ? gid[base + k] : -10;
      if (valid[base + k]) atomicMax(&extent[b], k + 1);
    }
  }
  __syncthreads();

  // Slots past a row's extent hold the sentinel: as candidates they are
  // beyond every cutoff of a valid slot, and an own sentinel meets only
  // sentinels it coincides with or lies beyond the cutoff of, so their
  // contributions and outputs are exact zeros, which the loops skip.
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    T acc[Op::kOut];
#pragma unroll
    for (int k = 0; k < Op::kOut; ++k) acc[k] = T(0);
    if (i < extent[4]) {
      const int self = 4 * R + i;  // own row = centre block, unshifted
      const T ox = cx[self], oy = cy[self], oz = cz[self];
      const T oex = ex[self], oey = ey[self], oez = ez[self];
      const T a = T(4) * ((oex * oex + oey * oey) + oez * oez);
      for (int b = 0; b < 9; ++b) {
        const int end = b * R + extent[b];
        for (int j = b * R; j < end; ++j) {
          if (j == self) continue;
          T sx = cx[j] - ox;
          sx = sx - lx * rint_(sx * inv_lx);
          const PairGeom<T> g =
              closest(sx, cy[j] - oy, cz[j] - oz, oex, oey, oez, a, ex[j],
                      ey[j], ez[j], eps, noise_c);
          if constexpr (Op::kGid) {
            op(g, cg[self], cg[j], acc);
          } else {
            op(g, oex, oey, oez, acc);
          }
        }
      }
    }
    T* o = out + (static_cast<size_t>(row) * R + i) * Op::kOut;
#pragma unroll
    for (int k = 0; k < Op::kOut; ++k) o[k] = acc[k];
  }
}

template <typename T, typename Op>
int launch(const void* mid, const void* hedge, const void* valid,
           const void* gid, void* out, int ny, int nz, int R, double lx,
           double ly, double lz, double eps, double noise_c, const Op& op,
           void* stream) {
  const int threads = R >= 256 ? 256 : ((R + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(9) * R *
                      (6 * sizeof(T) + (Op::kGid ? sizeof(int) : 0));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_segment_kernel<T, Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  row_segment_kernel<T, Op><<<ny * nz, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(mid), static_cast<const T*>(hedge),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(gid),
      static_cast<T*>(out), ny, nz, R, T(lx), T(1.0 / lx), T(ly), T(lz),
      T(eps), T(noise_c), op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rods(const void* mid, const void* hedge, const void* valid,
                void* out, int ny, int nz, int R, double lx, double ly,
                double lz, double two_r, double radius, double coef,
                double eps, double noise_c, void* stream) {
  const RodsOp<T> op{T(two_r), T(radius), T(coef)};
  return launch<T>(mid, hedge, valid, nullptr, out, ny, nz, R, lx, ly, lz,
                   eps, noise_c, op, stream);
}

template <typename T>
int launch_filaments(const void* mid, const void* hedge, const void* valid,
                     const void* gid, void* out, int ny, int nz, int R,
                     double lx, double ly, double lz, double two_r,
                     double coef, int n_edges, double eps, double noise_c,
                     void* stream) {
  const FilamentsOp<T> op{T(two_r), T(coef), n_edges};
  return launch<T>(mid, hedge, valid, gid, out, ny, nz, R, lx, ly, lz, eps,
                   noise_c, op, stream);
}

}  // namespace

extern "C" {

// valid: (ny, nz, R) bytes, nonzero where a slot holds a rod. Returns
// cudaGetLastError() after the launch (0 = launched).
int row_segment_rods_f32(const void* mid, const void* hedge, const void* valid,
                         void* out, int ny, int nz, int R, double lx,
                         double ly, double lz, double two_r, double radius,
                         double coef, double eps, double noise_c,
                         void* stream) {
  return launch_rods<float>(mid, hedge, valid, out, ny, nz, R, lx, ly, lz,
                            two_r, radius, coef, eps, noise_c, stream);
}

int row_segment_rods_f64(const void* mid, const void* hedge, const void* valid,
                         void* out, int ny, int nz, int R, double lx,
                         double ly, double lz, double two_r, double radius,
                         double coef, double eps, double noise_c,
                         void* stream) {
  return launch_rods<double>(mid, hedge, valid, out, ny, nz, R, lx, ly, lz,
                             two_r, radius, coef, eps, noise_c, stream);
}

// gid: (ny, nz, R) int32 segment gids; n_edges: segments per filament.
int row_segment_filaments_f32(const void* mid, const void* hedge,
                              const void* valid, const void* gid, void* out,
                              int ny, int nz, int R, double lx, double ly,
                              double lz, double two_r, double coef,
                              int n_edges, double eps, double noise_c,
                              void* stream) {
  return launch_filaments<float>(mid, hedge, valid, gid, out, ny, nz, R, lx,
                                 ly, lz, two_r, coef, n_edges, eps, noise_c,
                                 stream);
}

int row_segment_filaments_f64(const void* mid, const void* hedge,
                              const void* valid, const void* gid, void* out,
                              int ny, int nz, int R, double lx, double ly,
                              double lz, double two_r, double coef,
                              int n_edges, double eps, double noise_c,
                              void* stream) {
  return launch_filaments<double>(mid, hedge, valid, gid, out, ny, nz, R, lx,
                                  ly, lz, two_r, coef, n_edges, eps, noise_c,
                                  stream);
}

}  // extern "C"
