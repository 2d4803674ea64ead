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
// FMA, so every product and sum rounds on its own, in the plain version's
// order, exactly as its separate elementwise passes round them. So the
// closest point choice (the five-way tie-break and the noise floor) is the
// plain version's, and only the summation order over candidates differs.
// The own slot of the centre row is skipped: the plain version gives that
// self pair an exact zero through the noise floor. float64 uses the double
// rsqrt, sqrt and division.
//
// The filaments op (seg_pack_kernel, then row_filaments_kernel). At 2000 x 50
// filaments (64 x 64 rows of R = 728 in a box of 120) the rows hold 98k
// segments, a mean of 24 per row, but straight chains along x put a whole
// filament into one row (up to ~640). The first design gave each row one
// block, staged all 9 candidate rows in shared memory (183 KB at R = 728,
// one block per SM) and ran closest() on every own slot against every slot
// within the 9 extents: the few full rows formed the tail, and at a reach of
// ~1.5 in a row spanning x = 120 nearly every pair it evaluated was out of
// reach. This design:
//   * a pre-pass, one warp per chunk of 32 slots of a row, packs each slot
//     of an occupied chunk as one 16-byte entry in float32 (midpoint x, y, z
//     and |e|, or -1 where the slot holds no segment) and writes the chunk's
//     bounds (least and greatest x of its segments, their greatest |e|) to a
//     scratch the wrapper allocates; no host read sizes anything;
//   * the pair kernel gives 4 warps to each chunk of 32 own slots of a row,
//     8 own slots each, so a full row is served by up to 4 ceil(R / 32)
//     warps and a warp whose chunk is empty writes its zeros and stops (on
//     the card, 1 or 2 warps per chunk ran slower: a warp serves its own
//     slots one after another); Candidates are read from
//     the packed scratch through the L1 cache, not staged, so shared memory
//     holds only each warp's ring and drained outputs (5 KB per block of 4
//     warps in float32, 8 KB in float64) and no R runs out of it;
//   * the rest is the rods op's design (below): chunk x-window, reach test
//     with the margin 1 + 2^-10, passing pairs to a 64-entry ring in (own,
//     row, chunk, slot) order, drained 32 at a time, and each own slot's sum
//     in ring order; only valid pairs reach the op, which tests adjacency on
//     the int32 gids.
// Each own slot's sum is the full scan's sequence of terms with only
// exact-zero terms left out, so the outputs stay bit for bit the first
// design's (pinned digests in tests/test_torch_kernels.py). The rods op keeps
// its staged body: run on this packed body in a trial on the card, it was
// slower at config #3's 1M rods, whose rows are evenly filled.
//
// The rods op (row_rods_kernel). One thread block per (iy, iz) row stages
// its 9 candidate rows as structure-of-arrays planes in shared memory:
// midpoint x, y, z (image-shifted) and half-edge x, y, z; past the card's
// opt-in shared memory the launch fails and its error is returned, with no
// fallback. At config #3's 1M rods a row holds ~97
// rods spread over lx = 301.62 (rows span the box in x), so of the ~870
// valid candidates of an own rod only ~15 lie within reach in x and ~2.4
// in 3D. The kernel visits those, not the rest:
//   * staging adds a seventh plane, |e| per slot, and per chunk of 32 slots
//     of a staged row the least and greatest x of its valid slots and their
//     greatest |e| (a warp reduction). Rods move between rebuilds, so the
//     rows are only roughly sorted in x; the chunk bounds are taken from the
//     current positions, so the window is exact either way. Shared memory
//     per block (rods_smem): (63 R + 27 ceil(R/32) + 192 nw) itemsize +
//     512 nw + R bytes with nw = min(ceil(R/32), 16) warps, so the largest
//     row the H100's 232,448-byte opt-in takes is R = 826 in float32 and
//     R = 402 in float64 (47 KB at config #3's R = 160 in float32);
//   * a warp takes 32 own slots, one at a time. Its lanes test the 9 rows'
//     chunks against the own rod (chunk_visit: the chunk's x range under the
//     minimum image, as the pair test takes it, against the chunk's reach;
//     a chunk spanning lx/2 or more is always visited), then each visited
//     chunk's 32 candidates against the reach test: skip the pair when
//     s2 > ((|e_own| + |e_cand|) + 2r)^2 (1 + 2^-10), in the working dtype;
//   * lanes busy: the pairs that pass go to the warp's ring of 64 entries in
//     (own, row, slot) order, by ballot; every 32 the lanes evaluate 32 pairs
//     at once (closest points and the op), then each own slot's lane adds
//     its pairs' outputs in ring order. A warp per own slot with a shuffle
//     reduction would run closest() for ~2.4 passing lanes of 32; the ring
//     runs it at full width, and closest() is most of a pair's cost;
//   * each own slot's sum is then the old kernel's sequence of terms, rows
//     and slots in order, with only exact-zero terms left out: adding +-0 to
//     a sum that starts at +0 changes nothing, so the outputs are bit for bit
//     the full scan's, and two launches are bit-equal.
// Why a skipped pair adds an exact zero. Let L = |e_own| + |e_cand| and S the
// centre separation the kernel computes (x minimum image taken). Every point
// of a segment lies within |e| of its centre, so any two points of the pair
// are at least |S| - L apart. The test's own rounding (s2, the lengths, the
// products: a few u, u = 2^-24 in float32, 2^-53 in float64) leaves a skipped
// pair with |S| >= (L + 2r)(1 + d), d = 4.8e-4. closest() turns the same S
// and half-edges into the vector between two points of the segments at its
// (s, t) in [0, 1]: w = (e_cand - e_own) - S, then 2(t e_cand - s e_own) - w,
// each rounding within u of its operands, and dist = d2c rsqrt(d2c) adds a
// few ulp more (rsqrtf is within 2 ulp), so the computed dist is at least
// |S| - L - 16u (|S| + 2L) >= |S| - L - 48u |S|. With |S| >= (L + 2r)(1 + d),
// |S| - L - 2r >= |S| d / (1 + d) > 48u |S| as long as d > 48u (1 + d), which
// holds with a factor above 100 in float32. So dist - 2r rounds to >= 0,
// delta = max(-(dist - 2r), 0) = 0, mag = 0, and the force and torque are
// signed zeros (as they are where the noise floor zeroes D). In the
// filaments op the same delta = 0 gives mag = 0 and w = -(0 rinv) = -0 (or
// +0 between adjacent segments), and the node split keeps a signed zero:
// (1 - s) w D and s w D with s in [0, 1]. The chunk test
// skips only chunks all of whose pairs the pair test skips: rounding is
// monotonic, so within one image every valid slot's computed x separation
// lies between those of the chunk's least and greatest x, and s2 >= sx^2.
// The CPU tests hold the plain version to exact zeros on every pair that
// ops/kernels/row_segments.segment_reach (this test, operation for
// operation) rejects, for the rods op and for the filaments op (adjacent
// pairs included).
//
// Dropped from the TPU kernel, because they exist only for the TPU: the
// half stencil with its partner planes rolled outside the kernel, the
// nz % 8 requirement, the VMEM z-chunk planner and the lane-concatenated
// (nz, 5R) scratch.
//
// Bound. Both ops are counted from the algorithm (chip_smoke.py): the reach
// test for every unordered pair within reach in x (K4_REACH_OPS), the
// closest points and the op's outputs for every pair within reach in 3D
// (K4_OPS, 187, both sides' torques; K4F_OPS, 163, both sides' node
// splits), and per segment its hoisted quantities (K4_ROD_OPS); bytes from
// occupancy (the valid byte and the outputs of every slot, the payload of
// the valid slots once). The rods op at 1M rods is bound by bytes: 67 MB
// (0.020 ms at 3.35 TB/s). What it does beyond that: it stages each row 9
// times (once per neighbouring block, from L2), tests ~10 chunks of 32 per
// own rod (a chunk spans ~100 of x, the reach 2.5), and takes every pair from
// both sides. The filaments op at 2000 x 50 is bound by bytes too: 77 MB
// (0.023 ms) against 0.6M unordered pairs within reach in x and 0.12M in 3D
// (0.0005 ms of operations). Beyond that (0.51 ms, ~22x; the first design
// took 10.16 ms) it reads every slot of an occupied chunk in the pre-pass,
// tests 9 ceil(R / 32) = 207 chunks per own segment, serves a
// warp's own segments one after another, and takes every pair from both
// sides.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
template <typename T>
__device__ __forceinline__ T inf_();
template <>
__device__ __forceinline__ float inf_<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double inf_<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

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
// neighbor/rows.segment_pair_terms. (sx, sy, sz): candidate midpoint minus
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

// ---- the rods op: only the candidates within reach ---------------------

constexpr int CH = 32;    // slots per chunk of a staged row (one warp)
constexpr int QCAP = 64;  // entries of a warp's ring of passing pairs
constexpr int MAX_WARPS = 16;

// Does chunk [a, b] (the x range of its valid slots; a > b when it has
// none) come within reach of an own slot at ox? rc2 is the chunk's squared
// reach times the margin, as the pair test computes it. The minimum image
// of a - ox and b - ox is taken as the pair test takes it, and rounding is
// monotonic, so every valid slot's computed x separation lies in [sa, sb]
// (one image) or in [sa, lx/2] and [-lx/2, sb] (one flip): the least |sx|
// bounds each pair's s2 from below, and a chunk left out holds only pairs
// the pair test would skip.
template <typename T>
__device__ __forceinline__ bool chunk_visit(T a, T b, T ox, T rc2, T lx, T inv_lx) {
  if (!(a <= b)) return false;
  if (!(b - a < T(0.5) * lx)) return true;
  const T da = a - ox;
  const T ka = rint_(da * inv_lx);
  const T sa = da - lx * ka;
  const T db = b - ox;
  const T kb = rint_(db * inv_lx);
  const T sb = db - lx * kb;
  T m = T(0);
  if (ka == kb) {
    m = sa > T(0) ? sa : (sb < T(0) ? -sb : T(0));
  } else if (kb == ka + T(1)) {
    m = fmin(fmax(sa, T(0)), fmax(-sb, T(0)));
  }
  return !(m * m > rc2);
}

template <typename T>
__global__ void row_rods_kernel(const T* __restrict__ mid, const T* __restrict__ hedge,
                                const unsigned char* __restrict__ valid,
                                T* __restrict__ out, int ny, int nz, int R, T lx,
                                T inv_lx, T ly, T lz, T eps, T noise_c, T margin,
                                RodsOp<T> op) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (R + CH - 1) / CH;  // chunks per staged row
  const int nw = blockDim.x >> 5;
  T* cx = reinterpret_cast<T*>(smem_raw);
  T* cy = cx + 9 * R;
  T* cz = cy + 9 * R;
  T* ex = cz + 9 * R;
  T* ey = ex + 9 * R;
  T* ez = ey + 9 * R;
  T* el = ez + 9 * R;      // |half-edge|
  T* clo = el + 9 * R;     // [9 nc] least x of each chunk's valid slots
  T* chi = clo + 9 * nc;   // greatest x
  T* cel = chi + 9 * nc;   // greatest |half-edge|
  T* res = cel + 9 * nc;   // [nw][32][6] drained pair outputs
  int* ring = reinterpret_cast<int*>(res + nw * 32 * 6);  // [nw][QCAP] own k, cand j
  unsigned char* own_ok = reinterpret_cast<unsigned char*>(ring + nw * QCAP * 2);  // [R]

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Stage the 9 candidate rows, one chunk per warp at a time; block b =
  // (dy + 1) * 3 + (dz + 1), the order of rows._candidate_planes.
  for (int q = warp; q < 9 * nc; q += nw) {
    const int b = q / nc;
    const int k = (q - b * nc) * CH + lane;
    int jy = iy + b / 3 - 1;
    int jz = iz + b % 3 - 1;
    T sy = T(0), sz = T(0);
    if (jy >= ny) { jy -= ny; sy = ly; } else if (jy < 0) { jy += ny; sy = -ly; }
    if (jz >= nz) { jz -= nz; sz = lz; } else if (jz < 0) { jz += nz; sz = -lz; }
    const size_t base = (static_cast<size_t>(jy) * nz + jz) * R;
    bool v = false;
    T x = T(0), len = T(0);
    if (k < R) {
      const T* m = mid + (base + k) * 3;
      const T* h = hedge + (base + k) * 3;
      x = m[0];
      const T hx = h[0], hy = h[1], hz = h[2];
      len = sqrt_((hx * hx + hy * hy) + hz * hz);
      cx[b * R + k] = x;
      cy[b * R + k] = m[1] + sy;
      cz[b * R + k] = m[2] + sz;
      ex[b * R + k] = hx;
      ey[b * R + k] = hy;
      ez[b * R + k] = hz;
      el[b * R + k] = len;
      v = valid[base + k] != 0;
      if (b == 4) own_ok[k] = v;
    }
    T lo = v ? x : inf_<T>(), hi = v ? x : -inf_<T>(), le = v ? len : T(0);
    for (int o = 16; o > 0; o >>= 1) {
      lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      le = fmax(le, __shfl_xor_sync(0xffffffffu, le, o));
    }
    if (lane == 0) {
      clo[q] = lo;
      chi[q] = hi;
      cel[q] = le;
    }
  }
  __syncthreads();

  // Each warp takes own slots o = o0 + warp + nw k, k < 32, one at a time;
  // lane k keeps the sums of its own slot k. The lanes test a visited
  // chunk's candidates against the own slot, and the pairs that pass go to
  // the warp's ring in (own, row, chunk, slot) order; 32 at a time the lanes
  // evaluate them (closest points and the op), and each own slot adds its
  // pairs' outputs in ring order.
  T* wres = res + warp * 32 * 6;
  int* ring_k = ring + warp * QCAP * 2;
  int* ring_j = ring_k + QCAP;
  const T two_r = op.two_r;
  for (int o0 = 0; o0 < R; o0 += 32 * nw) {
    T acc[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[c] = T(0);
    int head = 0, qn = 0;

    auto drain = [&](int cnt) {
      __syncwarp();
      T r[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) r[c] = T(0);
      if (lane < cnt) {
        const int e = (head + lane) & (QCAP - 1);
        const int self = 4 * R + o0 + warp + nw * ring_k[e];
        const int j = ring_j[e];
        const T oex = ex[self], oey = ey[self], oez = ez[self];
        const T a = T(4) * ((oex * oex + oey * oey) + oez * oez);
        T sx = cx[j] - cx[self];
        sx = sx - lx * rint_(sx * inv_lx);
        const PairGeom<T> g = closest(sx, cy[j] - cy[self], cz[j] - cz[self], oex, oey, oez,
                                      a, ex[j], ey[j], ez[j], eps, noise_c);
        op(g, oex, oey, oez, r);
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) wres[lane * 6 + c] = r[c];
      __syncwarp();
      for (int q = 0; q < cnt; ++q) {
        if (ring_k[(head + q) & (QCAP - 1)] == lane) {
#pragma unroll
          for (int c = 0; c < 6; ++c) acc[c] += wres[q * 6 + c];
        }
      }
      __syncwarp();
      head = (head + cnt) & (QCAP - 1);
      qn -= cnt;
    };

    for (int k = 0; k < 32; ++k) {
      const int o = o0 + warp + nw * k;
      if (o >= R) break;
      if (!own_ok[o]) continue;  // a sentinel: its outputs are exact zeros
      const int self = 4 * R + o;
      const T ox = cx[self], oy = cy[self], oz = cz[self], ol = el[self];
      for (int q0 = 0; q0 < 9 * nc; q0 += 32) {
        const int qv = q0 + lane;
        bool vis = false;
        if (qv < 9 * nc) {
          const T rc = (ol + cel[qv]) + two_r;
          vis = chunk_visit(clo[qv], chi[qv], ox, rc * rc * margin, lx, inv_lx);
        }
        unsigned todo = __ballot_sync(0xffffffffu, vis);
        while (todo) {
          const int q = q0 + __ffs(todo) - 1;
          todo &= todo - 1;
          const int b = q / nc;
          const int kk = (q - b * nc) * CH + lane;
          const int j = b * R + kk;
          bool pass = false;
          if (kk < R && j != self) {  // the reach test
            T sx = cx[j] - ox;
            sx = sx - lx * rint_(sx * inv_lx);
            const T sy = cy[j] - oy, sz = cz[j] - oz;
            const T s2 = (sx * sx + sy * sy) + sz * sz;
            const T reach = (ol + el[j]) + two_r;
            pass = !(s2 > reach * reach * margin);
          }
          const unsigned passed = __ballot_sync(0xffffffffu, pass);
          if (pass) {
            const int e = (head + qn + __popc(passed & ((1u << lane) - 1u))) & (QCAP - 1);
            ring_k[e] = k;
            ring_j[e] = j;
          }
          qn += __popc(passed);
          if (qn >= 32) drain(32);
        }
      }
    }
    drain(qn);
    const int o = o0 + warp + nw * lane;
    if (o < R) {
      T* dst = out + (static_cast<size_t>(row) * R + o) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) dst[c] = acc[c];
    }
  }
}

template <typename T>
size_t rods_smem(int R, int nw) {
  const int nc = (R + CH - 1) / CH;
  return static_cast<size_t>(7 * 9 * R + 3 * 9 * nc + nw * 32 * 6) * sizeof(T) +
         static_cast<size_t>(nw) * QCAP * 2 * sizeof(int) + R;
}

template <typename T>
int launch_rods(const void* mid, const void* hedge, const void* valid,
                void* out, int ny, int nz, int R, double lx, double ly,
                double lz, double two_r, double radius, double coef,
                double margin, double eps, double noise_c, void* stream) {
  const RodsOp<T> op{T(two_r), T(radius), T(coef)};
  const int want = (R + 31) / 32;
  const int nw = want < MAX_WARPS ? want : MAX_WARPS;
  const size_t smem = rods_smem<T>(R, nw);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_rods_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  row_rods_kernel<T><<<ny * nz, 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(mid), static_cast<const T*>(hedge),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out), ny, nz, R, T(lx),
      T(1.0 / lx), T(ly), T(lz), T(eps), T(noise_c), T(margin), op);
  return static_cast<int>(cudaGetLastError());
}

// ---- the filaments op: packed rows, warps per own chunk ----------------

constexpr int WPB = 4;    // warps per block of the packed body
constexpr int SPLIT = 4;  // warps that share the own slots of one chunk
constexpr int KS = CH / SPLIT;  // own slots per warp

// One packed slot: midpoint x, y, z (unshifted) and |half-edge|, or -1 where
// the slot holds no segment. One 16-byte load in float32.
template <typename T>
struct alignas(4 * sizeof(T)) Packed {
  T x, y, z, len;
};

// The candidate row of stencil block b = (dy + 1) * 3 + (dz + 1) around
// (iy, iz), wrapped, and the image shift of its y and z.
template <typename T>
struct StencilRow {
  int row;
  T sy, sz;
};

template <typename T>
__device__ __forceinline__ StencilRow<T> stencil_row(int iy, int iz, int b, int ny, int nz,
                                                     T ly, T lz) {
  int jy = iy + b / 3 - 1;
  int jz = iz + b % 3 - 1;
  T sy = T(0), sz = T(0);
  if (jy >= ny) { jy -= ny; sy = ly; } else if (jy < 0) { jy += ny; sy = -ly; }
  if (jz >= nz) { jz -= nz; sz = lz; } else if (jz < 0) { jz += nz; sz = -lz; }
  return StencilRow<T>{jy * nz + jz, sy, sz};
}

// Pre-pass, one warp per chunk of CH slots of a row: the packed slots and
// the chunk's bounds (least and greatest x of its occupied slots, their
// greatest |half-edge|; +inf, -inf, 0 when it has none). An empty chunk is
// never visited, so its packed slots are not written.
template <typename T>
__global__ void seg_pack_kernel(const T* __restrict__ mid, const T* __restrict__ hedge,
                                const unsigned char* __restrict__ valid,
                                Packed<T>* __restrict__ packed, T* __restrict__ bounds,
                                int n_items, int R) {
  const int item = blockIdx.x * WPB + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int lane = threadIdx.x & 31;
  const int nc = (R + CH - 1) / CH;
  const int row = item / nc;
  const int k = (item - row * nc) * CH + lane;
  const size_t slot = static_cast<size_t>(row) * R + k;
  bool v = false;
  T x = T(0), y = T(0), z = T(0), len = T(0);
  if (k < R) {
    v = valid[slot] != 0;
    const T* m = mid + slot * 3;
    const T* h = hedge + slot * 3;
    x = m[0];
    y = m[1];
    z = m[2];
    const T hx = h[0], hy = h[1], hz = h[2];
    len = sqrt_((hx * hx + hy * hy) + hz * hz);
  }
  T lo = v ? x : inf_<T>(), hi = v ? x : -inf_<T>(), le = v ? len : T(0);
  for (int o = 16; o > 0; o >>= 1) {
    lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    le = fmax(le, __shfl_xor_sync(0xffffffffu, le, o));
  }
  if (lo <= hi && k < R) packed[slot] = Packed<T>{x, y, z, v ? len : T(-1)};
  if (lane == 0) {
    bounds[3 * item] = lo;
    bounds[3 * item + 1] = hi;
    bounds[3 * item + 2] = le;
  }
}

// The filaments op over the packed rows. SPLIT warps share the CH own
// slots of one chunk of one row, KS each (so a full row is served by many
// warps, and a warp whose chunk is empty writes its zeros and stops), one
// own slot at a time; lane k keeps the sums of own slot k. Its lanes test
// the 9 rows'
// chunks against the own segment (chunk_visit), then each visited chunk's
// CH candidates against the reach test; the pairs that pass go to the
// warp's ring in (own, row, chunk, slot) order, and 32 at a time the lanes
// evaluate them (closest points and the op), after which each own slot adds
// its pairs' outputs in ring order.
template <typename T>
__global__ void row_filaments_kernel(const T* __restrict__ hedge,
                                     const int* __restrict__ gid,
                                     const Packed<T>* __restrict__ packed,
                                     const T* __restrict__ bounds, T* __restrict__ out, int ny,
                                     int nz, int R, T lx, T inv_lx, T ly, T lz, T eps,
                                     T noise_c, T margin, FilamentsOp<T> op) {
  __shared__ int ring_all[WPB][2 * QCAP];     // own k, then candidate b R + slot
  __shared__ T res_all[WPB][32 * 6];          // drained pair outputs
  const int nc = (R + CH - 1) / CH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * WPB + warp;
  if (item >= ny * nz * nc * SPLIT) return;
  const int chunk = item / SPLIT;  // row * nc + own chunk
  const int row = chunk / nc;
  const int oc = chunk - row * nc;
  const int iy = row / nz;
  const int iz = row - iy * nz;
  const int o_lane = oc * CH + lane;
  // this warp's own slots: lanes [k0, k0 + KS) of the chunk
  const int k0 = (item - chunk * SPLIT) * KS;
  const bool in_part = lane >= k0 && lane < k0 + KS && o_lane < R;
  T* dst = out + (static_cast<size_t>(row) * R + o_lane) * 6;
  if (!(bounds[3 * chunk] <= bounds[3 * chunk + 1])) {  // no own segment here
    if (in_part) {
#pragma unroll
      for (int c = 0; c < 6; ++c) dst[c] = T(0);
    }
    return;
  }

  // own slot o_lane, as the full scan staged it (y and z plus a zero shift)
  const size_t own_slot = static_cast<size_t>(row) * R + o_lane;
  bool own_ok = false;
  T ox = T(0), oy = T(0), oz = T(0), ol = T(0), oex = T(0), oey = T(0), oez = T(0);
  int og = 0;
  if (in_part) {
    const Packed<T> p = packed[own_slot];
    own_ok = p.len >= T(0);
    if (own_ok) {
      ox = p.x;
      oy = p.y + T(0);
      oz = p.z + T(0);
      ol = p.len;
      oex = hedge[own_slot * 3];
      oey = hedge[own_slot * 3 + 1];
      oez = hedge[own_slot * 3 + 2];
      og = gid[own_slot];
    }
  }
  const unsigned own_mask = __ballot_sync(0xffffffffu, own_ok);

  int* ring_k = ring_all[warp];
  int* ring_j = ring_k + QCAP;
  T* wres = res_all[warp];
  const T two_r = op.two_r;
  T acc[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) acc[c] = T(0);
  int head = 0, qn = 0;

  auto drain = [&](int cnt) {
    __syncwarp();
    const int e = (head + lane) & (QCAP - 1);
    const int src = lane < cnt ? ring_k[e] : 0;
    const T px = __shfl_sync(0xffffffffu, ox, src);
    const T py = __shfl_sync(0xffffffffu, oy, src);
    const T pz = __shfl_sync(0xffffffffu, oz, src);
    const T pex = __shfl_sync(0xffffffffu, oex, src);
    const T pey = __shfl_sync(0xffffffffu, oey, src);
    const T pez = __shfl_sync(0xffffffffu, oez, src);
    const int pg = __shfl_sync(0xffffffffu, og, src);
    T r[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] = T(0);
    if (lane < cnt) {
      const int j = ring_j[e];
      const int b = j / R;
      const int kk = j - b * R;
      const StencilRow<T> sr = stencil_row(iy, iz, b, ny, nz, ly, lz);
      const size_t cs = static_cast<size_t>(sr.row) * R + kk;
      const Packed<T> p = packed[cs];
      const T a = T(4) * ((pex * pex + pey * pey) + pez * pez);
      T sx = p.x - px;
      sx = sx - lx * rint_(sx * inv_lx);
      const PairGeom<T> g = closest(sx, (p.y + sr.sy) - py, (p.z + sr.sz) - pz, pex, pey,
                                    pez, a, hedge[cs * 3], hedge[cs * 3 + 1],
                                    hedge[cs * 3 + 2], eps, noise_c);
      op(g, pg, gid[cs], r);
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) wres[lane * 6 + c] = r[c];
    __syncwarp();
    for (int q = 0; q < cnt; ++q) {
      if (ring_k[(head + q) & (QCAP - 1)] == lane) {
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[c] += wres[q * 6 + c];
      }
    }
    __syncwarp();
    head = (head + cnt) & (QCAP - 1);
    qn -= cnt;
  };

  for (unsigned todo_own = own_mask; todo_own; todo_own &= todo_own - 1) {
    const int k = __ffs(todo_own) - 1;  // own slots in order; padded ones add nothing
    const int o = oc * CH + k;
    const T kx = __shfl_sync(0xffffffffu, ox, k);
    const T ky = __shfl_sync(0xffffffffu, oy, k);
    const T kz = __shfl_sync(0xffffffffu, oz, k);
    const T kl = __shfl_sync(0xffffffffu, ol, k);
    for (int q0 = 0; q0 < 9 * nc; q0 += 32) {
      const int qv = q0 + lane;
      bool vis = false;
      if (qv < 9 * nc) {
        const int b = qv / nc;
        const StencilRow<T> sr = stencil_row(iy, iz, b, ny, nz, ly, lz);
        const T* cb = bounds + 3 * (static_cast<size_t>(sr.row) * nc + (qv - b * nc));
        const T rc = (kl + cb[2]) + two_r;
        vis = chunk_visit(cb[0], cb[1], kx, rc * rc * margin, lx, inv_lx);
      }
      unsigned todo = __ballot_sync(0xffffffffu, vis);
      while (todo) {
        const int q = q0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const int b = q / nc;
        const int kk = (q - b * nc) * CH + lane;
        const StencilRow<T> sr = stencil_row(iy, iz, b, ny, nz, ly, lz);
        bool pass = false;
        if (kk < R && !(b == 4 && kk == o)) {  // the reach test
          const Packed<T> p = packed[static_cast<size_t>(sr.row) * R + kk];
          if (p.len >= T(0)) {
            T sx = p.x - kx;
            sx = sx - lx * rint_(sx * inv_lx);
            const T sy = (p.y + sr.sy) - ky, sz = (p.z + sr.sz) - kz;
            const T s2 = (sx * sx + sy * sy) + sz * sz;
            const T reach = (kl + p.len) + two_r;
            pass = !(s2 > reach * reach * margin);
          }
        }
        const unsigned passed = __ballot_sync(0xffffffffu, pass);
        if (pass) {
          const int e = (head + qn + __popc(passed & ((1u << lane) - 1u))) & (QCAP - 1);
          ring_k[e] = k;
          ring_j[e] = b * R + kk;
        }
        qn += __popc(passed);
        if (qn >= 32) drain(32);
      }
    }
  }
  drain(qn);
  if (in_part) {
#pragma unroll
    for (int c = 0; c < 6; ++c) dst[c] = acc[c];
  }
}

template <typename T>
int launch_filaments(const void* mid, const void* hedge, const void* valid, const void* gid,
                     void* packed, void* bounds, void* out, int ny, int nz, int R, double lx,
                     double ly, double lz, double two_r, double coef, int n_edges,
                     double margin, double eps, double noise_c, void* stream) {
  const FilamentsOp<T> op{T(two_r), T(coef), n_edges};
  const int n_items = ny * nz * ((R + CH - 1) / CH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seg_pack_kernel<T><<<(n_items + WPB - 1) / WPB, 32 * WPB, 0, s>>>(
      static_cast<const T*>(mid), static_cast<const T*>(hedge),
      static_cast<const unsigned char*>(valid), static_cast<Packed<T>*>(packed),
      static_cast<T*>(bounds), n_items, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_filaments_kernel<T><<<(n_items * SPLIT + WPB - 1) / WPB, 32 * WPB, 0, s>>>(
      static_cast<const T*>(hedge), static_cast<const int*>(gid),
      static_cast<const Packed<T>*>(packed),
      static_cast<const T*>(bounds), static_cast<T*>(out), ny, nz, R, T(lx), T(1.0 / lx),
      T(ly), T(lz), T(eps), T(noise_c), T(margin), op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// valid: (ny, nz, R) bytes, nonzero where a slot holds a rod; margin: the
// reach test's factor 1 + 2^-10 on the squared reach. Returns
// cudaGetLastError() after the launch (0 = launched).
int row_segment_rods_f32(const void* mid, const void* hedge, const void* valid,
                         void* out, int ny, int nz, int R, double lx,
                         double ly, double lz, double two_r, double radius,
                         double coef, double margin, double eps,
                         double noise_c, void* stream) {
  return launch_rods<float>(mid, hedge, valid, out, ny, nz, R, lx, ly, lz,
                            two_r, radius, coef, margin, eps, noise_c, stream);
}

int row_segment_rods_f64(const void* mid, const void* hedge, const void* valid,
                         void* out, int ny, int nz, int R, double lx,
                         double ly, double lz, double two_r, double radius,
                         double coef, double margin, double eps,
                         double noise_c, void* stream) {
  return launch_rods<double>(mid, hedge, valid, out, ny, nz, R, lx, ly, lz,
                             two_r, radius, coef, margin, eps, noise_c, stream);
}

// gid: (ny, nz, R) int32 segment gids; n_edges: segments per filament;
// packed: (ny, nz, R) scratch of 4 values per slot; bounds: scratch of 3
// values per chunk of 32 slots (ceil(R / 32) per row); margin: the reach
// test's factor 1 + 2^-10 on the squared reach. Returns cudaGetLastError()
// after the two launches (0 = launched).
int row_segment_filaments_f32(const void* mid, const void* hedge, const void* valid,
                              const void* gid, void* packed, void* bounds, void* out,
                              int ny, int nz, int R, double lx, double ly, double lz,
                              double two_r, double coef, int n_edges, double margin,
                              double eps, double noise_c, void* stream) {
  return launch_filaments<float>(mid, hedge, valid, gid, packed, bounds, out, ny, nz, R, lx,
                                 ly, lz, two_r, coef, n_edges, margin, eps, noise_c, stream);
}

int row_segment_filaments_f64(const void* mid, const void* hedge, const void* valid,
                              const void* gid, void* packed, void* bounds, void* out,
                              int ny, int nz, int R, double lx, double ly, double lz,
                              double two_r, double coef, int n_edges, double margin,
                              double eps, double noise_c, void* stream) {
  return launch_filaments<double>(mid, hedge, valid, gid, packed, bounds, out, ny, nz, R, lx,
                                  ly, lz, two_r, coef, n_edges, margin, eps, noise_c, stream);
}

}  // extern "C"
