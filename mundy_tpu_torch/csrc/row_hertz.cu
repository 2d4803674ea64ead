// Masked full-stencil Hertzian forces on the row layout (kernel K6).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/row_hertz.py
// (row_hertzian_forces / _kernel) and keeps its contract:
//   * input: (ny, nz, R, 3) positions in the periodic box and a (ny, nz, R)
//     validity mask; a pair counts only when both slots are valid, and a
//     slot never meets itself. No sentinel is relied on and no candidate row
//     is pre-shifted: every pair takes the minimum image on all three axes,
//     d -= l * rint(d / l) for a box length l (rint is round-half-even, as
//     jnp.round);
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
// Design. The first design gave every slot of a row one thread and walked
// all 9R staged candidates with the full pair arithmetic up to the contact
// test (1.72 ms at polydisperse config #1's 1M spheres, 120 x 120 rows of R
// = 120 over lx = 219, where a sphere has ~600 valid candidates, ~8 within
// reach in x and ~0.4 in contact). This design visits those and little
// else:
//   * padding: a warp per staged row packs that row's occupied slots, in
//     slot order, into shared memory by ballot (one 16-byte x, y, z, radius
//     entry per slot in float32, 32 bytes in float64), so only occupied
//     slots are own slots or candidates;
//   * lanes per own sphere: L = 8 lanes (a group) share one
//     own sphere, and a warp serves 32 / L neighbouring own spheres at a
//     time, so it runs the union of few windows (one thread per own sphere
//     runs the union of 32 windows, nearly whole rows at this density, as
//     csrc/row_central.cu notes for K1). A chunk is L packed slots, one per
//     lane;
//   * chunk x-window: per chunk the least and greatest x and the greatest
//     radius, taken from the current positions, so rows that drifted out of
//     their x order since the last sort stay exact. The lanes of a group test
//     L chunks at a time (chunk_visit) and visit those whose x range, under
//     the minimum image the pairs take, can come within (ro + r_max)^2
//     (1 + 2^-10) in x;
//   * early stop: a pair with r2 > cut2 = RN(RN(s s)(1 + 2^-10)), s = ro +
//     rc, stops after its r2, before the rsqrt;
//   * order: a visited chunk's lanes evaluate one candidate each; the pairs
//     in contact are found by ballot, and the group adds their terms one by
//     one in candidate order (shuffled from the lane that holds each), all
//     lanes of the group carrying the same sums.
// Each own sphere's sum is then the first design's sequence of terms,
// candidate rows b = 0..8 and slots in order, with only pairs that the
// first design also skipped left out (it skipped, and added nothing for, a
// pair with !(delta > 0)), and each term by the same operations: the forces
// are bit for bit the first design's, padded slots' +0 included, and two
// launches are bit-equal (no atomics).
//
// Why a skipped pair is one that the first design skipped too. rsqrtf is
// within 2 ulp (rsqrt in float64 within 1), so with r2 > cut2 >= s^2 (1 +
// 2^-10)(1 - 2u)^2 (u = 2^-24 in float32, 2^-53 in float64) the first
// design's RN(r2 rinv) >= sqrt(r2)(1 - 2^-22)(1 - u) >= s (1 + 4.87e-4)(1 -
// 3.6e-7) > s, and delta = RN(s - RN(r2 rinv)), which has no FMA (the
// kernels build with -fmad=false), is <= 0: the pair added nothing. The
// margin is ~1300x what the rounding needs in float32. (A negative s, which
// no radius plane gives, has delta < 0 either way.) The chunk window: the x
// separation is RN(d - RN(lx k)) with d = RN(ox - x) and k = rint(RN(d
// inv_lx)): d is monotonic in x, k is monotonic in d, and for one image k the
// separation is monotonic in d, so every slot of a chunk whose x lies in
// [a, b] has |dx| >= m, the bound chunk_visit takes from RN(ox - b) and
// RN(ox - a) by the same operations; r2 = max(RN(dz^2 + RN(dy^2 +
// RN(dx^2))), 1e-24) >= RN(dx^2) >= RN(m^2), and a pair's cut2 is at most
// the chunk's, RN(RN(S S)(1 + 2^-10)) with S = RN(ro + r_max) >= RN(ro +
// rc). So a chunk with RN(m^2) > that cut holds only pairs the early stop
// rejects. The CPU tests hold the plain version to exact zeros on every pair
// that ops/kernels/row_hertz.contact_reach (this test, operation for
// operation) rejects.
//
// Dropped from the TPU kernel, because they exist only for the TPU: the
// three y-plane BlockSpecs, the pltpu.roll z-neighbours through VMEM
// scratch, the z-chunk loop and the (R, R) pair blocks.
//
// Arithmetic. The kernels build with -fmad=false (ops/kernels/_build.py);
// this kernel writes the fused multiply-adds of r2 and of the sums out
// (fma_), as K1 does, within the 5e-5 contract of its plain version.
//
// Bound. Counted from the algorithm (chip_smoke.py [24]): per unordered
// occupied pair within its own contact distance in x, K1's 12 FP32
// operations and 2 more for ro + rc and its square, the rest of the pair
// arithmetic per pair in contact: 0.0007 ms at polydisperse config #1, so
// the bytes bound it: the valid byte and the forces of every slot, the
// position and the radius of each occupied slot (38.5 MB, 0.0115 ms). What
// the design does beyond that: every pair is evaluated from both sides,
// each row is staged 9 times (once per neighbouring block, from L2), and a
// visited chunk costs L lanes for its ~1-2 candidates within reach.
//
// Shared memory: 36 R itemsize + 36 ceil(R / L) itemsize + 4 R + 36 bytes
// per block (ops/kernels/row_hertz.shared_bytes): the largest R on an H100
// is 1400 in float32 and 708 in float64.

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
__device__ __forceinline__ T inf_();
template <>
__device__ __forceinline__ float inf_<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double inf_<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// One packed slot: x, y, z and radius, one 16-byte load in float32.
template <typename T>
struct alignas(4 * sizeof(T)) Slot {
  T x, y, z, r;
};

// One chunk of L packed slots: least and greatest x, greatest radius.
template <typename T>
struct alignas(4 * sizeof(T)) Chunk {
  T lo, hi, rmax, pad;
};

// Lanes per own sphere and packed slots per chunk. In trials on the card at
// polydisperse config #1 (1M spheres, R = 120), 4, 8, 16 and 32 lanes gave
// the same bits in 1.10-1.12, 0.76-0.77, 0.95 and 1.38-1.41 ms.
constexpr int L = 8;
static_assert(32 % L == 0 && L < 32, "a group is part of one warp");

template <typename T>
__device__ __forceinline__ T min_image(T d, T l, T inv_l) {
  return d - l * rint_(d * inv_l);
}

// Can a chunk whose slots have x in [a, b] (a > b when it is empty) come
// within cut2 of an own sphere at ox? The x separation is taken as the pair
// arithmetic takes it, RN(d - RN(lx k)) with d = RN(ox - x) and k =
// rint(RN(d inv_lx)): d lies in [RN(ox - b), RN(ox - a)], k is monotonic in d
// and, for one k, the separation is monotonic in d, so every slot's
// separation lies in [sa, sb] (one image), or is >= sa for the slots of
// image ka and <= sb for those of image ka + 1 (one flip); more images than
// two are always visited.
template <typename T>
__device__ __forceinline__ bool chunk_visit(T a, T b, T ox, T cut2, T lx, T inv_lx) {
  if (!(a <= b)) return false;
  const T da = ox - b;
  const T db = ox - a;
  const T ka = rint_(da * inv_lx);
  const T kb = rint_(db * inv_lx);
  const T sa = da - lx * ka;
  const T sb = db - lx * kb;
  T m = T(0);
  if (ka == kb) {
    m = sa > T(0) ? sa : (sb < T(0) ? -sb : T(0));
  } else if (kb == ka + T(1)) {
    m = fmin(fmax(sa, T(0)), fmax(-sb, T(0)));
  }
  return !(m * m > cut2);
}

template <typename T>
__global__ void row_hertz_kernel(const T* __restrict__ pos,
                                 const unsigned char* __restrict__ valid,
                                 const T* __restrict__ radii, T* __restrict__ out,
                                 int ny, int nz, int R, T lx, T inv_lx, T ly, T inv_ly,
                                 T lz, T inv_lz, T coef, T margin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (R + L - 1) / L;  // chunks per staged row
  Slot<T>* cp = reinterpret_cast<Slot<T>*>(smem_raw);         // [9][R] packed slots
  Chunk<T>* ck = reinterpret_cast<Chunk<T>*>(cp + 9 * R);     // [9][nc] chunk bounds
  int* own_slot = reinterpret_cast<int*>(ck + 9 * nc);        // [R] slot of own entry
  int* count = own_slot + R;                                  // [9] packed slots per row

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  // Pack the occupied slots of the 9 candidate rows (wrapped, not shifted),
  // one row per warp at a time; block b = (dy + 1) * 3 + (dz + 1), the order
  // of rows._candidate_planes.
  for (int b = warp; b < 9; b += nw) {
    const int jy = (iy + b / 3 - 1 + ny) % ny;
    const int jz = (iz + b % 3 - 1 + nz) % nz;
    const size_t base = (static_cast<size_t>(jy) * nz + jz) * R;
    const T* src = pos + base * 3;
    int n = 0;
    for (int k0 = 0; k0 < R; k0 += 32) {
      const int k = k0 + lane;
      const bool v = k < R && valid[base + k] != 0;
      const unsigned took = __ballot_sync(0xffffffffu, v);
      if (v) {
        const int at = n + __popc(took & ((1u << lane) - 1u));
        cp[b * R + at] = Slot<T>{src[3 * k], src[3 * k + 1], src[3 * k + 2], radii[base + k]};
        if (b == 4) own_slot[at] = k;
      }
      n += __popc(took);
    }
    if (lane == 0) count[b] = n;
  }
  T* orow = out + static_cast<size_t>(row) * R * 3;
  const unsigned char* vrow = valid + static_cast<size_t>(row) * R;
  for (int k = threadIdx.x; k < R; k += blockDim.x) {  // a padded own slot's forces are +0
    if (vrow[k] == 0) {
      orow[3 * k] = T(0);
      orow[3 * k + 1] = T(0);
      orow[3 * k + 2] = T(0);
    }
  }
  __syncthreads();

  for (int q = threadIdx.x; q < 9 * nc; q += blockDim.x) {
    const int b = q / nc;
    const int from = (q - b * nc) * L;
    const int to = min(from + L, count[b]);
    T lo = inf_<T>(), hi = -inf_<T>(), rm = -inf_<T>();
    for (int j = from; j < to; ++j) {
      const Slot<T> p = cp[b * R + j];
      lo = fmin(lo, p.x);
      hi = fmax(hi, p.x);
      rm = fmax(rm, p.r);
    }
    ck[q] = Chunk<T>{lo, hi, rm, T(0)};
  }
  __syncthreads();

  // A group of L lanes per own sphere; its lanes test L chunks, then the
  // L candidates of each visited chunk, at a time. Every loop below is
  // uniform across a group, whose lanes alone meet in its ballots and
  // shuffles.
  const int gl = lane % L;             // lane within the group
  const int gshift = lane - gl;        // the group's first lane in the warp
  const unsigned gmask = ((1u << L) - 1u) << gshift;
  const int n_groups = blockDim.x / L;
  const int n_own = count[4];
  for (int t = threadIdx.x / L; t < n_own; t += n_groups) {
    const Slot<T> o = cp[4 * R + t];  // own row = centre block
    T fx = T(0), fy = T(0), fz = T(0);
    for (int b = 0; b < 9; ++b) {
      const int nb = count[b];
      const int nch = (nb + L - 1) / L;
      const Slot<T>* rowp = cp + b * R;
      const Chunk<T>* chp = ck + b * nc;
      for (int c0 = 0; c0 < nch; c0 += L) {
        bool vis = false;
        if (c0 + gl < nch) {
          const Chunk<T> c = chp[c0 + gl];
          const T S = o.r + c.rmax;
          vis = chunk_visit(c.lo, c.hi, o.x, S * S * margin, lx, inv_lx);
        }
        unsigned todo = (__ballot_sync(gmask, vis) & gmask) >> gshift;
        while (todo) {
          const int cc = c0 + __ffs(todo) - 1;
          todo &= todo - 1u;
          const int j = cc * L + gl;
          bool hit = false;
          T w = T(0), dx = T(0), dy = T(0), dz = T(0);
          if (j < nb && !(b == 4 && j == t)) {
            const Slot<T> p = rowp[j];
            dx = min_image(o.x - p.x, lx, inv_lx);
            dy = min_image(o.y - p.y, ly, inv_ly);
            dz = min_image(o.z - p.z, lz, inv_lz);
            const T r2 = fmax(fma_(dz, dz, fma_(dy, dy, dx * dx)), T(1e-24));
            const T s = o.r + p.r;
            if (!(r2 > s * s * margin)) {  // else out of contact: it adds nothing
              const T rinv = rsqrt_(r2);
              const T delta = s - r2 * rinv;
              if (delta > T(0)) {
                const T c = coef * sqrt_((o.r * p.r) / fmax(s, T(1e-12)));
                w = (c * delta * sqrt_(delta)) * rinv;
                hit = true;
              }
            }
          }
          unsigned hits = (__ballot_sync(gmask, hit) & gmask) >> gshift;
          while (hits) {  // the terms in candidate order
            const int src = __ffs(hits) - 1;
            hits &= hits - 1u;
            const T ws = __shfl_sync(gmask, w, src, L);
            fx = fma_(ws, __shfl_sync(gmask, dx, src, L), fx);
            fy = fma_(ws, __shfl_sync(gmask, dy, src, L), fy);
            fz = fma_(ws, __shfl_sync(gmask, dz, src, L), fz);
          }
        }
      }
    }
    if (gl == 0) {
      T* o_out = orow + 3 * own_slot[t];
      o_out[0] = fx;
      o_out[1] = fy;
      o_out[2] = fz;
    }
  }
}

template <typename T>
size_t smem_bytes(int R) {
  const int nc = (R + L - 1) / L;
  return static_cast<size_t>(9) * R * sizeof(Slot<T>) +
         static_cast<size_t>(9) * nc * sizeof(Chunk<T>) +
         (static_cast<size_t>(R) + 9) * sizeof(int);
}

template <typename T>
int launch(const void* pos, const void* valid, const void* radii, void* out, int ny, int nz,
           int R, double lx, double ly, double lz, double coef, double margin, void* stream) {
  const int threads = 128;
  const size_t smem = smem_bytes<T>(R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        row_hertz_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  row_hertz_kernel<T><<<ny * nz, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const unsigned char*>(valid),
      static_cast<const T*>(radii), static_cast<T*>(out), ny, nz, R, T(lx), T(1.0 / lx),
      T(ly), T(1.0 / ly), T(lz), T(1.0 / lz), T(coef), T(margin));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// valid: (ny, nz, R) bytes, nonzero where a slot holds a sphere; radii: the
// (ny, nz, R) radius plane in the positions' dtype; coef = (4/3) E*; margin:
// the early stop's factor 1 + 2^-10 on the squared contact distance.
// Returns cudaGetLastError() after the launch (0 = launched).
int row_hertzian_forces_f32(const void* pos, const void* valid, const void* radii, void* out,
                            int ny, int nz, int R, double lx, double ly, double lz,
                            double coef, double margin, void* stream) {
  return launch<float>(pos, valid, radii, out, ny, nz, R, lx, ly, lz, coef, margin, stream);
}

int row_hertzian_forces_f64(const void* pos, const void* valid, const void* radii, void* out,
                            int ny, int nz, int R, double lx, double ly, double lz,
                            double coef, double margin, void* stream) {
  return launch<double>(pos, valid, radii, out, ny, nz, R, lx, ly, lz, coef, margin, stream);
}

}  // extern "C"
