// Hertzian central forces on the dense row layout (kernel K1).
//
// Replaces the Pallas TPU kernel mundy_tpu/ops/pallas/row_central.py
// (row_hertzian_forces_sym / _sym_kernel) and keeps its arithmetic contract:
//   * input: (ny, nz, R, 3) positions from build_rows, whose invalid slots
//     hold a sentinel far outside the box (a sentinel pair lies beyond the
//     contact distance and a self-pair has sep = 0), and the (ny, nz, R)
//     valid mask (the wrapper passes one of all ones when the caller gives
//     none);
//   * candidate rows (y+dy, z+dz) are pre-shifted to the periodic image
//     nearest the own row (as rows._roll_image_shift does), so a pair needs a
//     minimum image along x only, by round-half-even (rint);
//   * r2 is clamped at 1e-24; w = -(4/3) E* sqrt(R*) delta^{3/2} / d with
//     delta = max(2r - d, 0); f_i = sum_j w_ij (x_j - x_i).
//
// Design. The first design gave every slot of a row one thread and summed
// over all 9R staged slots with the full pair arithmetic (rsqrt and sqrt on
// every pair): 2.60 ms at config #1's shape. At config #1's 1M spheres (152 x 152 rows of R = 88) a row holds ~45
// spheres over lx = 219, and the contact reach is 2r = 1: of ~409 valid
// candidates of a sphere ~4 lie within reach in x and ~0.4 touch it. This
// design visits those and little else:
//   * padding: a warp per staged row packs that row's occupied slots, in
//     slot order, into shared memory by ballot (one 16-byte x, y, z, pad
//     entry per slot in float32, 32 bytes in float64), so no sentinel is an
//     own slot or a candidate, and only ceil(occupied / 32) warps own slots.
//     A mask of all ones (the wrapper's, for the reference's signature)
//     counts every slot as occupied: sentinels then add exact zeros, as in
//     the full scan, and the coincident sentinels of a row cost their full
//     pair arithmetic (the step passes build_rows' mask);
//   * chunk x-window: per chunk of CH = 32 packed slots the least and
//     greatest x (taken from the current positions, so rows that drifted out
//     of their x order since the last sort stay exact). An own sphere skips a
//     chunk whose x range, under the minimum image its pairs take, keeps
//     every pair's r2 above the cut (chunk_visit). A warp's own spheres are
//     neighbours in x, so it runs the union of their windows. At config #1 a
//     warp's 32 spheres span most of a row of ~45, so the window skips
//     little there; on fuller rows it skips most chunks (in trials on the
//     card, rows of ~140 and ~350 ran several times faster with it than
//     without, and chunks of 4, 8 and 16 slots, one test per warp against
//     the warp's x interval, and whole chunks unrolled over padded rows all
//     ran slower at config #1);
//   * early stop: a pair with r2 > cut2 = (2r)^2 (1 + 2^-10) stops after its
//     r2, before the rsqrt and the sqrt.
// Each own sphere's sum is then the first design's sequence of terms,
// candidate rows b = 0..8 and slots in order, with only exact-zero terms left
// out: adding +-0 to a sum that starts at +0 changes nothing (a sum of
// nonzero terms that cancels rounds to +0, never -0), so the forces are bit
// for bit the first design's, padded slots' +0 included, and two launches
// are bit-equal (no atomics).
//
// Why a skipped pair adds an exact zero. Padding: a sentinel lies ~1e6 box
// heights from every valid slot of another image, and two sentinels of one
// row coincide (d = 0, so w * 0 = 0): the first design's terms there are
// zeros, and an own sentinel's sum stays +0, which is written. The early
// stop: with cut2 = RN(RN(2r 2r) (1 + 2^-10)) >= (2r)^2 (1 + 2^-10)(1 - 2u)^2
// (u = 2^-24 in float32, 2^-53 in float64) and r2 > cut2, rsqrtf is within
// 2 ulp (rsqrt in float64 within 1), so r2 rinv, exact inside the fma, is at
// least sqrt(r2)(1 - 2.4e-7) >= 2r (1 + 4.87e-4)(1 - 3e-7) > 2r. Then
// fma(-r2, rinv, 2r) < 0, delta = max(., 0) = +0, w = -(coef 0 sqrt(0)) rinv
// = -0, and fma(w, d, f) = f. The margin is ~1600x what rounding needs in
// float32. The chunk window: within one image k the computed x separation
// fma(-lx, k, RN(x - ox)) is monotonic in x, and rint(RN(x - ox) / lx) is
// monotonic too, so every slot of a chunk has |dx| >= m, the bound
// chunk_visit takes from the chunk's extreme x; r2 = RN(dz^2 + RN(dy^2 +
// RN(dx^2))) >= RN(dx^2) >= RN(m^2) > cut2, so the chunk holds only pairs
// the early stop rejects. The CPU tests hold the plain version to exact
// zeros on every pair that ops/kernels/row_central.contact_reach (this
// test, operation for operation) rejects.
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
// Bound. Counted from the algorithm (chip_smoke.py [2]): 12 FP32 operations
// per unordered occupied pair within the cut in x (its separation and r2),
// 21 more per pair in contact (rsqrt, sqrt, the push and both sides' sums):
// at config #1's 1M spheres 1.78M and 0.20M pairs, 0.0004 ms, so the bytes
// bound it: the valid byte of every slot, the positions of the occupied
// slots read once and the forces of every slot written once, 38.4 MB
// (0.0115 ms at 3.35 TB/s). What this design does beyond that (0.57 ms,
// ~49x): a warp runs the union of its spheres' windows, nearly all ~409
// candidates per sphere for ~3.6 within the cut in x, each a shared-memory
// load and its r2 arithmetic up to the early stop (the pair loop takes most
// of the time; a trial without it ran in a fraction), every pair is
// evaluated from both sides, and each row is staged 9 times (once per
// neighbouring block, from L2). Fewer candidates per warp needs fewer own
// spheres per warp: several lanes per own sphere, with the rare passing
// terms added in order.
//
// Shared memory: (36 R + 18 ceil(R / 32)) itemsize + 4 R bytes per block,
// largest R 1546 in float32 and 783 in float64 on an H100 (the first
// design's 27 R itemsize allowed 2152 and 1076): a packed slot is 16 bytes
// in float32 and 32 in float64, a quarter of it padding.

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

constexpr int CH = 32;  // packed slots per chunk of the x window

// One packed slot: x, y, z (image-shifted) and a pad, one 16-byte load in
// float32.
template <typename T>
struct alignas(4 * sizeof(T)) Slot {
  T x, y, z, pad;
};

// Can a chunk whose slots have x in [a, b] (a > b when it is empty) come
// within the cut of an own sphere at ox? The x separation is taken as the
// pair arithmetic takes it, fma(-lx, k, d) with d = RN(x - ox) and
// k = rint(d / lx): d lies in [RN(a - ox), RN(b - ox)], k is monotonic in d
// and, for one k, the separation is monotonic in d, so every slot's
// separation lies in [sa, sb] (one image), or is >= sa for the slots of
// image ka and <= sb for those of image ka + 1 (one flip); more images than
// two are always visited.
template <typename T>
__device__ __forceinline__ bool chunk_visit(T a, T b, T ox, T cut2, T lx, T inv_lx) {
  if (!(a <= b)) return false;
  const T da = a - ox;
  const T db = b - ox;
  const T ka = rint_(da * inv_lx);
  const T sa = fma_(-lx, ka, da);
  const T kb = rint_(db * inv_lx);
  const T sb = fma_(-lx, kb, db);
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
                                 T* __restrict__ out, int ny, int nz, int R, T lx,
                                 T inv_lx, T ly, T lz, T two_r, T coef, T margin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = (R + CH - 1) / CH;  // chunks per staged row
  Slot<T>* cp = reinterpret_cast<Slot<T>*>(smem_raw);  // [9][R] packed slots
  T* clo = reinterpret_cast<T*>(cp + 9 * R);            // [9][nc] least x
  T* chi = clo + 9 * nc;                                // greatest x
  int* own_slot = reinterpret_cast<int*>(chi + 9 * nc);  // [R] slot of own entry
  __shared__ int count[9];                               // packed slots per row

  const int row = blockIdx.x;  // iy * nz + iz
  const int iy = row / nz;
  const int iz = row - iy * nz;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  // Pack the occupied slots of the 9 candidate rows, one row per warp at a
  // time; block b = (dy + 1) * 3 + (dz + 1), the order of
  // rows._candidate_planes.
  for (int b = warp; b < 9; b += nw) {
    int jy = iy + b / 3 - 1;
    int jz = iz + b % 3 - 1;
    T sy = T(0), sz = T(0);
    if (jy >= ny) { jy -= ny; sy = ly; } else if (jy < 0) { jy += ny; sy = -ly; }
    if (jz >= nz) { jz -= nz; sz = lz; } else if (jz < 0) { jz += nz; sz = -lz; }
    const size_t base = (static_cast<size_t>(jy) * nz + jz) * R;
    const T* src = pos + base * 3;
    int n = 0;
    for (int k0 = 0; k0 < R; k0 += 32) {
      const int k = k0 + lane;
      const bool v = k < R && valid[base + k] != 0;
      const unsigned took = __ballot_sync(0xffffffffu, v);
      if (v) {
        const int at = n + __popc(took & ((1u << lane) - 1u));
        cp[b * R + at] = Slot<T>{src[3 * k], src[3 * k + 1] + sy, src[3 * k + 2] + sz, T(0)};
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
    const int from = (q - b * nc) * CH;
    const int to = min(from + CH, count[b]);
    T lo = inf_<T>(), hi = -inf_<T>();
    for (int j = from; j < to; ++j) {
      lo = fmin(lo, cp[b * R + j].x);
      hi = fmax(hi, cp[b * R + j].x);
    }
    clo[q] = lo;
    chi[q] = hi;
  }
  __syncthreads();

  // One thread per own sphere, its sums in registers. A warp's spheres are
  // neighbours in slot order and so in x: it runs the union of their
  // windows.
  const T cut2 = two_r * two_r * margin;
  const int n_own = count[4];
  for (int t = threadIdx.x; t < n_own; t += blockDim.x) {
    const Slot<T> o = cp[4 * R + t];  // own row = centre block, unshifted
    T fx = T(0), fy = T(0), fz = T(0);
    for (int b = 0; b < 9; ++b) {
      const int nb = count[b];
      const Slot<T>* rowp = cp + b * R;
      for (int c = 0; c * CH < nb; ++c) {
        if (!chunk_visit(clo[b * nc + c], chi[b * nc + c], o.x, cut2, lx, inv_lx)) continue;
        const int end = min((c + 1) * CH, nb);
        for (int j = c * CH; j < end; ++j) {
          if (b == 4 && j == t) continue;  // the self pair adds w * 0 = 0
          const Slot<T> p = rowp[j];
          T dx = p.x - o.x;
          dx = fma_(-lx, rint_(dx * inv_lx), dx);
          const T dy = p.y - o.y;
          const T dz = p.z - o.z;
          const T r2 = fmax(fma_(dz, dz, fma_(dy, dy, dx * dx)), T(1e-24));
          if (!(r2 <= cut2)) continue;  // out of contact: an exact zero
          const T rinv = rsqrt_(r2);
          const T delta = fmax(fma_(-r2, rinv, two_r), T(0));  // 2r - |d|
          const T w = -(coef * delta * sqrt_(delta)) * rinv;
          fx = fma_(w, dx, fx);
          fy = fma_(w, dy, fy);
          fz = fma_(w, dz, fz);
        }
      }
    }
    T* o_out = orow + 3 * own_slot[t];
    o_out[0] = fx;
    o_out[1] = fy;
    o_out[2] = fz;
  }
}

template <typename T>
size_t smem_bytes(int R) {
  const int nc = (R + CH - 1) / CH;
  return static_cast<size_t>(9) * R * sizeof(Slot<T>) +
         static_cast<size_t>(2) * 9 * nc * sizeof(T) + static_cast<size_t>(R) * sizeof(int);
}

template <typename T>
int launch(const void* pos, const void* valid, void* out, int ny, int nz, int R,
           double lx, double ly, double lz, double two_r, double coef, double margin,
           void* stream) {
  const int threads = R >= 256 ? 256 : ((R + 31) / 32) * 32;
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
      static_cast<T*>(out), ny, nz, R, T(lx), T(1.0 / lx), T(ly), T(lz), T(two_r),
      T(coef), T(margin));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// valid: (ny, nz, R) bytes, nonzero where a slot holds a sphere; margin: the early stop's factor
// 1 + 2^-10 on the squared contact distance. Returns cudaGetLastError()
// after the launch (0 = launched).
int row_hertzian_forces_f32(const void* pos, const void* valid, void* out, int ny,
                            int nz, int R, double lx, double ly, double lz,
                            double two_r, double coef, double margin, void* stream) {
  return launch<float>(pos, valid, out, ny, nz, R, lx, ly, lz, two_r, coef, margin,
                       stream);
}

int row_hertzian_forces_f64(const void* pos, const void* valid, void* out, int ny,
                            int nz, int R, double lx, double ly, double lz,
                            double two_r, double coef, double margin, void* stream) {
  return launch<double>(pos, valid, out, ny, nz, R, lx, ly, lz, two_r, coef, margin,
                        stream);
}

}  // extern "C"
