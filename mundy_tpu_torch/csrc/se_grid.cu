// Spectral-Ewald gridding: window spreading (kernel K5s) and interpolation
// (kernel K5i) on the periodic (G, G, G, 3) grid.
//
// Replaces the Pallas TPU kernels mundy_tpu/ops/pallas/se_grid.py
// (se_spread_rows_pre / _spread_kernel and se_interp_rows_pre /
// _interp_kernel) and keeps the contract of the app's tile gridding
// (se_spread_tiles / se_interp_tiles): particles binned into (G/m)^3 tiles
// of m grid points per edge, R slots each (ops/kernels/se_grid.se_bin_tiles
// gives perm, u = pos / h per slot and slot_of). Each slot spreads its force
// with the separable window over the P support points per axis at offsets
// -(P/2 - 1) .. P/2 from floor(u), wrapped periodically; interpolation is
// the transpose, times the quadrature cell volume h^3. Window: ES (exp of a
// semicircle, zero outside |d| < P/2) or the truncated Gaussian.
//
// K5s design: output-stationary gather, no float atomics. One thread block
// per tile, one thread per grid point of the tile (m^3 = 512 at m = 8). The
// block walks the slots of the tile and of its distinct neighbour tiles as
// one list in a fixed order, a block-width batch at a time (27 R slots in
// ceil(27 R / 512) batches, so the dependent perm -> u -> force loads and
// the block syncs are paid per batch, not per neighbour tile), keeps those
// whose support meets the tile (an ordered block compaction: ballot and a
// warp scan), stages their P weights per axis, the offset of their support
// and their force in shared memory, and every thread adds the staged slots
// that cover its point, in list order. Each
// point's sum runs over the same slots in the same order on every run, so
// the grid repeats bit for bit, and a point is written once, by its own
// tile: no slab buffer and no fold pass. A slot's support stays inside the
// 27 tiles around its own when m >= P/2 + 1 (one grid point of slack for
// the rounding between the binning and floor(u)); the wrapper checks it.
//
// K5i design: one thread per particle gathers its P^3 x 3 grid values
// through slot_of (the unsort is the gather), weights them and scales by
// h^3.
//
// Dropped from the TPU kernels: the row slabs with their XPAD wrap pad and
// pl.ds rank-1 updates, the roll-based _combine_axis / _extract_axis folds,
// the placement GEMMs of the tile path and the _r_chunk split of R.
//
// Bound: the grid written (K5s) or read (K5i) once is 12 G^3 bytes
// (680 MB at G = 384, 0.20 ms at 3.35 TB/s) against ~1.7 GFLOP for 1M
// particles at P = 6, so both are bound by bytes. K5s re-reads its staged
// slots from shared memory for every point of the tile; K5i reads each grid
// value up to ~P^3 / m^3-fold from L2 through neighbouring particles.
//
// Built with -fmad=false like every kernel of the package, so each window
// product rounds as the plain version's (ops/kernels/se_grid.py) does; the
// sums run in another order.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_P = 16;

struct Window {
  int kind;     // 0 = ES, 1 = Gaussian
  double beta;  // ES shape parameter
  double wh;    // ES half-support in grid units (P / 2)
  double c;     // Gaussian exponent coefficient 2 xi^2 / eta
  double h;     // grid spacing
  double pref;  // Gaussian amplitude sqrt(c / pi)
};

template <typename T>
__device__ __forceinline__ T window_weight(T d, const Window& w) {
  if (w.kind == 0) {
    const T t = d / T(w.wh);
    const T s = sqrt(fmax(T(1) - t * t, T(0)));
    const T v = exp(T(w.beta) * (s - T(1)));
    return fabs(t) < T(1) ? v : T(0);
  }
  const T dx = d * T(w.h);
  return T(w.pref) * exp(-T(w.c) * dx * dx);
}

// Ordered compaction of one flag per thread over the block: returns the
// thread's rank among the flagged threads below it and sets `total`. Every
// thread of the block must call it (blockDim a multiple of 32).
__device__ int block_rank(bool flag, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < nw) warp_sums[lane] = v;  // inclusive prefix over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + in_warp;
}

template <typename T>
__global__ void se_spread_kernel(const T* __restrict__ u, const int* __restrict__ perm,
                                 const T* __restrict__ forces, T* __restrict__ grid,
                                 int n, int G, int m, int P, int R, int nt1, int cap,
                                 Window win) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_sums[32];
  T* sw = reinterpret_cast<T*>(smem_raw);  // [3][cap][P] window weights
  T* sf = sw + 3 * cap * P;                // [cap][3] forces
  int* srel = reinterpret_cast<int*>(sf + 3 * cap);  // [cap][3] support offsets

  const int t = blockIdx.x;
  const int tc[3] = {t / (nt1 * nt1), (t / nt1) % nt1, t % nt1};
  const int m3 = m * m * m;
  const int half = P / 2 - 1;
  // distinct neighbour-tile offsets per axis (fewer than 3 tiles per axis
  // would visit one tile twice)
  const int noff = nt1 >= 3 ? 3 : nt1;
  const int off0 = nt1 >= 3 ? -1 : 0;
  const int n_cand = noff * noff * noff * R;

  for (int p0 = 0; p0 < m3; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool own = p < m3;
    const int lx = own ? p / (m * m) : 0;
    const int ly = own ? (p / m) % m : 0;
    const int lz = own ? p % m : 0;
    T ax = T(0), ay = T(0), az = T(0);
    int cnt = 0;  // staged slots (the same value in every thread)

    auto flush = [&]() {
      if (own) {
        for (int j = 0; j < cnt; ++j) {
          int ox = lx - srel[3 * j];
          int oy = ly - srel[3 * j + 1];
          int oz = lz - srel[3 * j + 2];
          ox += ox < 0 ? G : 0;
          oy += oy < 0 ? G : 0;
          oz += oz < 0 ? G : 0;
          if (ox >= P || oy >= P || oz >= P) continue;
          T w = sw[j * P + ox] * sw[(cap + j) * P + oy];
          w = w * sw[(2 * cap + j) * P + oz];
          ax += w * sf[3 * j];
          ay += w * sf[3 * j + 1];
          az += w * sf[3 * j + 2];
        }
      }
    };

    // the neighbour tiles' slots as one list, (tile a, b, c, slot r) in
    // lexicographic order, walked a block-width batch at a time
    for (int i0 = 0; i0 < n_cand; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      size_t s = 0;
      int pid = n;
      if (i < n_cand) {
        const int nb = i / R;
        const int nx = (tc[0] + off0 + nb / (noff * noff) + nt1) % nt1;
        const int ny = (tc[1] + off0 + (nb / noff) % noff + nt1) % nt1;
        const int nz = (tc[2] + off0 + nb % noff + nt1) % nt1;
        s = static_cast<size_t>((nx * nt1 + ny) * nt1 + nz) * R + (i - nb * R);
        pid = perm[s];
      }
      bool flag = pid < n;
      int rel[3] = {0, 0, 0};
      T frac[3] = {T(0), T(0), T(0)};
      if (flag) {
        for (int d = 0; d < 3; ++d) {
          const T ud = u[3 * s + d];
          const T fl = floor(ud);
          frac[d] = ud - fl;
          int rr = (static_cast<int>(fl) - half - tc[d] * m) % G;
          rr += rr < 0 ? G : 0;
          rel[d] = rr;
          flag = flag && (rr < m || rr > G - P);
        }
      }
      int total;
      const int rank = block_rank(flag, warp_sums, total);
      if (cnt + total > cap) {  // block-uniform: no room for this batch
        flush();
        __syncthreads();
        cnt = 0;
      }
      if (flag) {
        const int e = cnt + rank;
        for (int d = 0; d < 3; ++d) {
          srel[3 * e + d] = rel[d];
          for (int k = 0; k < P; ++k) {
            const T off = T(k - half);
            sw[(d * cap + e) * P + k] = window_weight(off - frac[d], win);
          }
          sf[3 * e + d] = forces[3 * static_cast<size_t>(pid) + d];
        }
      }
      cnt += total;
      __syncthreads();
    }
    flush();
    if (own) {
      const size_t g = ((static_cast<size_t>(tc[0] * m + lx) * G + (tc[1] * m + ly)) * G
                        + (tc[2] * m + lz)) * 3;
      grid[g] = ax;
      grid[g + 1] = ay;
      grid[g + 2] = az;
    }
    __syncthreads();  // the staged slots are reused by the next point pass
  }
}

template <typename T>
__global__ void se_interp_kernel(const T* __restrict__ u, const int* __restrict__ slot_of,
                                 const T* __restrict__ grid, T* __restrict__ out, int n,
                                 int n_slots, int G, int P, Window win, T h3) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slot_of[i];
  T ax = T(0), ay = T(0), az = T(0);
  if (s < n_slots) {
    const int half = P / 2 - 1;
    T w[3][MAX_P];
    int b0[3];
    for (int d = 0; d < 3; ++d) {
      const T ud = u[3 * static_cast<size_t>(s) + d];
      const T fl = floor(ud);
      const T frac = ud - fl;
      b0[d] = static_cast<int>(fl) - half;
      for (int k = 0; k < P; ++k) w[d][k] = window_weight(T(k - half) - frac, win);
    }
    for (int a = 0; a < P; ++a) {
      int gx = (b0[0] + a) % G;
      gx += gx < 0 ? G : 0;
      for (int b = 0; b < P; ++b) {
        int gy = (b0[1] + b) % G;
        gy += gy < 0 ? G : 0;
        const T wxy = w[0][a] * w[1][b];
        const size_t row = (static_cast<size_t>(gx) * G + gy) * G;
        for (int c = 0; c < P; ++c) {
          int gz = (b0[2] + c) % G;
          gz += gz < 0 ? G : 0;
          const T wt = wxy * w[2][c];
          const T* v = grid + (row + gz) * 3;
          ax += wt * v[0];
          ay += wt * v[1];
          az += wt * v[2];
        }
      }
    }
  }
  out[3 * static_cast<size_t>(i)] = ax * h3;
  out[3 * static_cast<size_t>(i) + 1] = ay * h3;
  out[3 * static_cast<size_t>(i) + 2] = az * h3;
}

Window make_window(int kind, double beta, double wh, double c, double h, double pref) {
  Window w;
  w.kind = kind;
  w.beta = beta;
  w.wh = wh;
  w.c = c;
  w.h = h;
  w.pref = pref;
  return w;
}

template <typename T>
size_t spread_smem(int cap, int P) {
  return static_cast<size_t>(cap) * (3 * P * sizeof(T) + 3 * sizeof(T) + 3 * sizeof(int));
}

template <typename T>
int launch_spread(const void* u, const void* perm, const void* forces, void* grid, int n,
                  int G, int m, int P, int R, int kind, double beta, double wh, double c,
                  double h, double pref, void* stream) {
  if (P < 1 || P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  const int nt1 = G / m;
  const int m3 = m * m * m;
  const int threads = m3 >= 512 ? 512 : ((m3 + 31) / 32) * 32;
  // staged slots between flushes (>= one batch; 768 x 228 B fits float64
  // at P = 8 in the 227 KB a block may opt into)
  const int cap = threads + threads / 2;
  const size_t smem = spread_smem<T>(cap, P);
  cudaError_t err = cudaFuncSetAttribute(se_spread_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  se_spread_kernel<T><<<nt1 * nt1 * nt1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int*>(perm),
      static_cast<const T*>(forces), static_cast<T*>(grid), n, G, m, P, R, nt1, cap,
      make_window(kind, beta, wh, c, h, pref));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp(const void* u, const void* slot_of, const void* grid, void* out, int n,
                  int n_slots, int G, int P, int kind, double beta, double wh, double c,
                  double h, double pref, double h3, void* stream) {
  if (P < 1 || P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  se_interp_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int*>(slot_of),
      static_cast<const T*>(grid), static_cast<T*>(out), n, n_slots, G, P,
      make_window(kind, beta, wh, c, h, pref), static_cast<T>(h3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int se_spread_f32(const void* u, const void* perm, const void* forces, void* grid, int n,
                  int G, int m, int P, int R, int kind, double beta, double wh, double c,
                  double h, double pref, void* stream) {
  return launch_spread<float>(u, perm, forces, grid, n, G, m, P, R, kind, beta, wh, c, h,
                              pref, stream);
}

int se_spread_f64(const void* u, const void* perm, const void* forces, void* grid, int n,
                  int G, int m, int P, int R, int kind, double beta, double wh, double c,
                  double h, double pref, void* stream) {
  return launch_spread<double>(u, perm, forces, grid, n, G, m, P, R, kind, beta, wh, c, h,
                               pref, stream);
}

int se_interp_f32(const void* u, const void* slot_of, const void* grid, void* out, int n,
                  int n_slots, int G, int P, int kind, double beta, double wh, double c,
                  double h, double pref, double h3, void* stream) {
  return launch_interp<float>(u, slot_of, grid, out, n, n_slots, G, P, kind, beta, wh, c, h,
                              pref, h3, stream);
}

int se_interp_f64(const void* u, const void* slot_of, const void* grid, void* out, int n,
                  int n_slots, int G, int P, int kind, double beta, double wh, double c,
                  double h, double pref, double h3, void* stream) {
  return launch_interp<double>(u, slot_of, grid, out, n, n_slots, G, P, kind, beta, wh, c,
                               h, pref, h3, stream);
}

}  // extern "C"
