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
// K5s design: output-stationary gather, no float atomics, two kernels per
// call (one se_spread launch). A pre-pass, one warp per tile, writes each
// tile's extent, 1 + its last occupied slot (se_bin_tiles packs occupied
// slots first, so the extent is the tile's count, at most R), read from perm
// on the device. Then one thread block per tile, whose threads each own a
// run of LZ = 4 grid points along z (m^2 ceil(m/4) threads, 128 at m = 8).
// The block walks the occupied slots of its tile and of the distinct
// neighbour tiles as one list (tiles (a, b, c) in lexicographic order, slots
// in order, each tile up to its extent: ~256 candidates at config #5's 9.5
// beads per tile), a block-width batch at a time. A candidate is kept when
// its support meets the tile; the kept ones are compacted in list order
// (ballot, per-warp counts, two barriers per batch). Once per flush, one
// thread per (kept slot, axis) evaluates the slot's P window weights and
// stores them tile-relative: m weights per axis (padded to a multiple of
// 4), zero where the support misses the tile, and the slot's force. Every
// thread then adds the staged slots to its run of points, in list order:
// one product w_x w_y per staged slot, skipped where it is zero, then LZ
// products with w_z into LZ x 3 register sums. A skipped term is an exact
// zero, and adding +-0 to a sum that starts at +0 leaves it unchanged, so
// each point's sum is the plain version's set of terms in a fixed order:
// the grid repeats bit for bit, and a point is written once, by its own
// tile, with no slab buffer and no fold pass. A slot's support stays inside
// the 27 tiles around its own when m >= P/2 + 1 (one grid point of slack for
// the rounding between the binning and floor(u)) and P <= G; the wrapper
// checks both.
//
// What bounds K5s on this card, and what the design does about it. The
// grid written once (680 MB at G = 384) bounds it by bytes; the work in the
// way was a walk over padding. (1) Padding: the walk stops at each tile's
// extent, not at R (~256 of 2808 candidate slots at config #5). (2) Serial
// load chains: perm and u are loaded together, and only the kept slots
// gather their force, once per flush; a batch is one ballot and two
// barriers, not three. (3) Wasted tests: a thread owns a line of points, so
// the in-support test is one product per staged slot and line instead of
// three integer tests per point, and a staged slot's window is evaluated
// once per tile that keeps it, not per point. (4) Occupancy: 128 threads
// and 15 KB of shared memory per block at m = 8 (float32; was 512 threads
// and 74 KB), so 9 blocks share an SM instead of 3 (its 56 registers a
// thread bound it there).
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
// slots from shared memory for every run of LZ points of the tile; K5i reads
// each grid value up to ~P^3 / m^3-fold from L2 through neighbouring
// particles.
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

constexpr int LZ = 4;  // grid points of a z-line per K5s thread

// One warp per tile: 1 + the last occupied slot of each tile (0 if empty).
__global__ void se_tile_extent_kernel(const int* __restrict__ perm, int* __restrict__ ext,
                                      int n, int n_tiles, int R) {
  const int tile = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;  // the whole warp
  const int* p = perm + static_cast<size_t>(tile) * R;
  int e = 0;
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int r = r0 + lane;
    const unsigned occ = __ballot_sync(0xffffffffu, r < R && p[r] < n);
    if (occ) e = r0 + 32 - __clz(occ);
  }
  if (lane == 0) ext[tile] = e;
}

template <typename T>
struct Quad {
  T v[4];
};

__device__ __forceinline__ Quad<float> load4(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
}

__device__ __forceinline__ Quad<double> load4(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {{a.x, a.y, b.x, b.y}};
}

// Bytes of shared memory per staged slot: 3 mp tile-relative weights, the
// force padded to 4, the slot and the particle id.
template <typename T>
size_t spread_slot_bytes(int mp) {
  return static_cast<size_t>(3 * mp + 4) * sizeof(T) + 2 * sizeof(int);
}

template <typename T>
__global__ void se_spread_kernel(const T* __restrict__ u, const int* __restrict__ perm,
                                 const T* __restrict__ forces, const int* __restrict__ ext,
                                 T* __restrict__ grid, int n, int G, int m, int mp, int P,
                                 int R, int nt1, int cap, Window win) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);           // [cap][3][mp] weights
  T* sf = sw + static_cast<size_t>(cap) * 3 * mp;  // [cap][4] forces
  int* sslot = reinterpret_cast<int*>(sf + 4 * static_cast<size_t>(cap));  // [cap]
  int* spid = sslot + cap;                                                  // [cap]
  __shared__ int s_tile[27];     // the distinct neighbour tiles
  __shared__ int s_pre[28];      // exclusive prefix of their extents
  __shared__ int s_wsum[32];     // kept candidates per warp

  const int t = blockIdx.x;
  const int tc[3] = {t / (nt1 * nt1), (t / nt1) % nt1, t % nt1};
  const int half = P / 2 - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // distinct neighbour-tile offsets per axis (fewer than 3 tiles per axis
  // would visit one tile twice)
  const int noff = nt1 >= 3 ? 3 : nt1;
  const int off0 = nt1 >= 3 ? -1 : 0;
  const int n_nb = noff * noff * noff;

  if (warp == 0) {
    int c = 0;
    if (lane < n_nb) {
      const int nx = (tc[0] + off0 + lane / (noff * noff) + nt1) % nt1;
      const int ny = (tc[1] + off0 + (lane / noff) % noff + nt1) % nt1;
      const int nz = (tc[2] + off0 + lane % noff + nt1) % nt1;
      const int nb = (nx * nt1 + ny) * nt1 + nz;
      s_tile[lane] = nb;
      c = ext[nb];
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += y;
    }
    if (lane < n_nb) s_pre[lane + 1] = c;
    if (lane == 0) s_pre[0] = 0;
  }
  __syncthreads();
  const int total = s_pre[n_nb];
  const int nseg = mp / LZ;
  const int items = m * m * nseg;

  for (int it0 = 0; it0 < items; it0 += blockDim.x) {
    const int item = it0 + threadIdx.x;
    const bool own = item < items;
    const int line = own ? item / nseg : 0;
    const int z0 = own ? (item - line * nseg) * LZ : 0;
    const int lx = line / m;
    const int ly = line - lx * m;
    T acc[LZ][3];
#pragma unroll
    for (int k = 0; k < LZ; ++k) acc[k][0] = acc[k][1] = acc[k][2] = T(0);
    int cnt = 0;  // staged slots (the same value in every thread)

    // weights of the staged slots, then their sums into this thread's run
    auto flush = [&]() {
      for (int q = threadIdx.x; q < 3 * cnt; q += blockDim.x) {
        const int e = q / 3;
        const int d = q - 3 * e;
        const size_t s = static_cast<size_t>(sslot[e]);
        const T ud = u[3 * s + d];
        const T fl = floor(ud);
        const T frac = ud - fl;
        int rel = (static_cast<int>(fl) - half - tc[d] * m) % G;
        rel += rel < 0 ? G : 0;
        T* w = sw + (static_cast<size_t>(e) * 3 + d) * mp;
        for (int l = 0; l < mp; ++l) {
          int k = l - rel;  // support point k lands on tile point l
          k += k < 0 ? G : 0;
          w[l] = (l < m && k < P) ? window_weight(T(k - half) - frac, win) : T(0);
        }
        if (d == 0) {
          const size_t pid = static_cast<size_t>(spid[e]);
          sf[4 * e] = forces[3 * pid];
          sf[4 * e + 1] = forces[3 * pid + 1];
          sf[4 * e + 2] = forces[3 * pid + 2];
          sf[4 * e + 3] = T(0);
        }
      }
      __syncthreads();
      if (own) {
        for (int j = 0; j < cnt; ++j) {
          const T* w = sw + static_cast<size_t>(j) * 3 * mp;
          const T wxy = w[lx] * w[mp + ly];
          if (wxy == T(0)) continue;  // an exact-zero term
          const Quad<T> wz = load4(w + 2 * mp + z0);
          const Quad<T> f = load4(sf + 4 * j);
#pragma unroll
          for (int k = 0; k < LZ; ++k) {
            const T wt = wxy * wz.v[k];
            acc[k][0] += wt * f.v[0];
            acc[k][1] += wt * f.v[1];
            acc[k][2] += wt * f.v[2];
          }
        }
      }
    };

    for (int i0 = 0; i0 < total; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      bool flag = false;
      int s = 0, pid = n;
      if (i < total) {
        int nb = 0;
        while (s_pre[nb + 1] <= i) ++nb;
        s = s_tile[nb] * R + (i - s_pre[nb]);
        pid = perm[s];
        flag = true;
        for (int d = 0; d < 3; ++d) {  // does the support meet the tile?
          const int fl = static_cast<int>(floor(u[3 * static_cast<size_t>(s) + d]));
          int rel = (fl - half - tc[d] * m) % G;
          rel += rel < 0 ? G : 0;
          flag = flag && (rel < m || rel > G - P);
        }
        flag = flag && pid < n;
      }
      const unsigned kept = __ballot_sync(0xffffffffu, flag);
      if (lane == 0) s_wsum[warp] = __popc(kept);
      __syncthreads();
      int before = 0, batch = 0;
      for (int w2 = 0; w2 < nw; ++w2) {
        const int v = s_wsum[w2];
        before += w2 < warp ? v : 0;
        batch += v;
      }
      if (cnt + batch > cap) {  // block-uniform: no room for this batch
        flush();
        __syncthreads();
        cnt = 0;
      }
      if (flag) {
        const int e = cnt + before + __popc(kept & ((1u << lane) - 1u));
        sslot[e] = s;
        spid[e] = pid;
      }
      cnt += batch;
      __syncthreads();
    }
    flush();
    if (own) {
      const size_t g = ((static_cast<size_t>(tc[0] * m + lx) * G + (tc[1] * m + ly)) * G
                        + (tc[2] * m + z0)) * 3;
#pragma unroll
      for (int k = 0; k < LZ; ++k) {
        if (z0 + k < m) {
          grid[g + 3 * k] = acc[k][0];
          grid[g + 3 * k + 1] = acc[k][1];
          grid[g + 3 * k + 2] = acc[k][2];
        }
      }
    }
    __syncthreads();  // the staged slots are reused by the next pass
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
int launch_spread(const void* u, const void* perm, const void* forces, void* ext,
                  void* grid, int n, int G, int m, int P, int R, int kind, double beta,
                  double wh, double c, double h, double pref, void* stream) {
  if (P < 1 || P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt1 = G / m;
  const int n_tiles = nt1 * nt1 * nt1;
  se_tile_extent_kernel<<<(n_tiles + 7) / 8, 256, 0, st>>>(static_cast<const int*>(perm),
                                                           static_cast<int*>(ext), n,
                                                           n_tiles, R);
  const int mp = (m + LZ - 1) / LZ * LZ;
  const int items = m * m * (mp / LZ);
  // one thread per run of LZ points (up to 512, looping over passes), and
  // room for one batch of kept slots after a flush, within 200 KB
  int threads = items >= 512 ? 512 : (items + 31) / 32 * 32;
  while (threads > 32 && threads * spread_slot_bytes<T>(mp) > 200 * 1024) threads -= 32;
  const int cap = threads;
  const size_t smem = cap * spread_slot_bytes<T>(mp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        se_spread_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  se_spread_kernel<T><<<n_tiles, threads, smem, st>>>(
      static_cast<const T*>(u), static_cast<const int*>(perm),
      static_cast<const T*>(forces), static_cast<const int*>(ext), static_cast<T*>(grid), n,
      G, m, mp, P, R, nt1, cap, make_window(kind, beta, wh, c, h, pref));
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
// ext: (n_tiles,) int32 scratch for the tile extents.
int se_spread_f32(const void* u, const void* perm, const void* forces, void* ext, void* grid,
                  int n, int G, int m, int P, int R, int kind, double beta, double wh,
                  double c, double h, double pref, void* stream) {
  return launch_spread<float>(u, perm, forces, ext, grid, n, G, m, P, R, kind, beta, wh, c,
                              h, pref, stream);
}

int se_spread_f64(const void* u, const void* perm, const void* forces, void* ext, void* grid,
                  int n, int G, int m, int P, int R, int kind, double beta, double wh,
                  double c, double h, double pref, void* stream) {
  return launch_spread<double>(u, perm, forces, ext, grid, n, G, m, P, R, kind, beta, wh, c,
                               h, pref, stream);
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
