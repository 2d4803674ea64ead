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
// K5i design. The first design gave each particle one thread, in gid
// order, that gathered its P^3 x 3 grid values from device memory (216 x 3
// scalar loads at P = 6, the 32 lanes of a warp on 32 unrelated z-runs) and
// read the grid in C order, so the wave apply copied the inverse FFT's
// planar output first (680 MB each way at G = 384). This design reads the
// grid where it lies and from shared memory:
//   * layout: the grid as three (G, G, G) planes, the channel axis
//     outermost, as the inverse FFT of the wave apply leaves it (the
//     wrapper raises on any other strides), so the wave apply passes that
//     output as it comes;
//   * order: one block per run of tz tiles along z (tz <= 4 dividing G/m;
//     their slots are one run of perm), which walks the occupied slots of
//     those tiles in slot order (a per-tile extent, then a prefix) and
//     writes each result to out[perm[s]]: beads of neighbouring tiles share
//     most of their support;
//   * staging: for a batch of up to 128 slots, one thread per (slot, axis)
//     computes the P window weights and the support start once (one
//     wrapped start per axis, not a % per point), the block takes the
//     bounding box of the starts and copies the box, P points wider, into
//     shared memory with cp.async: a warp per (channel, x) plane, its lanes
//     on consecutive z (16-byte copies where the planes keep them aligned),
//     every copy in flight at once; x-slabs of at most 12 KB in turn (in
//     trials on the card, smaller buffers and so more blocks per SM ran
//     faster, and so did 4 tiles per block against 1, 2 and 8, and 128
//     threads against 256);
//   * sums: one thread per (slot, channel) adds the slot's P^3 terms in the
//     first design's order, a, b, c nested, each product rounded as there
//     (no FMA), carried across x-slabs in shared memory, and scales by h^3:
//     every output is bit for bit the first design's, and two launches are
//     bit-equal (no atomics). A particle that binning dropped gets zero.
// A batch whose box will not fit (slots far outside their tiles, which the
// binning does not give) is redone slot by slot, each box P wide.
//
// Dropped from the TPU kernels: the row slabs with their XPAD wrap pad and
// pl.ds rank-1 updates, the roll-based _combine_axis / _extract_axis folds,
// the placement GEMMs of the tile path and the _r_chunk split of R.
//
// Bound: the grid written (K5s) or read (K5i) once is 12 G^3 bytes
// (680 MB at G = 384, 0.20 ms at 3.35 TB/s) against ~1.7 GFLOP for 1M
// particles at P = 6, so both are bound by bytes. K5s re-reads its staged
// slots from shared memory for every run of LZ points of the tile; K5i
// stages each grid value ~(13/8)^2 (37/32)-fold from L2 (the boxes of
// neighbouring blocks overlap by P - 1 points) and gathers its sums from
// shared memory with bank conflicts (32 lanes on ~11 slots at unrelated
// points); its phases (extents, weights, staging, sums) run in turn within a
// block, so its time follows the blocks an SM holds.
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

constexpr int WB = 128;    // K5i: slots per batch (weights, starts, sums in shared memory)
constexpr int TZ_MAX = 4;  // K5i: most tiles per block along z

__device__ __forceinline__ int wrap_(int x, int G) {
  x %= G;
  return x < 0 ? x + G : x;
}

// One value global -> shared without registers (cp.async, sm_80+); the
// copies land by cp_async_wait_all.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// One block per tz tiles along z; PC > 0 fixes the window support P at
// compile time.
template <typename T, int PC>
__global__ void se_interp_kernel(const T* __restrict__ u, const int* __restrict__ perm,
                                 const int* __restrict__ slot_of, const T* __restrict__ grid,
                                 T* __restrict__ out, int n, int n_slots, int G, int m,
                                 int P_rt, int R, int nt1, int tz, int cap, Window win,
                                 T h3) {
  const int P = PC > 0 ? PC : P_rt;
  // entries of an offset table, the widest box edge in x and y; even, so
  // the staged values after the table stay 16-byte aligned
  const int tbl = (3 * m + P + 1) & ~1;
  // 16-byte copies along z where the planes keep them aligned
  constexpr int V = 16 / sizeof(T);
  const bool vec = G % V == 0 && reinterpret_cast<size_t>(grid) % 16 == 0;
  const long long cs = static_cast<long long>(G) * G * G;  // channel stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* poff = reinterpret_cast<long long*>(smem_raw);  // [3 tbl] (channel, x) planes
  T* sg = reinterpret_cast<T*>(poff + 3 * tbl);              // [cap] staged grid values
  T* sw = sg + cap;                                          // [WB][3][P] window weights
  T* sacc = sw + WB * 3 * P;                                 // [WB][3] sums across x-slabs
  int* srel = reinterpret_cast<int*>(sacc + WB * 3);  // [WB][3] support starts
  int* spid = srel + 3 * WB;                          // [WB] particle id, -1 if empty
  int* yoff = spid + WB;                              // [tbl] y offsets
  __shared__ int s_box[6];           // least and greatest support start per axis
  __shared__ int s_pre[TZ_MAX + 1];  // exclusive prefix of the tiles' extents

  // the particles that binning dropped get zero (every block a share)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (slot_of[i] >= n_slots) {
      out[3 * static_cast<size_t>(i)] = T(0);
      out[3 * static_cast<size_t>(i) + 1] = T(0);
      out[3 * static_cast<size_t>(i) + 2] = T(0);
    }
  }

  // tiles t0 .. t0 + tz - 1 share x and y (tz divides nt1): their slots
  // are one run of perm
  const int t0 = blockIdx.x * tz;
  const int org[3] = {t0 / (nt1 * nt1) * m, t0 / nt1 % nt1 * m, t0 % nt1 * m};
  const int span[3] = {m, m, tz * m};
  const int* bperm = perm + static_cast<size_t>(t0) * R;
  if (threadIdx.x <= tz) s_pre[threadIdx.x] = 0;
  __syncthreads();
  // extents, 1 + the last occupied slot of each tile: an occupied slot
  // whose next slot in its tile is empty; four loads in flight per thread
  for (int q0 = threadIdx.x; q0 < tz * R; q0 += 4 * blockDim.x) {
    int here[4], next[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + k * blockDim.x;
      here[k] = q < tz * R ? bperm[q] : n;
      next[k] = q < tz * R && (q + 1) % R != 0 ? bperm[q + 1] : n;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + k * blockDim.x;
      if (here[k] < n && next[k] >= n) atomicMax(&s_pre[q / R + 1], q % R + 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < tz; ++k) s_pre[k + 1] += s_pre[k];
  }
  const int half = P / 2 - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int step = WB;  // slots per batch; 1 once a batch's box is too wide to stage
  for (int b0 = 0;;) {
    __syncthreads();  // the prefix is written, the last batch is done
    const int total = s_pre[tz];
    if (b0 >= total) break;
    const int nbat = min(step, total - b0);
    if (threadIdx.x < 3) {
      s_box[threadIdx.x] = 0x7fffffff;
      s_box[3 + threadIdx.x] = -0x7fffffff;
    }
    __syncthreads();
    for (int q0 = 0; q0 < 3 * nbat; q0 += blockDim.x) {  // whole warps: they reduce the box
      const int q = q0 + threadIdx.x;
      const int e = q / 3;
      const int d = q - 3 * e;
      int rel = 0;
      bool occupied = false;
      if (q < 3 * nbat) {
        const int i = b0 + e;
        int k = 0;
        while (s_pre[k + 1] <= i) ++k;
        const size_t slot = static_cast<size_t>(t0 + k) * R + (i - s_pre[k]);
        const int pid = perm[slot];
        const T ud = u[3 * slot + d];  // finite on an empty slot too; not used there
        if (d == 0) spid[e] = pid < n ? pid : -1;
        sacc[q] = T(0);
        occupied = pid < n;
        if (occupied) {
          const T fl = floor(ud);
          const T frac = ud - fl;
          rel = wrap_(static_cast<int>(fl) - half - org[d], G);
          if (rel >= (G + span[d]) / 2) rel -= G;  // just below the tiles: negative
          srel[q] = rel;
          T* w = sw + q * P;
          for (int c = 0; c < P; ++c) w[c] = window_weight(T(c - half) - frac, win);
        }
      }
      for (int dd = 0; dd < 3; ++dd) {
        const bool mine = occupied && d == dd;
        const int mn = __reduce_min_sync(0xffffffffu, mine ? rel : 0x7fffffff);
        const int mx = __reduce_max_sync(0xffffffffu, mine ? rel : -0x7fffffff);
        if (lane == 0 && mn <= mx) {
          atomicMin(&s_box[dd], mn);
          atomicMax(&s_box[3 + dd], mx);
        }
      }
    }
    __syncthreads();
    const int lo[3] = {s_box[0], s_box[1], s_box[2]};
    if (lo[0] > s_box[3]) {  // no occupied slot in this batch
      b0 += nbat;
      continue;
    }
    const int E[3] = {s_box[3] - lo[0] + P, s_box[4] - lo[1] + P, s_box[5] - lo[2] + P};
    // a box too wide for the buffer or the offset tables (slots far outside
    // their tiles): redo this batch slot by slot, each box P wide
    const int zb = wrap_(org[2] + lo[2], G);  // grid z of the box's first point
    const int zs = vec ? zb % V : 0;            // its staged z: rows start aligned
    const int E2s = vec ? (zs + E[2] + V - 1) / V * V : E[2];  // staged row length
    if ((3 * E[1] * E2s > cap || E[0] > tbl || E[1] > tbl) && nbat > 1) {
      step = 1;
      continue;
    }
    const int X = min(E[0], cap / (3 * E[1] * E2s));  // x-planes per slab
    for (int k = threadIdx.x; k < E[1]; k += blockDim.x) {
      yoff[k] = wrap_(org[1] + lo[1] + k, G) * G;
    }
    for (int xs = 0; xs < E[0]; xs += X) {
      const int nx = min(X, E[0] - xs);
      __syncthreads();  // the last slab's sums are done
      for (int pl = threadIdx.x; pl < 3 * nx; pl += blockDim.x) {
        const int ch = pl / nx;
        poff[pl] = ch * cs +
                   static_cast<long long>(wrap_(org[0] + lo[0] + xs + pl - ch * nx, G)) * G * G;
      }
      __syncthreads();
      // stage the slab: a warp per plane (channel, x) of E1 rows along z,
      // its lanes on consecutive points (16 bytes each where the planes
      // keep them aligned), every copy in flight at once
      for (int pl = warp; pl < 3 * nx; pl += nw) {
        const T* gplane = grid + poff[pl];
        T* splane = sg + static_cast<size_t>(pl) * E[1] * E2s;
        const int w = vec ? V : 1;  // points per copy
        const int nv = E2s / w;     // copies per row
        int iy = 0, iv = lane;
        while (iv >= nv) {
          iv -= nv;
          ++iy;
        }
        for (int j = lane; j < E[1] * nv; j += 32) {
          int gz = zb - zs + iv * w;
          if (gz >= G) gz = gz - G < G ? gz - G : gz % G;
          if (vec) {
            cp_async<16>(splane + j * V, gplane + yoff[iy] + gz);
          } else {
            cp_async<sizeof(T)>(splane + j, gplane + yoff[iy] + gz);
          }
          iv += 32;
          while (iv >= nv) {
            iv -= nv;
            ++iy;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // one thread per (slot, channel): the reference's order, a, b, c nested
      for (int q = threadIdx.x; q < 3 * nbat; q += blockDim.x) {
        const int e = q / 3;
        const int ch = q - 3 * e;
        if (spid[e] < 0) continue;
        const int ia = srel[3 * e] - lo[0] - xs;  // slab x of support point a = 0
        const int a0 = max(0, -ia);
        const int a1 = min(P, nx - ia);
        if (a0 >= a1) continue;
        const int ib = srel[3 * e + 1] - lo[1];
        const int ic = srel[3 * e + 2] - lo[2] + zs;
        const T* wx = sw + 3 * e * P;
        const T* wy = wx + P;
        T wz[PC > 0 ? PC : MAX_P];
#pragma unroll
        for (int c = 0; c < P; ++c) wz[c] = wy[P + c];
        const T* plane = sg + static_cast<size_t>(ch) * nx * E[1] * E2s;
        T acc = sacc[q];
        for (int a = a0; a < a1; ++a) {
          const T wa = wx[a];
          const T* va = plane + ((ia + a) * E[1] + ib) * E2s + ic;
          for (int b = 0; b < P; ++b) {
            const T wxy = wa * wy[b];
            const T* vb = va + b * E2s;
#pragma unroll
            for (int c = 0; c < P; ++c) {
              const T wt = wxy * wz[c];
              acc += wt * vb[c];
            }
          }
        }
        sacc[q] = acc;
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < 3 * nbat; q += blockDim.x) {
      const int pid = spid[q / 3];
      if (pid >= 0) out[3 * static_cast<size_t>(pid) + q % 3] = sacc[q] * h3;
    }
    b0 += nbat;
  }
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

template <typename T, int PC>
int launch_interp_p(const void* u, const void* perm, const void* slot_of, const void* grid,
                    void* out, int n, int n_slots, int G, int m, int P, int R,
                    const Window& win, double h3, void* stream) {
  const int nt1 = G / m;
  int tz = TZ_MAX;  // tiles per block along z: the most that divide nt1
  while (nt1 % tz != 0) --tz;
  // staged values: the box of a block's tiles, at most 12 KB of them (x-slabs
  // stage a wider box in turn: in trials on the card smaller buffers, and so
  // more blocks per SM, ran faster), and at least one x-plane of the widest
  // box that slots within a grid point of their tiles span, rows aligned
  const long long v = 16 / sizeof(T);
  const long long plane = 3LL * (m + P + 1) * (tz * m + P + 1 + 2 * v);
  const long long box = plane * (m + P + 1);
  const long long budget = 12 * 1024 / sizeof(T);
  const int cap = static_cast<int>(box < budget ? box : (plane > budget ? plane : budget));
  const int tbl = (3 * m + P + 1) & ~1;
  const size_t smem = static_cast<size_t>(3 * tbl) * sizeof(long long) +
                      static_cast<size_t>(cap + WB * 3 * P + WB * 3) * sizeof(T) +
                      static_cast<size_t>(4 * WB + tbl) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        se_interp_kernel<T, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch must not report it
      return static_cast<int>(err);
    }
  }
  se_interp_kernel<T, PC><<<nt1 * nt1 * nt1 / tz, 128, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int*>(perm),
      static_cast<const int*>(slot_of), static_cast<const T*>(grid), static_cast<T*>(out), n,
      n_slots, G, m, P, R, nt1, tz, cap, win, static_cast<T>(h3));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp(const void* u, const void* perm, const void* slot_of, const void* grid,
                  void* out, int n, int n_slots, int G, int m, int P, int R, int kind,
                  double beta, double wh, double c, double h, double pref, double h3,
                  void* stream) {
  if (P < 1 || P > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  const Window win = make_window(kind, beta, wh, c, h, pref);
  if (P == 6) {
    return launch_interp_p<T, 6>(u, perm, slot_of, grid, out, n, n_slots, G, m, P, R,
                                 win, h3, stream);
  }
  return launch_interp_p<T, 0>(u, perm, slot_of, grid, out, n, n_slots, G, m, P, R,
                               win, h3, stream);
}


// ---------------------------------------------------------------------------
// The rows layout: K5s-rows and K5i-rows.
//
// Replace the Pallas TPU kernels of the row decomposition, under their own
// contract: mundy_tpu/ops/pallas/se_grid.py se_spread_rows_pre
// (_spread_kernel) and se_interp_rows_pre (_interp_kernel), on the pieces
// of se_bin_and_windows. Particles are binned into nyz^2 = (G/m)^2 rows,
// one per (y, z) column of m x m grid points spanning the x axis, R slots
// each: perm (particle id, n = empty), the patch offsets gx0 and gy0, and
// the window weights wx (P), wy (P) and wz (W = m + P), precomputed. Slot s
// of row (iy, iz) adds wx[a] (wy[b] (wz[c] f)) to grid point
//   x = (gx0 + a - XPAD/2) mod G, y = (iy m - P/2 + gy0 + b) mod G,
//   z = (iz m - P/2 + c) mod G        (a, b < P; c < W)
// (the z weights span the slab's whole width W, not P support points);
// interpolation is the transpose, times h^3, written at perm. Dropped from
// the TPU kernels: the (G + XPAD, W, 3 W) slab per row, the roll folds
// _combine_axis / _extract_axis in XLA, the z contraction outside the
// kernel and the _r_chunk split of R.
//
// x-ordered lists (both kernels). Within a row the binning leaves the
// slots in particle order, so in random x order. Each kernel's counted
// launch therefore starts with a pre-pass, one block per row, that writes
// for each run of RUN_X = 32 grid points along x the row's occupied slots
// in slot order: for K5s-rows every slot whose x support meets the run (a
// slot is in at most max_runs lists: 2 at G = 384, P = 6, 3 where a short
// last run lies inside one support), for K5i-rows every slot whose support
// starts in the run (each slot once). A count per run, a prefix, then a
// ballot-compacted walk of the row per run; the wrapper allocates the
// lists (R max_runs or R entries a row) and the offsets (rows_plan).
//
// K5s-rows. What bounded the first design on this card (NVIDIA H100 80GB
// HBM3 at 700 W, 8.05 ms at config #5's grid, 1M beads; ops/kernels/
// se_rows_trials.py times copies of the source with parts cut out): without
// its sums it ran 5.96 ms, without its sums and staging 1.73, so the
// staging took 4.22 ms, the sums 2.09 and the candidate scan 1.73. One
// thread per kept slot staged its RX + 2 m weights with a % per weight
// while the block waited at the barrier; the scan tested each of the ~4100
// occupied slots of the 9 rows around every 32-point x-run; and the sums
// ran over slots whose z weights on the cell were all zero (most slots of
// the neighbouring z-rows: the ES window ends P/2 from the particle) and
// over all 8 x points of a thread where a slot's P = 6 x weights meet one
// or two of a run's four 8-point segments.
// This design: output-stationary gather, no float atomics. One block of
// 256 threads per (row cell, x-run), each thread owning XR = 8 points along
// x at one (y, z) of the cell (m^2 RUN_X / XR items, 256 at m = 8; more
// items take more passes). The block walks the run's lists of the distinct
// rows around its own (rows (Y + dy, Z + dz), dy, dz in -1..1, each once
// when G/m < 3), ~400 candidates at config #5, reading each one's offsets
// and particle id together. It keeps a slot whose y support meets the cell
// (x is the list's) and, from another z-row, whose z weights on the cell
// are not all zero, and compacts the kept ones in list order (ballot,
// per-warp counts). A warp stages SG = 4 kept slots at a time, their loads
// in flight together: lane i the x weight of point X0 + i (zero off the
// support) and their ballot, a bit per x point; lane k the k-th of the m y
// and m z weights and the force, each index wrapped by one compare. Every
// thread then adds the staged slots to its points in list order: it skips
// a slot whose bits miss its 8 points (uniform across a warp, which is 4 y
// x 8 z of one segment at m = 8) or whose y or z weight is an exact zero,
// else wz f, times wy, then 4 products with wx into 4 x 3 register sums for
// each half of its points the bits meet (16-byte loads of the weights).
// RUN_X stays 32, a lane per x point of a run, and XR 8, a warp per
// segment; in se_rows_trials.py's runs ROWS_CAP = 256 and SG = 8 each ran
// ~1.2x slower than 128 and 4 (more registers and shared memory a block).
// The order of terms: each point's sum takes the first design's nonzero
// terms in its order, the rows in the fixed (dy, dz) order and each row's
// slots in slot order, since a list keeps its row's slot order and holds
// every slot whose support meets the run. A skipped term is an exact zero,
// and adding +-0 to a sum that starts at +0 never changes it, so the grid
// is bit for bit the first design's, two launches are bit-equal, and each
// point is written once, by its own block. A slot's y and z reach stays
// within one row of its own while m >= P/2 + 1, and no axis wraps onto
// itself while W <= G; the wrapper checks both and P <= XPAD.
//
// K5i-rows. What bounded the first design (2.33 ms at config #5):
// half a warp per slot, a lane per z term, each lane gathering P x P x 3
// values straight from L2; the 16 slots of a block were consecutive slots
// of a row, in random x order, so they shared almost no x planes (~7 GB of
// sectors a call against the 0.68 GB grid), and lanes 14-15 of each
// half-warp idled at W = 14.
// This design: one block of 256 threads per (row, x-run), over the slots
// whose support starts in the run, ICHUNK = 64 at a time (~38 at config
// #5). A thread per slot reads its offsets and places it by a counting
// sort on its support's start r0 in the run. The chunk's supports lie in a
// box of at most RUN_X + P - 1 x planes, W y rows and W z points; the block
// stages it in x-slabs of at most ISLAB_BYTES, one after another, into
// shared memory with cp.async (a warp per (channel, x) plane, 16-byte
// copies where the planes keep them aligned, the y and z wrap taken per row
// and per copy; the slots' weights land with the first slab). For each
// slab one thread per (slot, z term) of the slots whose support meets it
// (one range, by the sort), over the z terms whose weight is not an exact
// zero (~P of the W = m + P with the ES window; a pair list, no idle
// lanes), adds that slab's x terms to the slot's sums at that z, carried
// across slabs in shared memory; then one thread per (slot, channel)
// weights the W sums by wz and adds them by the first design's shuffle
// tree. In se_rows_trials.py's runs (1M beads, G 384) 24 KB slabs ran
// faster than 12 and 48 KB, and 64-slot chunks faster than 32.
// The order of terms stays the first design's: for each z term, sum_a
// wx[a] (sum_b wy[b] g) with b inside a, each product rounded (no FMA),
// the a terms in increasing x across slabs; then a lane's share of the z
// terms (z = l, l + 16, ... from +0) and the fixed tree over the 16 shares,
// times h^3. A z term whose weight is 0 adds 0 times its sum, +-0, to a
// share that starts at +0, which leaves it unchanged, so skipping its sum
// keeps every output bit for bit (for a finite grid; the first design
// carried a NaN or infinity through that product). No slot's output
// depends on another's or on its place, so no atomics and two launches are
// bit-equal; an empty slot is in no list and a dropped particle keeps the
// wrapper's zero.
//
// Bound: the grid written (K5s-rows) or read (K5i-rows) once is 12 G^3
// bytes (680 MB at G = 384, 0.20 ms at 3.35 TB/s), plus the pieces (perm's
// 4 bytes a slot, and 4 + 4 + 4 (2 P + W) bytes an occupied slot in float32:
// 0.12 GB for 1M particles in 2304 rows of R 664, P 6, W 14; an empty
// slot's weights are never read), against ~1.5 GFLOP for 1M particles
// (3 P^2 W products and sums each), so both are bound by bytes. What keeps
// them from it (se_rows_trials.py at config #5: K5s-rows 1.97 ms, of which
// its sums 0.89 and its staging 0.44; K5i-rows 1.42 ms, of which its
// staging 0.68 and its sums 0.21; the list pre-pass 0.08 ms of each):
// K5s-rows reads a kept slot's pieces from L2 in each of the blocks around
// it that keep it, and still runs 4 products a half where the support
// covers 1-4 of the points, with a block's barriers between its turns;
// K5i-rows stages each grid value ~(14/8)^2 (37/32) ~ 3.5 times from L2
// (the y and z halo of a row's W x W window), ~2.75 GB a call, and its
// blocks run their phases (lists, slots, slabs, tree) in turn.

constexpr int RUN_X = 32;  // grid points along x per run (K5s-rows: a lane per point)
constexpr int XR = 8;      // K5s-rows: grid points along x per thread
constexpr int ROWS_XPAD = 16;
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_CAP = 128;          // K5s-rows: staged slots per turn
constexpr int SG = 4;                  // K5s-rows: slots a warp stages at once
constexpr int MAX_RUNS = 128;          // x-runs a row may have (counted in shared memory)
constexpr int ICHUNK = 64;             // K5i-rows: slots per chunk
constexpr int ISLAB_BYTES = 24 * 1024;  // K5i-rows: grid values staged per x-slab (>= a plane)
static_assert(RUN_X == 32 && XR == 8, "K5s-rows: a lane per x point, 8 x points a thread");
static_assert(ICHUNK <= ROWS_THREADS, "K5i-rows: a thread per slot of a chunk");

__device__ __forceinline__ int wrap1_(int x, int G) {  // x in [-G, 2G)
  return x < 0 ? x + G : (x >= G ? x - G : x);
}

// One block per row: for each run k of RUN_X grid points along x, the row's
// occupied slots (flat ids) whose x support meets the run (starts == 0) or
// starts in it (starts == 1), in slot order, at list[row lcap + off[row
// (nxr + 1) + k]]; off[row (nxr + 1) + nxr] is the row's total.
__global__ void se_rows_lists_kernel(const int* __restrict__ perm, const int* __restrict__ gx0,
                                     int* __restrict__ list, int* __restrict__ off, int n,
                                     int G, int P, int R, int nxr, int lcap, int starts) {
  __shared__ int s_cnt[MAX_RUNS + 1];
  __shared__ int s_ext;
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int* p = perm + static_cast<size_t>(row) * R;
  const int* gx = gx0 + static_cast<size_t>(row) * R;
  if (threadIdx.x == 0) s_ext = 0;
  __syncthreads();
  int e = 0;  // 1 + the last occupied slot this thread saw
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    if (p[r] < n) e = r + 1;
  }
  e = __reduce_max_sync(0xffffffffu, e);
  if (lane == 0) atomicMax(&s_ext, e);
  __syncthreads();
  const int ext = s_ext;
  auto member = [&](int r, int k) {  // is slot r of the row in run k's list?
    if (r >= ext || p[r] >= n) return false;
    const int sx = wrap_(gx[r] - ROWS_XPAD / 2, G);
    const int x0 = k * RUN_X;
    if (wrap1_(sx - x0, G) < min(RUN_X, G - x0)) return true;  // the support starts in the run
    return !starts && wrap1_(x0 - sx, G) < P;                   // the run starts in the support
  };
  for (int k = warp; k < nxr; k += nw) {
    int c = 0;
    for (int r0 = 0; r0 < ext; r0 += 32) {
      c += __popc(__ballot_sync(0xffffffffu, member(r0 + lane, k)));
    }
    if (lane == 0) s_cnt[k] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < nxr; ++k) {
      const int c = s_cnt[k];
      s_cnt[k] = acc;
      acc += c;
    }
    s_cnt[nxr] = acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= nxr; k += blockDim.x) {
    off[static_cast<size_t>(row) * (nxr + 1) + k] = s_cnt[k];
  }
  for (int k = warp; k < nxr; k += nw) {
    int* dst = list + static_cast<size_t>(row) * lcap + s_cnt[k];
    int c = 0;
    for (int r0 = 0; r0 < ext; r0 += 32) {
      const bool in = member(r0 + lane, k);
      const unsigned b = __ballot_sync(0xffffffffu, in);
      if (in) dst[c + __popc(b & ((1u << lane) - 1u))] = row * R + r0 + lane;
      c += __popc(b);
    }
  }
}

// Values of shared memory per staged slot: RUN_X + 2 m box-relative weights
// and the force, padded to a multiple of 4 (16-byte loads of the x weights).
__host__ __device__ inline int rows_slot_values(int m) { return (RUN_X + 2 * m + 4 + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
    se_spread_rows_kernel(const int* __restrict__ perm, const int* __restrict__ gx0,
                          const int* __restrict__ gy0, const T* __restrict__ wx,
                          const T* __restrict__ wy, const T* __restrict__ wz,
                          const T* __restrict__ forces, const int* __restrict__ list,
                          const int* __restrict__ off, T* __restrict__ grid, int G, int m,
                          int P, int nyz, int nxr, int lcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ws = rows_slot_values(m);          // staged values per slot
  T* sw = reinterpret_cast<T*>(smem_raw);      // [ROWS_CAP][ws]
  __shared__ int s_slot[ROWS_THREADS];         // kept candidates of a batch: slot,
  __shared__ int s_sx[ROWS_THREADS];           // x support start,
  __shared__ int s_sy[ROWS_THREADS];           // y support start,
  __shared__ int s_sz[ROWS_THREADS];           // z window start,
  __shared__ int s_pid[ROWS_THREADS];          // particle id
  __shared__ unsigned s_xb[ROWS_CAP];          // a staged slot's nonzero x weights, a bit each
  __shared__ int s_row[9];                     // the distinct rows around
  __shared__ int s_beg[9];                     // where their lists for this run start
  __shared__ int s_pre[10];                    // exclusive prefix of the lists' lengths
  __shared__ int s_wsum[ROWS_THREADS / 32];    // kept candidates per warp

  const int W = m + P;
  const int xr = blockIdx.x % nxr;
  const int row = blockIdx.x / nxr;
  const int Y = row / nyz, Z = row % nyz;
  const int X0 = xr * RUN_X, Y0 = Y * m, Z0 = Z * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int noff = nyz >= 3 ? 3 : nyz;  // fewer than 3 rows a side: each once
  const int off0 = nyz >= 3 ? -1 : 0;
  const int n_nb = noff * noff;

  if (warp == 0) {
    int c = 0;
    if (lane < n_nb) {
      const int ry = (Y + off0 + lane / noff + nyz) % nyz;
      const int rz = (Z + off0 + lane % noff + nyz) % nyz;
      const int r = ry * nyz + rz;
      const int* o = off + static_cast<size_t>(r) * (nxr + 1) + xr;
      s_row[lane] = r;
      s_beg[lane] = r * lcap + o[0];
      c = o[1] - o[0];
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
  const int nseg = RUN_X / XR;
  const int items = m * m * nseg;

  for (int it0 = 0; it0 < items; it0 += blockDim.x) {
    const int item = it0 + threadIdx.x;
    const bool own = item < items;
    const int lz = own ? item % m : 0;
    const int ly = own ? (item / m) % m : 0;
    const int x0 = own ? (item / (m * m)) * XR : 0;
    T acc[XR][3];
#pragma unroll
    for (int i = 0; i < XR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = T(0);
    int cnt = 0;   // kept slots not yet added (the same value in every thread)
    int done = 0;  // of those, the ones already staged and added

    // staged value k of kept slot j after its RUN_X x weights: its m y
    // weights, its m z weights, the force, 0
    auto rest = [&](int j, int k) {
      const size_t sl = static_cast<size_t>(s_slot[j]);
      if (k < m) {
        const int b = wrap1_(Y0 + k - s_sy[j], G);
        return b < P ? wy[sl * P + b] : T(0);
      }
      if (k < 2 * m) {
        const int c = wrap1_(Z0 + k - m - s_sz[j], G);
        return c < W ? wz[sl * W + c] : T(0);
      }
      return k < 2 * m + 3 ? forces[3 * static_cast<size_t>(s_pid[j]) + (k - 2 * m)] : T(0);
    };

    // stage kept slots [done, cnt) in turns of ROWS_CAP, add each turn
    auto flush = [&]() {
      while (done < cnt) {
        const int nst = min(ROWS_CAP, cnt - done);
        // a warp per staged slot, SG slots' loads in flight at once: lane
        // i the x weight of point X0 + i, lane k the k-th of the m y and m z
        // weights and the force (more lanes' worth in turn where 2 m + 4 > 32)
        for (int e0 = warp; e0 < nst; e0 += SG * nw) {
          T xv[SG], rv[SG];
#pragma unroll
          for (int u = 0; u < SG; ++u) {
            const int j = done + e0 + u * nw;
            xv[u] = rv[u] = T(0);
            if (e0 + u * nw < nst) {
              const size_t sl = static_cast<size_t>(s_slot[j]);
              const int a = wrap1_(X0 + lane - s_sx[j], G);
              if (X0 + lane < G && a < P) xv[u] = wx[sl * P + a];
              rv[u] = rest(j, lane);
            }
          }
#pragma unroll
          for (int u = 0; u < SG; ++u) {
            const int e = e0 + u * nw;
            if (e < nst) {  // the whole warp
              T* w = sw + static_cast<size_t>(e) * ws;
              w[lane] = xv[u];
              if (lane < 2 * m + 4) w[RUN_X + lane] = rv[u];
              const unsigned xb = __ballot_sync(0xffffffffu, xv[u] != T(0));
              if (lane == 0) s_xb[e] = xb;
            }
          }
        }
        for (int e = warp; 2 * m + 4 > 32 && e < nst; e += nw) {
          for (int k = 32 + lane; k < 2 * m + 4; k += 32) {
            sw[static_cast<size_t>(e) * ws + RUN_X + k] = rest(done + e, k);
          }
        }
        __syncthreads();
        if (own) {
          for (int j = 0; j < nst; ++j) {
            const unsigned xb = (s_xb[j] >> x0) & 0xffu;  // this thread's 8 x points
            if (xb == 0u) continue;                           // zero x weights on all
            const T* w = sw + static_cast<size_t>(j) * ws;
            const T wzv = w[RUN_X + m + lz];
            const T wyv = w[RUN_X + ly];
            if (wzv == T(0) || wyv == T(0)) continue;  // exact-zero terms
            const T* f = w + RUN_X + 2 * m;
            const T t0 = wyv * (wzv * f[0]);
            const T t1 = wyv * (wzv * f[1]);
            const T t2 = wyv * (wzv * f[2]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // each half of 4 points, unless its weights are 0
              if ((xb >> (4 * h)) & 0xfu) {
                const Quad<T> wq = load4(w + x0 + 4 * h);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  acc[4 * h + i][0] += wq.v[i] * t0;
                  acc[4 * h + i][1] += wq.v[i] * t1;
                  acc[4 * h + i][2] += wq.v[i] * t2;
                }
              }
            }
          }
        }
        __syncthreads();  // the staging buffer is reused by the next turn
        done += nst;
      }
    };

    for (int i0 = 0; i0 < total; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      bool flag = false;
      int s = 0, sx = 0, sy = 0, sz = 0, pid = 0;
      if (i < total) {
        int nb = 0;
        while (s_pre[nb + 1] <= i) ++nb;
        s = list[s_beg[nb] + (i - s_pre[nb])];
        const int g0 = gx0[s], g1 = gy0[s];
        pid = perm[s];
        const int rs = s_row[nb];
        sx = wrap_(g0 - ROWS_XPAD / 2, G);
        sy = wrap_(rs / nyz * m - P / 2 + g1, G);
        sz = wrap_(rs % nyz * m - P / 2, G);
        // the y support meets the cell (x is the list's)
        flag = wrap1_(sy - Y0, G) < m || wrap1_(Y0 - sy, G) < P;
        if (flag && rs % nyz != Z) {
          // a neighbouring z-row's window always meets the cell, but its
          // weights there are often all exact zeros (the ES window beyond
          // P/2 of the particle): then every term here is, and it goes
          const T* pz = wz + static_cast<size_t>(s) * W;
          const int c0 = wrap1_(Z0 - sz, G);  // the cell's first z point in the window
          bool any = false;
          for (int l = 0; l < m && !any; ++l) {
            const int c = c0 + l < G ? c0 + l : c0 + l - G;
            any = c < W && pz[c] != T(0);
          }
          flag = any;
        }
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
      if (flag) {
        const int e = before + __popc(kept & ((1u << lane) - 1u));
        s_slot[e] = s;
        s_sx[e] = sx;
        s_sy[e] = sy;
        s_sz[e] = sz;
        s_pid[e] = pid;
      }
      cnt = batch;
      done = 0;
      __syncthreads();
      flush();
    }
    if (own) {
      const int y = Y0 + ly, z = Z0 + lz;
#pragma unroll
      for (int i = 0; i < XR; ++i) {
        const int x = X0 + x0 + i;
        if (x < G) {
          const size_t g = ((static_cast<size_t>(x) * G + y) * G + z) * 3;
          grid[g] = acc[i][0];
          grid[g + 1] = acc[i][1];
          grid[g + 2] = acc[i][2];
        }
      }
    }
    __syncthreads();  // the kept list is reused by the next pass
  }
}

// K5i-rows' dynamic shared memory: the [slab] staged grid values, [ICHUNK]
// [2 P + W] weights, [ICHUNK][W][3] sums, [ICHUNK] x 5 + 1 ints, the
// [ICHUNK W] pairs' slots and [W] y offsets.
template <typename T>
size_t interp_rows_smem(int slab, int P, int W) {
  return static_cast<size_t>(slab + ICHUNK * (2 * P + W) + ICHUNK * W * 3) * sizeof(T) +
         static_cast<size_t>(6 * ICHUNK + 1 + ICHUNK * W + W) * sizeof(int);
}

// One block per (row, x-run): the slots whose support starts in the run,
// ICHUNK at a time. PC > 0 fixes the window support P at compile time.
template <typename T, int PC>
__global__ void __launch_bounds__(ROWS_THREADS)
    se_interp_rows_kernel(const int* __restrict__ perm, const int* __restrict__ gx0,
                          const int* __restrict__ gy0, const T* __restrict__ wx,
                          const T* __restrict__ wy, const T* __restrict__ wz,
                          const T* __restrict__ grid, T* __restrict__ out,
                          const int* __restrict__ list, const int* __restrict__ off, int G,
                          int m, int P_rt, int nyz, int nxr, int lcap, int slab, T h3) {
  const int P = PC > 0 ? PC : P_rt;
  const int W = m + P;
  const int nwt = 2 * P + W;  // staged weights per slot: wx, wy, wz
  constexpr int V = 16 / sizeof(T);
  const bool vec = G % V == 0 && reinterpret_cast<size_t>(grid) % 16 == 0;
  const long long cs = static_cast<long long>(G) * G * G;  // channel stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sg = reinterpret_cast<T*>(smem_raw);                 // [slab] staged grid values
  T* sw = sg + slab;                                      // [ICHUNK][nwt] weights
  T* sacc = sw + ICHUNK * nwt;                            // [ICHUNK][W][3] sums across slabs
  int* sslot = reinterpret_cast<int*>(sacc + ICHUNK * W * 3);  // [ICHUNK] slot
  int* spid = sslot + ICHUNK;                             // [ICHUNK] particle id
  int* sr0 = spid + ICHUNK;                               // [ICHUNK] support start in the run's box
  int* sgy = sr0 + ICHUNK;                                // [ICHUNK] gy0: the patch's first y row
  int* sclo = sgy + ICHUNK;                               // [ICHUNK] first z term weighted not 0
  int* spre = sclo + ICHUNK;                              // [ICHUNK + 1] pairs before each slot
  int* spair = spre + ICHUNK + 1;                         // [ICHUNK W] slot of each pair
  int* yoff = spair + ICHUNK * W;                         // [W] y row offsets
  __shared__ int s_bin[RUN_X + 1];  // slots of the chunk by support start: counts, then a prefix
  __shared__ int s_cur[RUN_X];      // where the next slot of each start goes

  const int xr = blockIdx.x % nxr;
  const int row = blockIdx.x / nxr;
  const int* o = off + static_cast<size_t>(row) * (nxr + 1) + xr;
  const int beg = o[0];
  const int cnt = o[1] - beg;
  if (cnt == 0) return;  // the whole block
  const int* lst = list + static_cast<size_t>(row) * lcap + beg;
  const int iy = row / nyz, iz = row % nyz;
  const int X0 = xr * RUN_X;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int zb = wrap_(iz * m - P / 2, G);  // grid z of the window's first z point
  const int zs = vec ? zb % V : 0;          // its staged z: rows start aligned
  const int Wz = vec ? (zs + W + V - 1) / V * V : W;  // staged row length
  const int cw = vec ? V : 1;                         // points per copy
  const int nv = Wz / cw;                             // copies per row
  const int plane = W * Wz;                           // staged values per (channel, x) plane
  const int X = min(slab / (3 * plane), RUN_X + P - 1);  // x planes per slab (>= 1)
  for (int k = threadIdx.x; k < W; k += blockDim.x) yoff[k] = wrap_(iy * m - P / 2 + k, G) * G;
  // a lane's first copy of a plane (row k0, copy iv0), then 32 copies on
  const int k0 = lane / nv, iv0 = lane - k0 * nv;
  const int dk = 32 / nv, dv = 32 - dk * nv;

  for (int c0 = 0; c0 < cnt; c0 += ICHUNK) {
    const int nch = min(ICHUNK, cnt - c0);
    __syncthreads();  // the last chunk is written out
    if (threadIdx.x <= RUN_X) s_bin[threadIdx.x] = 0;
    __syncthreads();
    // a thread per slot: its support start r0 in the run's box; the slots
    // are placed in order of r0 (a counting sort; no slot's output depends
    // on its place), so those a slab meets are one range
    const bool mine = threadIdx.x < nch;
    int s = 0, r0 = 0, clo = W, chi = 0;
    if (mine) {
      s = lst[c0 + threadIdx.x];
      r0 = wrap_(wrap_(gx0[s] - ROWS_XPAD / 2, G) - X0, G);
      atomicAdd(&s_bin[r0 + 1], 1);
      const T* pz = wz + static_cast<size_t>(s) * W;
      for (int c = 0; c < W; ++c) {  // the z terms [clo, chi) whose weights are not 0
        if (pz[c] != T(0)) {
          clo = min(clo, c);
          chi = c + 1;
        }
      }
    }
    for (int q = threadIdx.x; q < nch * W * 3; q += blockDim.x) sacc[q] = T(0);
    __syncthreads();
    if (warp == 0) {  // s_bin[b]: the slots with r0 < b; s_cur[b] = s_bin[b]
      int c = s_bin[lane + 1];
      for (int o2 = 1; o2 < 32; o2 <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, c, o2);
        if (lane >= o2) c += y;
      }
      const int before = __shfl_up_sync(0xffffffffu, c, 1);
      s_cur[lane] = lane > 0 ? before : 0;
      s_bin[lane + 1] = c;
    }
    __syncthreads();
    if (mine) {
      const int e = atomicAdd(&s_cur[r0], 1);
      sslot[e] = s;
      spid[e] = perm[s];
      sr0[e] = r0;
      sgy[e] = gy0[s];
      sclo[e] = clo;
      spre[e + 1] = max(chi - clo, 0);
    }
    __syncthreads();
    if (warp == 0) {  // spre[e]: the (slot, z term) pairs of the slots before e
      int carry = 0;
      for (int b0 = 0; b0 < nch; b0 += 32) {
        int c = b0 + lane < nch ? spre[b0 + lane + 1] : 0;
        for (int o2 = 1; o2 < 32; o2 <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, c, o2);
          if (lane >= o2) c += y;
        }
        c += carry;
        if (b0 + lane < nch) spre[b0 + lane + 1] = c;
        carry = __shfl_sync(0xffffffffu, c, 31);
      }
      if (lane == 0) spre[0] = 0;
    }
    for (int q = threadIdx.x; q < nch * nwt; q += blockDim.x) {  // they land with slab 0
      const int e = q / nwt;
      const int k = q - e * nwt;
      const size_t sl = static_cast<size_t>(sslot[e]);
      cp_async<sizeof(T)>(sw + q, k < P ? wx + sl * P + k
                                        : (k < 2 * P ? wy + sl * P + k - P
                                                     : wz + sl * W + k - 2 * P));
    }
    __syncthreads();
    if (mine) {  // each pair's slot
      for (int k = spre[threadIdx.x]; k < spre[threadIdx.x + 1]; ++k) spair[k] = threadIdx.x;
    }
    const int rlo = sr0[0];
    const int E = sr0[nch - 1] - rlo + P;  // x planes the chunk's supports span
    for (int xs = 0; xs < E; xs += X) {
      const int nx = min(X, E - xs);
      // stage the slab: a warp per (channel, x) plane of W rows along z,
      // every copy in flight at once
      for (int pl = warp; pl < 3 * nx; pl += nw) {
        const int ch = pl / nx;
        const T* gp = grid + ch * cs +
                      static_cast<long long>(wrap_(X0 + rlo + xs + pl - ch * nx, G)) * G * G;
        T* sp = sg + static_cast<size_t>(pl) * plane;
        int k = k0, iv = iv0;
        while (k < W) {
          int gz = zb - zs + iv * cw;
          if (gz >= G) gz = gz - G < G ? gz - G : gz % G;
          if (vec) {
            cp_async<16>(sp + k * Wz + iv * V, gp + yoff[k] + gz);
          } else {
            cp_async<sizeof(T)>(sp + k * Wz + iv, gp + yoff[k] + gz);
          }
          k += dk;
          iv += dv;
          if (iv >= nv) {
            iv -= nv;
            ++k;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      const int cstr = nx * plane;  // channel stride of the slab
      // the slots whose support meets the slab: r0 in [rlo + xs - P + 1, rlo + xs + nx)
      const int e_lo = s_bin[min(max(rlo + xs - P + 1, 0), RUN_X)];
      const int e_hi = s_bin[min(rlo + xs + nx, RUN_X)];
      // one thread per (slot, z term) whose z weight is not 0 (the others'
      // terms in the tree are 0 times a sum: +-0): the first design's
      // order, b inside a
      for (int k = spre[e_lo] + threadIdx.x; k < spre[e_hi]; k += blockDim.x) {
        const int e = spair[k];
        const int c = sclo[e] + k - spre[e];
        const int q = e * W + c;
        const int ia = sr0[e] - rlo - xs;  // slab x of support point a = 0
        const int a0 = max(0, -ia);
        const int a1 = min(P, nx - ia);
        const T* wxs = sw + e * nwt;
        const T* wys = wxs + P;
        const T* vz = sg + sgy[e] * Wz + zs + c;
        T acc0 = sacc[3 * q], acc1 = sacc[3 * q + 1], acc2 = sacc[3 * q + 2];
        for (int a = a0; a < a1; ++a) {
          const T* va = vz + (ia + a) * plane;
          T y0 = T(0), y1 = T(0), y2 = T(0);
#pragma unroll
          for (int b = 0; b < P; ++b) {
            const T wb = wys[b];
            const T* vb = va + b * Wz;
            y0 += wb * vb[0];
            y1 += wb * vb[cstr];
            y2 += wb * vb[2 * cstr];
          }
          const T wa = wxs[a];
          acc0 += wa * y0;
          acc1 += wa * y1;
          acc2 += wa * y2;
        }
        sacc[3 * q] = acc0;
        sacc[3 * q + 1] = acc1;
        sacc[3 * q + 2] = acc2;
      }
      __syncthreads();  // the slab is summed: the next one may land
    }
    // one thread per (slot, channel): lane l's share of the z terms, z = l,
    // l + 16, ... from +0, then the first design's 16-lane shuffle tree
    for (int q = threadIdx.x; q < nch * 3; q += blockDim.x) {
      const int e = q / 3;
      const int ch = q - 3 * e;
      const T* wzs = sw + e * nwt + 2 * P;
      const T* ac = sacc + e * W * 3 + ch;
      T p[16];
#pragma unroll
      for (int l = 0; l < 16; ++l) p[l] = T(0);
      for (int c0 = 0; c0 < W; c0 += 16) {
#pragma unroll
        for (int l = 0; l < 16; ++l) {
          if (c0 + l < W) p[l] += ac[3 * (c0 + l)] * wzs[c0 + l];
        }
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) {
#pragma unroll
        for (int l = 0; l < o2; ++l) p[l] += p[l + o2];
      }
      out[3 * static_cast<size_t>(spid[e]) + ch] = h3 * p[0];
    }
  }
}

// The run count, the most runs a support meets, the K5i-rows slab: as
// ops/kernels/se_grid.rows_plan computes them.
int rows_runs(int G) { return (G + RUN_X - 1) / RUN_X; }

int rows_max_runs(int G, int P) {
  int best = 0;
  for (int sx = 0; sx < G; ++sx) {
    int seen[ROWS_XPAD + 1];
    int ns = 0;
    for (int a = 0; a < P; ++a) {
      const int k = (sx + a) % G / RUN_X;
      bool old = false;
      for (int j = 0; j < ns; ++j) old = old || seen[j] == k;
      if (!old) seen[ns++] = k;
    }
    best = ns > best ? ns : best;
  }
  return best;
}

template <typename T>
int interp_rows_slab(int P, int W) {
  constexpr int V = 16 / sizeof(T);
  const int plane = 3 * W * ((W + 2 * V - 2) / V * V);  // the widest staged plane
  const int full = plane * (RUN_X + P - 1);
  const int budget = ISLAB_BYTES / static_cast<int>(sizeof(T));
  return plane > budget ? plane : (full < budget ? full : budget);
}

bool rows_envelope(int G, int m, int P, int R, int lcap, int min_lcap) {
  return m >= P / 2 + 1 && G % m == 0 && P >= 1 && P <= ROWS_XPAD && m + P <= G &&
         rows_runs(G) <= MAX_RUNS && lcap >= min_lcap &&
         static_cast<long long>(G / m) * (G / m) * lcap < (1LL << 31) &&
         static_cast<long long>(G / m) * (G / m) * R < (1LL << 31);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the next launch must not report it
  return err;
}

template <typename T>
int launch_spread_rows(const void* perm, const void* gx0, const void* gy0, const void* wx,
                       const void* wy, const void* wz, const void* forces, void* list,
                       void* off, void* grid, int n, int G, int m, int P, int R, int lcap,
                       void* stream) {
  if (m < 1 || G < 1 || !rows_envelope(G, m, P, R, lcap, R * rows_max_runs(G, P))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nyz = G / m;
  const int n_rows = nyz * nyz;
  const int nxr = rows_runs(G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  se_rows_lists_kernel<<<n_rows, ROWS_THREADS, 0, st>>>(
      static_cast<const int*>(perm), static_cast<const int*>(gx0), static_cast<int*>(list),
      static_cast<int*>(off), n, G, P, R, nxr, lcap, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(ROWS_CAP) * rows_slot_values(m) * sizeof(T);
  err = set_smem(reinterpret_cast<const void*>(se_spread_rows_kernel<T>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  se_spread_rows_kernel<T><<<n_rows * nxr, ROWS_THREADS, smem, st>>>(
      static_cast<const int*>(perm), static_cast<const int*>(gx0),
      static_cast<const int*>(gy0), static_cast<const T*>(wx), static_cast<const T*>(wy),
      static_cast<const T*>(wz), static_cast<const T*>(forces), static_cast<const int*>(list),
      static_cast<const int*>(off), static_cast<T*>(grid), G, m, P, nyz, nxr, lcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PC>
int launch_interp_rows_p(const void* perm, const void* gx0, const void* gy0, const void* wx,
                         const void* wy, const void* wz, const void* grid, void* out,
                         const void* list, const void* off, int G, int m, int P, int lcap,
                         double h3, cudaStream_t st) {
  const int nyz = G / m;
  const int nxr = rows_runs(G);
  const int W = m + P;
  const int slab = interp_rows_slab<T>(P, W);
  const size_t smem = interp_rows_smem<T>(slab, P, W);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(se_interp_rows_kernel<T, PC>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  se_interp_rows_kernel<T, PC><<<nyz * nyz * nxr, ROWS_THREADS, smem, st>>>(
      static_cast<const int*>(perm), static_cast<const int*>(gx0),
      static_cast<const int*>(gy0), static_cast<const T*>(wx), static_cast<const T*>(wy),
      static_cast<const T*>(wz), static_cast<const T*>(grid), static_cast<T*>(out),
      static_cast<const int*>(list), static_cast<const int*>(off), G, m, P, nyz, nxr, lcap,
      slab, static_cast<T>(h3));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp_rows(const void* perm, const void* gx0, const void* gy0, const void* wx,
                       const void* wy, const void* wz, const void* grid, void* out, void* list,
                       void* off, int n, int G, int m, int P, int R, int lcap, double h3,
                       void* stream) {
  if (m < 1 || G < 1 || !rows_envelope(G, m, P, R, lcap, R)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nyz = G / m;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  se_rows_lists_kernel<<<nyz * nyz, ROWS_THREADS, 0, st>>>(
      static_cast<const int*>(perm), static_cast<const int*>(gx0), static_cast<int*>(list),
      static_cast<int*>(off), n, G, P, R, rows_runs(G), lcap, 1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P == 6) {
    return launch_interp_rows_p<T, 6>(perm, gx0, gy0, wx, wy, wz, grid, out, list, off, G, m,
                                      P, lcap, h3, st);
  }
  return launch_interp_rows_p<T, 0>(perm, gx0, gy0, wx, wy, wz, grid, out, list, off, G, m, P,
                                    lcap, h3, st);
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

// grid: (G, G, G, 3) values as three (G, G, G) planes, the channel axis
// outermost: element strides (G^2, G, 1, G^3).
int se_interp_f32(const void* u, const void* perm, const void* slot_of, const void* grid,
                  void* out, int n, int n_slots, int G, int m, int P, int R, int kind,
                  double beta, double wh, double c, double h, double pref, double h3,
                  void* stream) {
  return launch_interp<float>(u, perm, slot_of, grid, out, n, n_slots, G, m, P, R,
                              kind, beta, wh, c, h, pref, h3, stream);
}

int se_interp_f64(const void* u, const void* perm, const void* slot_of, const void* grid,
                  void* out, int n, int n_slots, int G, int m, int P, int R, int kind,
                  double beta, double wh, double c, double h, double pref, double h3,
                  void* stream) {
  return launch_interp<double>(u, perm, slot_of, grid, out, n, n_slots, G, m, P, R,
                               kind, beta, wh, c, h, pref, h3, stream);
}

// The rows layout. list, off: int32 scratch for the x-run lists, (n_rows,
// lcap) and (n_rows, G/32 + 1), lcap >= R times the most runs a support
// meets (K5s-rows) or R (K5i-rows); grid: (G, G, G, 3) C order (K5s-rows),
// or three (G, G, G) planes, the channel axis outermost (K5i-rows); out:
// (n, 3), zeroed by the caller.
int se_spread_rows_f32(const void* perm, const void* gx0, const void* gy0, const void* wx,
                       const void* wy, const void* wz, const void* forces, void* list,
                       void* off, void* grid, int n, int G, int m, int P, int R, int lcap,
                       void* stream) {
  return launch_spread_rows<float>(perm, gx0, gy0, wx, wy, wz, forces, list, off, grid, n, G,
                                   m, P, R, lcap, stream);
}

int se_spread_rows_f64(const void* perm, const void* gx0, const void* gy0, const void* wx,
                       const void* wy, const void* wz, const void* forces, void* list,
                       void* off, void* grid, int n, int G, int m, int P, int R, int lcap,
                       void* stream) {
  return launch_spread_rows<double>(perm, gx0, gy0, wx, wy, wz, forces, list, off, grid, n, G,
                                    m, P, R, lcap, stream);
}

int se_interp_rows_f32(const void* perm, const void* gx0, const void* gy0, const void* wx,
                       const void* wy, const void* wz, const void* grid, void* out, void* list,
                       void* off, int n, int G, int m, int P, int R, int lcap, double h3,
                       void* stream) {
  return launch_interp_rows<float>(perm, gx0, gy0, wx, wy, wz, grid, out, list, off, n, G, m,
                                   P, R, lcap, h3, stream);
}

int se_interp_rows_f64(const void* perm, const void* gx0, const void* gy0, const void* wx,
                       const void* wy, const void* wz, const void* grid, void* out, void* list,
                       void* off, int n, int G, int m, int P, int R, int lcap, double h3,
                       void* stream) {
  return launch_interp_rows<double>(perm, gx0, gy0, wx, wy, wz, grid, out, list, off, n, G, m,
                                    P, R, lcap, h3, stream);
}

}  // extern "C"
