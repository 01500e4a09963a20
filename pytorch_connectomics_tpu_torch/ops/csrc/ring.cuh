// The z-marching slab ring that the MedNeXt block pair (mednext_block.cu)
// and the training path's depthwise kernels (depthwise3x3.cu) share.
//
// A work item is (b, a band of ty rows of y with all of x, a segment of seg
// slabs of z), numbered (b * segs + s) * bands + band. Persistent blocks take
// the items in turn and march each along z. A ring of 3 or 4 slabs in shared
// memory holds the band's rows with their y and x halo, (ty + 2) x xp voxels
// of C values, xp = 3 * ceil(X / 3) + 2; rows, columns and slabs outside the
// volume are zero-filled when staged (SAME zero padding, no mask in the
// stencil). A thread owns a channel pair and runs of kRun = 3 consecutive x
// outputs of one band row; each (dz, dy) row of five voxels it loads feeds
// all three outputs of a run. The channel count CT is a template argument
// (0: the runtime C), so every stencil load has a compile-time offset.
#pragma once

#include "mednext_block.cuh"

namespace mednext {

constexpr int kRun = 3;  // x outputs of a thread's run

__host__ __device__ __forceinline__ size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Ring {
  int B, Z, Y, X, C;
  int ty, seg;             // band rows, segment slabs
  int nr;                  // slabs in the ring: 4 (slab z + 2 staged before the stencil of z) or 3 (after it)
  int bands, segs, items;  // item = (b * segs + s) * bands + band
  int nrx, xp;             // runs of a band row; slab row length in voxels, kRun * nrx + 2
};

inline Ring make_ring(int B, int Z, int Y, int X, int C, int ty, int seg, int nr) {
  Ring g{B, Z, Y, X, C, ty, seg, nr, 0, 0, 0, 0, 0};
  g.bands = (Y + ty - 1) / ty;
  g.segs = (Z + seg - 1) / seg;
  g.items = B * g.segs * g.bands;
  g.nrx = (X + kRun - 1) / kRun;
  g.xp = kRun * g.nrx + 2;
  return g;
}

__host__ __device__ __forceinline__ size_t slab_elems(const Ring& g) { return (size_t)(g.ty + 2) * g.xp * g.C; }

__device__ __forceinline__ void item_origin(const Ring& g, int item, int& b, int& y0, int& z0, int& z1) {
  const int band = item % g.bands;
  const int t = item / g.bands;
  const int s = t % g.segs;
  b = t / g.segs;
  y0 = band * g.ty;
  z0 = s * g.seg;
  z1 = min(z0 + g.seg, g.Z);
}

// Issue the copies of slab z of the band at y0 into dst[ty + 2][xp][C]:
// voxel (y0 - 1 + yy, xx - 1), zero where it lies outside the volume.
template <typename T, int CT>
__device__ __forceinline__ void stage_slab(const T* __restrict__ xb, T* __restrict__ dst, int z, int y0,
                                           const Ring& g) {
  constexpr int per = 16 / (int)sizeof(T);  // values a 16-byte copy
  const int C = CT ? CT : g.C;
  const int vec = C / per;
  const int row = g.xp * vec;
  const int total = (g.ty + 2) * row;
  const bool zin = z >= 0 && z < g.Z;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int yy = i / row, rem = i - yy * row;
    const int xx = rem / vec, q = rem - xx * vec;
    const int y = y0 - 1 + yy, xg = xx - 1;
    const bool valid = zin && y >= 0 && y < g.Y && xg >= 0 && xg < g.X;
    const T* src = valid ? xb + (((long long)z * g.Y + y) * g.X + xg) * C + q * per : xb;
    cp_async16(dst + (size_t)i * per, src, valid);
  }
}

// dw(x) without bias at three consecutive x outputs of a band row, for one
// channel pair, NR runs at once (independent chains for the scheduler):
// at[j] is the offset of the pair's value at run j's first output's
// (-1, -1) neighbour inside a slab; s0..s2 the slabs of z - 1, z, z + 1;
// rowlen the slab row stride. f32 accumulate, taps in the order dz, dy, dx.
template <typename T, int CT, int NR>
__device__ __forceinline__ void stencil_runs(const T* s0, const T* s1, const T* s2, const int (&at)[NR], int rowlen,
                                             int C_, const float2 (&k)[27], float2 (&a)[NR][kRun]) {
  const int C = CT ? CT : C_;
#pragma unroll
  for (int n = 0; n < NR; ++n)
#pragma unroll
    for (int j = 0; j < kRun; ++j) a[n][j] = make_float2(0.f, 0.f);
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const T* s = dz == 0 ? s0 : dz == 1 ? s1 : s2;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float2 v[NR][kRun + 2];
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int i = 0; i < kRun + 2; ++i) v[n][i] = load2(s + at[n] + dy * rowlen + i * C);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float2 kk = k[dz * 9 + dy * 3 + dx];
#pragma unroll
        for (int n = 0; n < NR; ++n)
#pragma unroll
          for (int j = 0; j < kRun; ++j) {
            a[n][j].x = fmaf(kk.x, v[n][j + dx].x, a[n][j].x);
            a[n][j].y = fmaf(kk.y, v[n][j + dx].y, a[n][j].y);
          }
      }
    }
  }
}

// A thread's place in the stencil: channel pairs p0, p0 + pt, ...; runs
// slot, slot + tv, ... of the band's ty * nrx runs.
struct Lanes {
  int pt, tv, p0, slot;
  bool active;
};

__device__ __forceinline__ Lanes lanes_of(int C) {
  Lanes t;
  const int P = C / 2;
  t.pt = P < kThreads ? P : kThreads;
  t.tv = kThreads / t.pt;
  t.p0 = threadIdx.x % t.pt;
  t.slot = threadIdx.x / t.pt;
  t.active = t.slot < t.tv;
  return t;
}

// the next run of a thread: `tv` runs on, as (row, run in the row)
__device__ __forceinline__ void next_run(int tv, int nrx, int& ry, int& rx) {
  rx += tv;
  while (rx >= nrx) {
    rx -= nrx;
    ++ry;
  }
}

// The stencil over a thread's runs (slot, slot + tv, ... of the band's
// ty * nrx) for channel pair p, two runs at a time; emit(ry, rx, a) gets the
// three outputs of run (row ry, x 3 rx).
template <typename T, int CT, typename Emit>
__device__ __forceinline__ void stencil_band(const T* s0, const T* s1, const T* s2, int p, const Lanes& ln,
                                             const Ring& g, int C_, const float2 (&kw)[27], Emit emit) {
  const int C = CT ? CT : C_;
  const int runs = g.ty * g.nrx, rowlen = g.xp * C;
  int ry = ln.slot / g.nrx, rx = ln.slot - ry * g.nrx;
  int r = ln.slot;
  for (; r + ln.tv < runs; r += 2 * ln.tv) {
    int ry2 = ry, rx2 = rx;
    next_run(ln.tv, g.nrx, ry2, rx2);
    const int at[2] = {(ry * g.xp + kRun * rx) * C + 2 * p, (ry2 * g.xp + kRun * rx2) * C + 2 * p};
    float2 a[2][kRun];
    stencil_runs<T, CT, 2>(s0, s1, s2, at, rowlen, C, kw, a);
    emit(ry, rx, a[0]);
    emit(ry2, rx2, a[1]);
    ry = ry2;
    rx = rx2;
    next_run(ln.tv, g.nrx, ry, rx);
  }
  if (r < runs) {
    const int at[1] = {(ry * g.xp + kRun * rx) * C + 2 * p};
    float2 a[1][kRun];
    stencil_runs<T, CT, 1>(s0, s1, s2, at, rowlen, C, kw, a);
    emit(ry, rx, a[0]);
  }
}

inline bool ring_ok(int B, int Z, int Y, int X, int C, int ty, int seg, int nr) {
  return (nr == 3 || nr == 4) && B >= 1 && Z >= 1 && Y >= 1 && X >= 1 && C % 16 == 0 && C >= 16 && C <= 1024 && ty >= 1 && seg >= 1 &&
         (long long)Z * Y * X * C < (1LL << 31) && (long long)B * ((Z + seg - 1) / seg) * ((Y + ty - 1) / ty) < (1LL << 31) &&
         (long long)(ty + 2) * (3 * ((X + 2) / 3) + 2) * C < (1LL << 31);
}

}  // namespace mednext
