// Fused pointwise MLP with residual for Hopper (sm_90a), rows of channels:
//     h   = gelu_tanh(x @ W1 + b1)          f32 accumulate, bias in f32
//     out = round( x + (round_T(h) @ W2 + b2) )   h rounded to x's type first
// x (M, C), W1 (C, E), W2 (E, C), biases f32, out (M, C) in x's type. The
// pointwise (1x1x1) conv out = round(x @ W^T) of a weight W (Cout, C) has
// kernels of its own (below the MLP's).
//
// Replaces the TPU kernel fused_mlp_residual of
// pytorch_connectomics_tpu/ops/fused_mlp_pallas.py:40 (pallas_call :54, body
// _fused_mlp_kernel :29, NDHWC wrapper :70), and the pointwise probes pw_cf
// of scripts/tpu_bf16_experiments.py:181 and scripts/tpu_bf16_experiments2.py:171.
// It ports what they compute, not the TPU's VMEM row blocks or CF lanes.
//
// Bound on an H100: at MedNeXt-S's stage 0 (C 32, E 64, bf16) one row reads
// and writes 128 bytes and does 16 KFLOP of tensor-core work, 128 FLOP per
// byte, below the card's ridge (~295): bytes bound it. At C 512, E 1024 the
// products (4 C E FLOP per row) are above the ridge; there the rows are few
// (1,152 at the fast recipe's batch 16) and the weights are 2 MB in bf16.
//
// The plan of a launch (rows a tile, warps' rows and columns, cluster size,
// resident or streamed weights, chunk) comes from the Python planner
// (ops/fused_mlp.py::kernel_plan) as a PlanIn; the weights come padded to
// its widths Cq x Eq (zero rows and columns past C and E; the wrapper pads
// only widths the plan does not take as they are), x and out at their own
// width C: x is zero-filled past C and M when staged, out stored only there.
// Hidden units past E give gelu(0 + 0) = 0 against zero rows of W2.
//
// bfloat16, on the tensor cores (ldmatrix + mma.sync m16n8k16, f32
// accumulate):
// - A warp owns 16 rows and NPW 16-column output pairs. Per 16 or 32 hidden
//   units it runs the first product (its x rows' A fragments kept in
//   registers where C <= 128) from accumulators that start at b1, applies
//   tanh-GELU (tanh.approx) to them, packs them to bf16 as the A fragment of
//   the second product and accumulates its outputs: the hidden activation
//   never leaves registers, and no barrier separates the products. Where the
//   outputs of a row need WN > 1 warps (C > 128: a warp's accumulators hold
//   128 columns), the WN warps each compute a share of the hidden blocks
//   once into a small bf16 tile of the fragment in shared memory and meet at
//   a named barrier before the second product.
// - Persistent blocks walk row tiles as a stream of (tile, chunk) stages,
//   filled by cp.async: weights that fit stay resident, staged once, and x
//   tiles run through a ring of up to four, so that the next three tiles'
//   copies are in flight under this tile's MMAs; streamed weight chunks run
//   through a ring of two beside a ring of two x tiles, the next chunk's
//   copies in flight under this chunk's MMAs. One block barrier a stage.
// - Narrow rows (C >= 128, few rows): a thread-block cluster of CS blocks
//   splits E; each block keeps its slice of W1's columns and W2's rows on
//   chip, computes the tile's partial output over its slice into shared
//   memory, and the block of rank r then sums the partials of rows r, r +
//   CS, ... over the cluster's blocks through distributed shared memory in
//   rank order (bit-identical from launch to launch whatever the grid),
//   adds b2 and the residual and rounds once.
// - Epilogue without a cluster: accumulators + b2 + x, rounded, go through
//   the warp's own tile by stmatrix and leave as 16-byte pieces of rows.
// - Shared row strides are odd multiples of 16 bytes, so the 8 rows of an
//   ldmatrix phase fall on distinct banks.
//
// float32, exact on the CUDA cores (no TF32), register tiles: a block takes
// BM rows and CB output columns (CB < Cq only to fill the card at few rows;
// each column block then computes the hidden units itself). Per chunk of EH
// hidden units (64 at 64 rows, 256 at 16) a thread computes RH rows x 4
// hidden units (float4 loads of x and of W1's k-major rows, fmaf in k
// order), adds b1, applies the exact tanh-GELU and writes the chunk to
// shared memory; then RO rows x 8 outputs accumulate over the chunk (float4
// loads of h and of W2). The weights are
// read from shared memory where they fit, else through L1 from L2. x tiles
// are double-buffered by cp.async.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see ops/build.py). Plain C interface for ctypes.

#include <cooperative_groups.h>

#include <cstring>

#include "mednext_block.cuh"

namespace fmlp {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using mednext::cp_async;
using mednext::cp_async_commit;
using mednext::cp_async_wait;
using mednext::gelu_tanh;
using mednext::ldsm_x4;
using mednext::ldsm_x4_trans;
using mednext::mma16816;
using mednext::stsm_x4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kErrShape = 10001;
constexpr size_t kMaxSmem = 232448;

// The plan, as ops/fused_mlp.py::PLAN_FIELDS lists its fields.
struct PlanIn {
  int bf16;     // 1: the bf16 kernel, 0: the f32 kernel
  int C, E;     // real widths
  int Cq, Eq;   // padded widths of the weights
  int BM;       // rows a tile
  int MF, WN;   // bf16: 16-row fragments x column groups of a block (MF * WN = 8)
  int NPW;      // bf16: 16-column output pairs a warp
  int KA;       // bf16: k-steps of x's A fragments kept in registers (a power of two), 0: none
  int NP;       // bf16: the kernel's most pairs a warp (a power of two >= NPW)
  int CS;       // bf16: blocks a cluster, each with Eq / CS hidden units
  int ES, EC;   // bf16: hidden units a block; a staged chunk (ES: resident)
  int nbuf;     // bf16: weight buffers (1: resident, 2: a ring of two streamed chunks)
  int RH, RO;   // f32: rows a thread of the first and of the second product
  int CB;       // f32: output columns a block
  int resident; // f32: weights in shared memory
  int XR;       // bf16: x tiles in the ring (2-4; 2 where the weights stream)
  int EH;       // f32: hidden units a chunk (4 * 256 RH / BM)
  int WK;       // bf16: the warp kernel (resident weights, C <= 128, each warp on its own)
  int DE;       // bf16 without a cluster: store bf16 pairs straight from the accumulators
};
constexpr int kPlanFields = sizeof(PlanIn) / sizeof(int);

struct Geom {
  PlanIn p;
  long long M, tiles;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// A shared-memory row stride for ldmatrix: n bf16 values (a multiple of 8)
// widened to an odd multiple of 16 bytes.
__host__ __device__ inline int odd_stride(int n) { return (n / 8) % 2 ? n : n + 8; }

// Byte offsets of the shared-memory regions (ops/fused_mlp.py::plan_smem
// computes the same).
struct Layout {
  int XS, W1S, W2S, ES, HS;  // row strides: x tile, W1 chunk (per k), W2 chunk (per hidden unit), epilogue, h tiles
  size_t x, w, wbuf, e, h, wr, total;  // h: the row fragments' h tiles (WN > 1); wr: a warp's region (warp kernel)
};

__host__ __device__ inline Layout layout(const PlanIn& p) {
  Layout l;
  l.x = 0;
  l.wr = l.h = 0;
  l.HS = 0;
  if (p.bf16 && p.WK) {  // the warp kernel: the weights, then each warp's ring of XR fragments and its tile
    l.XS = odd_stride(p.Cq);
    l.W1S = odd_stride(p.EC);
    l.W2S = odd_stride(p.Cq);
    l.ES = odd_stride(p.Cq);
    l.w = 0;
    l.wbuf = align128(((size_t)p.Cq * l.W1S + (size_t)p.EC * l.W2S) * 2);
    l.x = l.e = l.wbuf;
    l.wr = align128(((size_t)p.XR * 16 * l.XS + (p.DE ? 0 : (size_t)16 * l.ES)) * 2);  // no tile: direct stores
    l.total = l.x + kWarps * l.wr;
  } else if (p.bf16) {
    l.XS = odd_stride(p.Cq);
    l.W1S = odd_stride(p.EC);
    l.W2S = odd_stride(p.Cq);
    l.wbuf = align128(((size_t)p.Cq * l.W1S + (size_t)p.EC * l.W2S) * 2);
    l.w = align128((size_t)p.XR * p.BM * l.XS * 2);
    l.e = l.w + p.nbuf * l.wbuf;
    l.ES = p.CS > 1 ? p.Cq + 8 : odd_stride(16 * p.NPW);  // f32 partials, or the warps' bf16 tiles
    l.h = l.e + (p.CS > 1 ? align128((size_t)p.BM * l.ES * 4) : align128((size_t)kWarps * 16 * l.ES * 2));
    l.HS = odd_stride(p.EC);
    l.total = l.h + (p.WN > 1 ? align128((size_t)p.MF * 16 * l.HS * 2) : 0);
  } else {
    l.XS = p.Cq + 4;
    l.W1S = p.Eq;
    l.W2S = p.Cq;
    l.ES = p.EH + 4;  // the hidden chunk
    l.e = align128(2 * (size_t)p.BM * l.XS * 4);
    l.w = l.e + align128((size_t)p.BM * l.ES * 4);
    l.wbuf = p.resident ? align128((size_t)p.Cq * p.Eq * 4) : 0;  // W1, then W2
    l.total = l.w + 2 * l.wbuf;
  }
  return l;
}

// The bytes of a staged piece of a row of n values of size es: the largest
// of 16, 8, 4 dividing the row's bytes (es for a bf16 row of odd length).
__host__ __device__ inline int piece_bytes(int n, int es) {
  const int b = n * es;
  return b % 16 == 0 ? 16 : b % 8 == 0 ? 8 : b % 4 == 0 ? 4 : es;
}

// A thread's share of staging tiles of x (M, C) among nt threads: pieces
// of pz bytes of each row, padded to cq values. Where the threads divide a
// row's pieces, thread `tid` keeps piece v of rows r0, r0 + step, ...;
// otherwise (step 0) the pieces are dealt out one by one.
struct XMap {
  int per, pz, real, v, r0, step, tid, nt;
};

template <typename T>
__device__ __forceinline__ XMap x_map(int C, int cq, int tid, int nt) {
  XMap m;
  m.pz = piece_bytes(C, (int)sizeof(T));
  m.per = cq * (int)sizeof(T) / m.pz;
  m.real = C * (int)sizeof(T);
  const bool even = nt % m.per == 0;
  m.v = even ? tid % m.per : 0;
  m.r0 = even ? tid / m.per : 0;
  m.step = even ? nt / m.per : 0;
  m.tid = tid;
  m.nt = nt;
  return m;
}

// Stage rows [m0, m0 + rows) of x at row stride xst: values past C and rows
// past M are zero.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, T* xs, long long M, int C, int rows, int xst,
                                        long long m0, const XMap& xm) {
  if (xm.pz == 16 && xm.step) {  // the common case: whole 16-byte pieces, a thread's piece fixed
    const int off = xm.v * 16;
    const bool inside = off < xm.real;
    for (int r = xm.r0; r < rows; r += xm.step) {
      const bool valid = inside && m0 + r < M;
      const char* src = reinterpret_cast<const char*>(x) + (valid ? (m0 + r) * C * (long long)sizeof(T) + off : 0);
      cp_async<16>(reinterpret_cast<char*>(xs + (size_t)r * xst) + off, src, valid);
    }
    return;
  }
  auto piece = [&](int r, int v) {
    const bool valid = m0 + r < M && v * xm.pz < xm.real;
    char* dst = reinterpret_cast<char*>(xs + (size_t)r * xst) + v * xm.pz;
    const char* src = reinterpret_cast<const char*>(x) + (valid ? (m0 + r) * C * (long long)sizeof(T) + v * xm.pz : 0);
    if (xm.pz == 16) {
      cp_async<16>(dst, src, valid);
    } else if (xm.pz == 8) {
      cp_async<8>(dst, src, valid);
    } else if (xm.pz == 4) {
      cp_async<4>(dst, src, valid);
    } else {  // a bf16 row of odd length: two bytes a piece, copied by the thread
      *reinterpret_cast<T*>(dst) = valid ? *reinterpret_cast<const T*>(src) : mednext::from_f32<T>(0.f);
    }
  };
  if (xm.step) {
    for (int r = xm.r0; r < rows; r += xm.step) piece(r, xm.v);
  } else {
    for (int i = xm.tid; i < rows * xm.per; i += xm.nt) piece(i / xm.per, i % xm.per);
  }
}

// gelu_tanh(v) = 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3))) with the
// hardware's tanh (tanh.approx.f32, as the MedNeXt pair's bf16 apply), in six
// operations: u = v (k0 + k0 k1 v^2), then hv + hv tanh(u) with hv = v / 2.
// (The header's gelu_tanh_fast, nine operations, stays the pair's: its
// outputs, which its checks were set on, do not change.)
__device__ __forceinline__ float gelu_fast(float v) {
  constexpr float k0 = 0.7978845608028654f, k01 = 0.7978845608028654f * 0.044715f;
  const float u = v * fmaf(v * v, k01, k0);
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(u));
  const float hv = 0.5f * v;
  return fmaf(hv, t, hv);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// the MLP, bfloat16
// ---------------------------------------------------------------------------

// The cluster barrier in two halves (cluster.sync() is both): arrive releases
// this block's shared-memory writes, wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// NB blocks of 16 hidden units at column hb of the staged W1 chunk (hidden
// index e0 + hb of b1) for one warp's 16 rows: h = b1 + x . W1 on mma.sync
// (the accumulators start at the bias; A fragments from af, or from arow),
// tanh-GELU on the accumulators, rounded to bf16 as the A fragment of acc
// += h . W2 over the warp's np pairs (rows gq and gq + 8, hidden 2 tq and 8 +
// 2 tq of each 16).
template <int NB, int NP, int KA>
__device__ __forceinline__ void hidden_step(float (&acc)[NP][2][4], const unsigned (&af)[KA > 0 ? KA : 1][4],
                                            const bf16* arow, const bf16* bw1, const bf16* bw2,
                                            const float* __restrict__ b1, int hb, int e0, int nk, int np,
                                            const Layout& l, int tq) {
  float h[NB][2][4];  // the first product's accumulators start at b1
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float2 c = __ldg(reinterpret_cast<const float2*>(b1 + e0 + hb + n * 16 + t * 8 + 2 * tq));
      h[n][t][0] = h[n][t][2] = c.x;
      h[n][t][1] = h[n][t][3] = c.y;
    }
  if constexpr (KA > 0) {
#pragma unroll
    for (int k = 0; k < KA; ++k) {
      if (k < nk) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          unsigned b[4];
          ldsm_x4_trans(b, bw1 + (size_t)k * 16 * l.W1S + hb + n * 16);
          mma16816(h[n][0], af[k], b[0], b[1]);
          mma16816(h[n][1], af[k], b[2], b[3]);
        }
      }
    }
  } else {
    for (int k = 0; k < nk; ++k) {
      unsigned a[4];
      ldsm_x4(a, arow + k * 16);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        unsigned b[4];
        ldsm_x4_trans(b, bw1 + (size_t)k * 16 * l.W1S + hb + n * 16);
        mma16816(h[n][0], a, b[0], b[1]);
        mma16816(h[n][1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    unsigned a2[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      a2[2 * t] = pack_bf16(gelu_fast(h[n][t][0]), gelu_fast(h[n][t][1]));
      a2[2 * t + 1] = pack_bf16(gelu_fast(h[n][t][2]), gelu_fast(h[n][t][3]));
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < np) {
        unsigned b[4];
        ldsm_x4_trans(b, bw2 + (size_t)(hb + n * 16) * l.W2S + j * 16);
        mma16816(acc[j][0], a2, b[0], b[1]);
        mma16816(acc[j][1], a2, b[2], b[3]);
      }
    }
  }
}

// The epilogue of a warp's 16 rows (r0.., x's tile rows at xt) and pairs
// p0 .. p0 + np - 1 without a cluster: acc + b2 + x, rounded once, go to the
// warp's tile `stg` by stmatrix (matrix q of pair j is rows 8 (q & 1)..,
// columns 16 j + 8 (q >> 1)..), then out as 16-byte pieces of its rows
// (value by value where C is not a multiple of 8). Rows past M are not
// stored.
template <int NP>
__device__ __forceinline__ void warp_epilogue(const float (&acc)[NP][2][4], const bf16* xt, int xs, bf16* stg, int ess,
                                              const float* __restrict__ b2, bf16* __restrict__ out, int C, long long M,
                                              long long r0, int p0, int np, int lane, bool direct) {
  const int gq = lane >> 2, tq = lane & 3;
  if (direct && C % 2 == 0) {  // bf16 pairs straight from the accumulators (4-byte stores, no shared round trip)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < np) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = (p0 + j) * 16 + hh * 8 + 2 * tq;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = gq + half * 8;
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xt + (size_t)r * xs + col));
            if (r0 + r < M && col < C)
              *reinterpret_cast<unsigned*>(out + (r0 + r) * C + col) =
                  pack_bf16(acc[j][hh][2 * half] + bb.x + xv.x, acc[j][hh][2 * half + 1] + bb.y + xv.y);
          }
        }
      }
    }
    return;
  }
  bf16* srow = stg + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * ess + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j < np) {
      unsigned pk[2][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = (p0 + j) * 16 + hh * 8 + 2 * tq;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xt + (size_t)(gq + half * 8) * xs + col));
          pk[hh][half] = pack_bf16(acc[j][hh][2 * half] + bb.x + xv.x, acc[j][hh][2 * half + 1] + bb.y + xv.y);
        }
      }
      stsm_x4(srow + j * 16, pk[0][0], pk[0][1], pk[1][0], pk[1][1]);
    }
  }
  __syncwarp();
  const int oc = p0 * 16, cols = min(np * 16, C - oc);  // the warp's first output column; its real ones
  if (C % 8 == 0) {
    const int pieces = cols / 8;
    auto store = [&](int rw, int pc) {
      if (r0 + rw < M)
        *reinterpret_cast<uint4*>(out + (r0 + rw) * C + oc + pc * 8) =
            *reinterpret_cast<const uint4*>(stg + (size_t)rw * ess + pc * 8);
    };
    if (pieces > 0 && (pieces & (pieces - 1)) == 0 && pieces <= 32) {  // a lane keeps its piece of a row
      const int sh = __ffs(pieces) - 1;
      for (int rw = lane >> sh; rw < 16; rw += 32 >> sh) store(rw, lane & (pieces - 1));
    } else {
      for (int i = lane; i < 16 * pieces; i += 32) store(i / pieces, i % pieces);
    }
  } else {
    for (int i = lane; i < 16 * cols; i += 32) {
      const int rw = i / cols, cc = i - rw * cols;
      if (r0 + rw < M) out[(r0 + rw) * C + oc + cc] = stg[(size_t)rw * ess + cc];
    }
  }
  __syncwarp();  // the warp's tile is rewritten by its next rows
}

// Weights of hidden units [e0, e0 + n) into w1s (Cq rows of W1S) and w2s (n
// rows of W2S), 16-byte pieces of the padded weights, by the block's threads.
__device__ __forceinline__ void stage_weights(const bf16* __restrict__ w1, const bf16* __restrict__ w2, bf16* w1s,
                                              bf16* w2s, const PlanIn& p, const Layout& l, int e0, int n) {
  const int v1 = n / 8, v2 = p.Cq / 8;
  for (int i = threadIdx.x; i < p.Cq * v1; i += kThreads) {
    const int k = i / v1, v = i - k * v1;
    cp_async<16>(w1s + (size_t)k * l.W1S + v * 8, w1 + (size_t)k * p.Eq + e0 + v * 8, true);
  }
  for (int i = threadIdx.x; i < n * v2; i += kThreads) {
    const int e = i / v2, v = i - e * v2;
    cp_async<16>(w2s + (size_t)e * l.W2S + v * 8, w2 + (size_t)(e0 + e) * p.Cq + v * 8, true);
  }
}

// cp.async.wait_group for a distance known at run time (1 to 3 groups ahead).
__device__ __forceinline__ void wait_ahead(int ahead) {
  if (ahead >= 3)
    cp_async_wait<2>();
  else if (ahead == 2)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// The products of one warp's 16 rows over hidden units [hb0, hb0 + n) of the
// weights in shared memory (e0: b1's index of their column 0).
template <int NP, int KA>
__device__ __forceinline__ void hidden_range(float (&acc)[NP][2][4], const unsigned (&af)[KA > 0 ? KA : 1][4],
                                             const bf16* arow, const bf16* bw1, const bf16* bw2,
                                             const float* __restrict__ b1, int hb0, int n, int e0, int nk, int np,
                                             const Layout& l, int tq) {
  int hb = hb0;
  for (; hb + 32 <= hb0 + n; hb += 32) hidden_step<2, NP, KA>(acc, af, arow, bw1, bw2, b1, hb, e0, nk, np, l, tq);
  if (hb < hb0 + n) hidden_step<1, NP, KA>(acc, af, arow, bw1, bw2, b1, hb, e0, nk, np, l, tq);
}

// The products of a row fragment whose output columns WN warps share: each
// of them computes the hidden blocks b = wn, wn + WN, ... of the chunk once
// (b1, x . W1, tanh-GELU, rounded to bf16) into the fragment's tile `hs` in
// shared memory (stmatrix, in the A fragment's layout), the WN warps meet at
// named barrier `bar`, and each accumulates its own pairs over every block
// (ldmatrix of h). Warps without pairs still compute their blocks.
template <int NP, int KA>
__device__ __forceinline__ void hidden_shared(float (&acc)[NP][2][4], const unsigned (&af)[KA > 0 ? KA : 1][4],
                                              const bf16* arow, const bf16* bw1, const bf16* bw2,
                                              const float* __restrict__ b1, int hb0, int n, int e0, int nk, int np,
                                              const Layout& l, bf16* hs, int wn, int WN, int bar, int lane) {
  const int tq = lane & 3, blocks = n / 16;
  bf16* hst = hs + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * l.HS + (lane >> 4) * 8;  // stmatrix rows
  const bf16* hld = hs + (size_t)(lane & 15) * l.HS + (lane >> 4) * 8;                      // ldmatrix rows
  for (int b = wn; b < blocks; b += WN) {
    const int hb = hb0 + b * 16;
    float h[2][4];  // the accumulators start at b1
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float2 c = __ldg(reinterpret_cast<const float2*>(b1 + e0 + hb + t * 8 + 2 * tq));
      h[t][0] = h[t][2] = c.x;
      h[t][1] = h[t][3] = c.y;
    }
    if constexpr (KA > 0) {
#pragma unroll
      for (int k = 0; k < KA; ++k) {
        if (k < nk) {
          unsigned bb[4];
          ldsm_x4_trans(bb, bw1 + (size_t)k * 16 * l.W1S + hb);
          mma16816(h[0], af[k], bb[0], bb[1]);
          mma16816(h[1], af[k], bb[2], bb[3]);
        }
      }
    } else {
      for (int k = 0; k < nk; ++k) {
        unsigned a[4], bb[4];
        ldsm_x4(a, arow + k * 16);
        ldsm_x4_trans(bb, bw1 + (size_t)k * 16 * l.W1S + hb);
        mma16816(h[0], a, bb[0], bb[1]);
        mma16816(h[1], a, bb[2], bb[3]);
      }
    }
    stsm_x4(hst + b * 16, pack_bf16(gelu_fast(h[0][0]), gelu_fast(h[0][1])),
            pack_bf16(gelu_fast(h[0][2]), gelu_fast(h[0][3])), pack_bf16(gelu_fast(h[1][0]), gelu_fast(h[1][1])),
            pack_bf16(gelu_fast(h[1][2]), gelu_fast(h[1][3])));
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(WN * 32) : "memory");  // the fragment's hidden blocks are in hs
  for (int b = 0; b < blocks; ++b) {
    unsigned a2[4];
    ldsm_x4(a2, hld + b * 16);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < np) {
        unsigned bb[4];
        ldsm_x4_trans(bb, bw2 + (size_t)(hb0 + b * 16) * l.W2S + j * 16);
        mma16816(acc[j][0], a2, bb[0], bb[1]);
        mma16816(acc[j][1], a2, bb[2], bb[3]);
      }
    }
  }
}

// bf16, the wide rows (C <= 128, weights resident): after the block
// stages the weights once, each warp walks 16-row fragments on its own
// through a ring of XR slots of its own (cp.async, the next XR - 1
// fragments' copies in flight under this one's MMAs; no block barrier), runs
// both products over all hidden units with h in registers, and stores
// through its own tile.
template <int NP, int KA>
__global__ void __launch_bounds__(kThreads, NP <= 4 ? 2 : 1)
    mlp_bf16_warp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
                         const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanIn& p = g.p;
  const Layout l = layout(p);
  bf16* w1s = reinterpret_cast<bf16*>(smem + l.w);
  bf16* w2s = w1s + (size_t)p.Cq * l.W1S;
  stage_weights(w1, w2, w1s, w2s, p, l, 0, p.Eq);
  cp_async_commit();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, tq = lane & 3;
  bf16* ring = reinterpret_cast<bf16*>(smem + l.x + warp * l.wr);
  bf16* stg = ring + (size_t)p.XR * 16 * l.XS;
  const long long frags = (g.M + 15) / 16;
  const long long gw = (long long)blockIdx.x * kWarps + warp, nw = (long long)gridDim.x * kWarps;
  const int mine = gw < frags ? (int)((frags - gw + nw - 1) / nw) : 0;  // this warp's fragments
  const XMap xm = x_map<bf16>(p.C, p.Cq, lane, 32);
  const int nk = p.Cq / 16, np = p.Cq / 16, ahead = p.XR - 1;
  auto fetch = [&](int i, int slot) {
    stage_x(x, ring + (size_t)slot * 16 * l.XS, g.M, p.C, 16, l.XS, (gw + (long long)i * nw) * 16, xm);
  };
  for (int d = 0; d < ahead; ++d) {
    if (d < mine) fetch(d, d);
    cp_async_commit();
  }
  cp_async_wait<0>();  // (with the weights' group; the fragments after the first overlap the barrier)
  __syncthreads();     // the weights are staged
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const bf16* bw1 = w1s + (size_t)lrow * l.W1S + lcol;
  const bf16* bw2 = w2s + (size_t)lrow * l.W2S + lcol;
  unsigned af[KA > 0 ? KA : 1][4];
  int slot = 0;
  for (int i = 0; i < mine; ++i) {
    wait_ahead(ahead);
    __syncwarp();  // every lane's copies of fragment i landed; the slot of fragment i - 1 is free
    if (i + ahead < mine) fetch(i + ahead, slot == 0 ? p.XR - 1 : slot - 1);
    cp_async_commit();
    // phase: warp_staging continue
    const bf16* xt = ring + (size_t)slot * 16 * l.XS;
    const bf16* arow = xt + (size_t)(lane & 15) * l.XS + (lane >> 4) * 8;
    if constexpr (KA > 0) {
#pragma unroll
      for (int k = 0; k < KA; ++k)
        if (k < nk) ldsm_x4(af[k], arow + k * 16);
    }
    float acc[NP][2][4];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][h][q] = 0.f;
    hidden_range<NP, KA>(acc, af, arow, bw1, bw2, b1, 0, p.Eq, 0, nk, np, l, tq);
    // phase: warp_products continue
    warp_epilogue<NP>(acc, xt, l.XS, stg, l.ES, b2, out, p.C, g.M, (gw + (long long)i * nw) * 16, 0, np, lane, p.DE);
    if (++slot == p.XR) slot = 0;
  }
}

// bf16, the block kernel: warps share a tile of BM rows (MF fragments x WN
// column groups), and a cluster of CS blocks splits E. Persistent blocks
// walk (tile, chunk) stages; every stage's copies (its weight chunk where
// the weights stream, and at a tile's first chunk its x tile) are issued
// `ahead` stages early into rings (weights: two buffers, one stage ahead;
// resident weights: XR x slots, XR - 1 tiles ahead), one cp.async group a
// stage.
template <int NP, int KA>
__global__ void __launch_bounds__(kThreads, NP <= 4 ? 2 : 1)
    mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanIn& p = g.p;
  const Layout l = layout(p);
  bf16* xs0 = reinterpret_cast<bf16*>(smem + l.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mf = warp % p.MF, wn = warp / p.MF;
  const int p0 = wn * p.NPW;  // the warp's first output pair
  const int np = max(0, min(p.NPW, p.Cq / 16 - p0));
  const int nk = p.Cq / 16;
  const int rank = p.CS > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int cid = blockIdx.x / p.CS, ncl = gridDim.x / p.CS;
  const int nch = p.ES / p.EC;
  const int mine = cid < g.tiles ? (int)((g.tiles - cid + ncl - 1) / ncl) : 0;  // this block's tiles
  const size_t xtile = (size_t)p.BM * l.XS;
  const XMap xm = x_map<bf16>(p.C, p.Cq, threadIdx.x, kThreads);
  const int ahead = p.nbuf == 1 ? p.XR - 1 : p.nbuf - 1;  // stages whose copies are in flight
  const long long total = (long long)mine * nch;

  // the copies of a stage (tile t, chunk c) into weight buffer wb and x slot xsl
  auto fetch = [&](int t, int c, int wb, int xsl) {
    if (p.nbuf > 1) {
      bf16* w1s = reinterpret_cast<bf16*>(smem + l.w + wb * l.wbuf);
      stage_weights(w1, w2, w1s, w1s + (size_t)p.Cq * l.W1S, p, l, rank * p.ES + c * p.EC, p.EC);
    }
    if (c == 0) stage_x(x, xs0 + xsl * xtile, g.M, p.C, p.BM, l.XS, ((long long)t * ncl + cid) * p.BM, xm);
  };
  // stage cursors (tile, chunk, weight buffer, x slot): the stage computed and the stage fetched
  int t = 0, c = 0, wb = 0, xsl = 0;
  int ft = 0, fc = 0, fwb = 0, fxs = 0;
  auto advance = [&](int& tt, int& cc, int& bb, int& ss) {
    if (++bb == p.nbuf) bb = 0;
    if (++cc == nch) {
      cc = 0;
      ++tt;
      if (++ss == p.XR) ss = 0;
    }
  };

  float acc[NP][2][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][h][q] = 0.f;
  unsigned af[KA > 0 ? KA : 1][4];
  bool reading = false;  // a cluster's blocks may still read this block's partials (an arrive without its wait)

  if (p.nbuf == 1 && total > 0) {  // resident weights, with the first stage's group
    bf16* w1s = reinterpret_cast<bf16*>(smem + l.w);
    stage_weights(w1, w2, w1s, w1s + (size_t)p.Cq * l.W1S, p, l, rank * p.ES, p.ES);
  }
  for (int d = 0; d < ahead; ++d) {
    if (d < total) {
      fetch(ft, fc, fwb, fxs);
      advance(ft, fc, fwb, fxs);
    }
    cp_async_commit();
  }
  for (long long s = 0; s < total; ++s) {
    if (s > 0) advance(t, c, wb, xsl);
    wait_ahead(ahead);
    __syncthreads();  // stage s landed; every warp is done with stage s - 1 and its buffers
    if (s + ahead < total) {
      fetch(ft, fc, fwb, fxs);
      advance(ft, fc, fwb, fxs);
    }
    cp_async_commit();
    // phase: staging continue
    const long long m0 = ((long long)t * ncl + cid) * p.BM;
    const bf16* xt = xs0 + xsl * xtile;
    const bf16* arow = xt + (size_t)(mf * 16 + (lane & 15)) * l.XS + (lane >> 4) * 8;
    if constexpr (KA > 0) {
      if (c == 0) {
#pragma unroll
        for (int k = 0; k < KA; ++k)
          if (k < nk) ldsm_x4(af[k], arow + k * 16);
      }
    }
    {
      const bf16* w1s = reinterpret_cast<const bf16*>(smem + l.w + wb * l.wbuf);
      const bf16* w2s = w1s + (size_t)p.Cq * l.W1S;
      const int wc = p.nbuf == 1 ? c * p.EC : 0;  // the chunk's first hidden unit in the buffer
      // lane l addresses row k = (l % 8) + 8 ((l / 8) % 2) of a 16-row k-step, column 8 (l / 16)
      const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
      const bf16* bw1 = w1s + (size_t)lrow * l.W1S + lcol;
      const bf16* bw2 = w2s + (size_t)lrow * l.W2S + p0 * 16 + lcol;
      const int e0 = rank * p.ES + c * p.EC - wc;  // b1's index of buffer column 0
      if (p.WN == 1)
        hidden_range<NP, KA>(acc, af, arow, bw1, bw2, b1, wc, p.EC, e0, nk, np, l, tq);
      else
        hidden_shared<NP, KA>(acc, af, arow, bw1, bw2, b1, wc, p.EC, e0, nk, np, l,
                              reinterpret_cast<bf16*>(smem + l.h) + (size_t)mf * 16 * l.HS, wn, p.WN, 1 + mf, lane);
    }
    if (c != nch - 1) continue;
    // phase: products continue

    if (p.CS == 1) {
      if (np > 0)
        warp_epilogue<NP>(acc, xt + (size_t)mf * 16 * l.XS, l.XS,
                          reinterpret_cast<bf16*>(smem + l.e) + (size_t)warp * 16 * l.ES, l.ES, b2, out, p.C, g.M,
                          m0 + mf * 16, p0, np, lane, p.DE);
    } else if constexpr (NP == 8) {
      // the block's partial sums over its hidden units to shared memory; the
      // block of rank r sums rows r, r + CS, ... over the cluster's blocks in
      // rank order, adds b2 and the residual, rounds once and stores them
      cg::cluster_group cluster = cg::this_cluster();
      float* part = reinterpret_cast<float*>(smem + l.e);
      if (reading) cluster_wait();  // every block is done reading the last tile's partials
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (j < np) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = (p0 + j) * 16 + hh * 8 + 2 * tq;
#pragma unroll
            for (int half = 0; half < 2; ++half)
              *reinterpret_cast<float2*>(part + (size_t)(mf * 16 + gq + half * 8) * l.ES + col) =
                  make_float2(acc[j][hh][2 * half], acc[j][hh][2 * half + 1]);
          }
        }
      }
      cluster_arrive();
      cluster_wait();  // every block's partials are written
      // phase: partials continue
      // a thread takes 4 columns of a row (neighbouring threads neighbouring
      // columns), eight blocks' partials in flight at once, summed in rank
      // order
      const int pieces = p.Cq / 4, rows = (p.BM - rank + p.CS - 1) / p.CS;
      for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
        const int r = rank + p.CS * (i / pieces), col = (i % pieces) * 4;
        const long long row = m0 + r;
        if (row >= g.M || col >= p.C) continue;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q0 = 0; q0 < p.CS; q0 += 8) {
          float4 a[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (q0 + q < p.CS)
              a[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q0 + q) + (size_t)r * l.ES + col);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (q0 + q < p.CS) {
              v.x += a[q].x;
              v.y += a[q].y;
              v.z += a[q].z;
              v.w += a[q].w;
            }
          }
        }
        const float4 bb = __ldg(reinterpret_cast<const float4*>(b2 + col));
        const bf16* xr = xt + (size_t)r * l.XS + col;
        const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr));
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + 2));
        const unsigned o0 = pack_bf16(v.x + bb.x + x0.x, v.y + bb.y + x0.y);
        const unsigned o1 = pack_bf16(v.z + bb.z + x1.x, v.w + bb.w + x1.y);
        if (p.C % 4 == 0) {
          *reinterpret_cast<uint2*>(out + row * p.C + col) = make_uint2(o0, o1);
        } else {
          const unsigned o[2] = {o0, o1};
          const bf16* ob = reinterpret_cast<const bf16*>(o);
          for (int k = 0; k < 4 && col + k < p.C; ++k) out[row * p.C + col + k] = ob[k];
        }
      }
      cluster_arrive();  // this block is done reading the partials; the next tile's wait comes before its writes
      reading = true;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][h][q] = 0.f;
  }
  if (reading) cluster_wait();  // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// the MLP, float32
// ---------------------------------------------------------------------------

// Block (tile t, column block blockIdx.y): rows [t BM, t BM + BM), outputs
// [cb0, cb0 + CB), hidden units in chunks of EH. First product: thread (tx =
// tid % TXH, ty = tid / TXH), TXH = EH / 4, holds rows ty + TYH i (i < RH,
// TYH = BM / RH) x hidden 4 tx .. 4 tx + 3 of the chunk. Second: thread (tx2
// = tid % TXO, ty2 = tid / TXO), TXO = CB / 8, holds rows ty2 + TYO i (i <
// RO) x outputs cb0 + 8 tx2 .. + 7. Rows past M are zero-filled and never
// stored; TXH TYH = TXO TYO = 256 threads.
template <int RH, int RO>
__global__ void __launch_bounds__(kThreads)
    mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanIn& p = g.p;
  const Layout l = layout(p);
  float* xs0 = reinterpret_cast<float*>(smem + l.x);
  float* hs = reinterpret_cast<float*>(smem + l.e);
  const size_t xtile = (size_t)p.BM * l.XS;
  const int tid = threadIdx.x;
  const int txh = p.EH / 4, tyh = kThreads / txh;
  const int tx = tid % txh, ty = tid / txh;
  const int txo = p.CB / 8, tyo = kThreads / txo;
  const int tx2 = tid % txo, ty2 = tid / txo;
  const int cb0 = blockIdx.y * p.CB;
  const XMap xm = x_map<float>(p.C, p.Cq, threadIdx.x, kThreads);
  const float* w1p = w1;
  const float* w2p = w2;
  if (p.resident) {
    float* w1s = reinterpret_cast<float*>(smem + l.w);
    float* w2s = reinterpret_cast<float*>(smem + l.w + l.wbuf);
    const int n = p.Cq * p.Eq / 4;
    for (int i = tid; i < n; i += kThreads) {
      cp_async<16>(w1s + 4 * i, w1 + 4 * i, true);
      cp_async<16>(w2s + 4 * i, w2 + 4 * i, true);
    }
    w1p = w1s;
    w2p = w2s;
  }
  const long long mine = blockIdx.x < g.tiles ? (g.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (mine > 0) stage_x(x, xs0, g.M, p.C, p.BM, l.XS, (long long)blockIdx.x * p.BM, xm);
  cp_async_commit();

  for (long long it = 0; it < mine; ++it) {
    const long long m0 = ((long long)blockIdx.x + it * gridDim.x) * p.BM;
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; the last tile's epilogue is done with the other buffer
    if (it + 1 < mine)
      stage_x(x, xs0 + ((it + 1) & 1) * xtile, g.M, p.C, p.BM, l.XS, m0 + (long long)gridDim.x * p.BM, xm);
    cp_async_commit();
    const float* xt = xs0 + (it & 1) * xtile;
    float acc[RO][8];
#pragma unroll
    for (int i = 0; i < RO; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int e0 = 0; e0 < p.Eq; e0 += p.EH) {
      float ha[RH][4];
#pragma unroll
      for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ha[i][j] = 0.f;
      const float* wk = w1p + e0 + 4 * tx;
#pragma unroll 2
      for (int k0 = 0; k0 < p.Cq; k0 += 4) {
        float4 a[RH];
#pragma unroll
        for (int i = 0; i < RH; ++i) a[i] = *reinterpret_cast<const float4*>(xt + (size_t)(ty + tyh * i) * l.XS + k0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 w = *reinterpret_cast<const float4*>(wk + (size_t)(k0 + u) * p.Eq);
#pragma unroll
          for (int i = 0; i < RH; ++i) {
            const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
            ha[i][0] = fmaf(av, w.x, ha[i][0]);
            ha[i][1] = fmaf(av, w.y, ha[i][1]);
            ha[i][2] = fmaf(av, w.z, ha[i][2]);
            ha[i][3] = fmaf(av, w.w, ha[i][3]);
          }
        }
      }
      const float4 bb = *reinterpret_cast<const float4*>(b1 + e0 + 4 * tx);
#pragma unroll
      for (int i = 0; i < RH; ++i)
        *reinterpret_cast<float4*>(hs + (size_t)(ty + tyh * i) * l.ES + 4 * tx) =
            make_float4(gelu_tanh(ha[i][0] + bb.x), gelu_tanh(ha[i][1] + bb.y), gelu_tanh(ha[i][2] + bb.z),
                        gelu_tanh(ha[i][3] + bb.w));
      __syncthreads();  // the chunk's hidden values are written
      const float* wn = w2p + (size_t)e0 * p.Cq + cb0 + 8 * tx2;
#pragma unroll 2
      for (int k0 = 0; k0 < p.EH; k0 += 4) {
        float4 hv[RO];
#pragma unroll
        for (int i = 0; i < RO; ++i) hv[i] = *reinterpret_cast<const float4*>(hs + (size_t)(ty2 + tyo * i) * l.ES + k0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 wa = *reinterpret_cast<const float4*>(wn + (size_t)(k0 + u) * p.Cq);
          const float4 wb = *reinterpret_cast<const float4*>(wn + (size_t)(k0 + u) * p.Cq + 4);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < RO; ++i) {
            const float hvi = u == 0 ? hv[i].x : u == 1 ? hv[i].y : u == 2 ? hv[i].z : hv[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hvi, wv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();  // the chunk's hidden values are read
    }
    // phase: products continue
    // epilogue: + b2 + x, stored where the row and column are real
    const int col = cb0 + 8 * tx2;
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      const int r = ty2 + tyo * i;
      const long long row = m0 + r;
      if (row >= g.M || col >= p.C) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = acc[i][j] + __ldg(b2 + col + j) + xt[(size_t)r * l.XS + col + j];
      if (p.C % 4 == 0 && col + 8 <= p.C) {
        float4* o = reinterpret_cast<float4*>(out + row * p.C + col);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int j = 0; j < 8 && col + j < p.C; ++j) out[row * p.C + col + j] = v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pointwise, float32: out (M, Cout) = x (M, C) @ W^T, W (Cout, C)
// ---------------------------------------------------------------------------
//
// Exact f32 on the CUDA cores (no TF32): each output is fmaf(x[k], W[n][k],
// acc) for k = 0 .. C-1 from zero, one rounding a term. Bound at (8 x 112^3
// rows, 32 -> 32): bytes (2.9 GB, 0.86 ms) over FMAs (11.5 G, 0.34 ms).
// - A block owns BN output columns (blockIdx.y) and keeps their weight
//   slice in shared memory, k-major, read as float4.
// - Each warp walks tiles of WM rows on its own, in chunks of BK columns of
//   x: a ring of kPwStages chunks per warp, filled by 16-byte cp.async, so
//   the next chunks' copies are in flight under this chunk's FMAs. No block
//   barrier after the weight is staged.
// - A thread owns 4 rows x 8 columns: per 4 k, 4 float4 loads of x and 8 of
//   the weight feed 128 FMAs. Its rows are ty + i * TYN, so the 8 rows of a
//   load fall on 8 different 16-byte bank groups (row stride BK + 4 floats).
// - Outputs go from registers to memory as float4; rows past M are
//   zero-filled when staged and never stored.

constexpr int kPwThreads = 128;
constexpr int kPwWarps = kPwThreads / 32;
constexpr int kPwStages = 3;

template <int BN, int BK>
struct PwF32 {
  static constexpr int TM = 4, TN = 8;
  static constexpr int TXN = BN / TN;       // threads across the columns
  static constexpr int TYN = 32 / TXN;      // threads down the rows
  static constexpr int WM = TYN * TM;       // rows per warp tile
  static constexpr int XS = BK + 4;         // row stride of a staged chunk (floats)
  static size_t smem(int C) { return (size_t)C * BN * 4 + (size_t)kPwWarps * kPwStages * WM * XS * 4; }
};

template <int BN, int BK>
__global__ void __launch_bounds__(kPwThreads)
    pointwise_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                         long long M, int C, int Cout) {
  using P = PwF32<BN, BK>;
  constexpr int TM = P::TM, TN = P::TN, TYN = P::TYN, WM = P::WM, XS = P::XS;
  constexpr int V = BK / 4;  // 16-byte pieces per staged row
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [C][BN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* xs = ws + (size_t)C * BN + (size_t)warp * kPwStages * WM * XS;
  const int n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < C * BN; i += kPwThreads) {
    const int n = i / C, k = i - n * C;
    ws[k * BN + n] = w[(size_t)(n0 + n) * C + k];
  }
  __syncthreads();

  const long long tiles = (M + WM - 1) / WM;
  const long long gw = (long long)blockIdx.x * kPwWarps + warp, nw = (long long)gridDim.x * kPwWarps;
  const long long mine = gw < tiles ? (tiles - gw + nw - 1) / nw : 0;
  const int nk = C / BK;
  const long long total = mine * nk;  // (tile, chunk) stages of this warp

  auto fetch = [&](long long s) {
    const long long m0 = (gw + s / nk * nw) * WM;
    const int k0 = (int)(s % nk) * BK;
    float* dst = xs + (s % kPwStages) * WM * XS;
    for (int i = lane; i < WM * V; i += 32) {
      const int r = i / V, v = i - r * V;
      const bool valid = m0 + r < M;
      cp_async<16>(dst + r * XS + v * 4, x + (valid ? (m0 + r) * C + k0 + v * 4 : 0), valid);
    }
  };

  const int tx = lane % P::TXN, ty = lane / P::TXN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kPwStages - 1; ++s) {
    if (s < total) fetch(s);
    cp_async_commit();
  }
  for (long long s = 0; s < total; ++s) {
    cp_async_wait<kPwStages - 2>();
    __syncwarp();  // every lane's copies of stage s landed; stage s - 1's buffer is free
    if (s + kPwStages - 1 < total) fetch(s + kPwStages - 1);
    cp_async_commit();
    const float* xb = xs + (s % kPwStages) * WM * XS + ty * XS;
    const int kc = (int)(s % nk);
    const float* wk = ws + (size_t)kc * BK * BN + tx * TN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(xb + i * TYN * XS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 w0 = *reinterpret_cast<const float4*>(wk + (kk + u) * BN);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + (kk + u) * BN + 4);
        const float wv[TN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
    if (kc == nk - 1) {
      const long long m0 = (gw + s / nk * nw) * WM;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long r = m0 + ty + i * TYN;
        if (r < M) {
          float4* o = reinterpret_cast<float4*>(out + r * Cout + n0 + tx * TN);
          o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pointwise, bfloat16: out (M, Cout) = round(x (M, C) @ W^T), W (Cout, C)
// ---------------------------------------------------------------------------
//
// On the tensor cores (ldmatrix + mma.sync m16n8k16, f32 accumulate, one
// rounding). Bound at (8 x 112^3 rows, 32 -> 32): bytes (1.44 GB, 0.43 ms);
// the products are 0.02 ms of tensor-core time.
// - A block owns up to 64 output columns (blockIdx.y) and stages their
//   (ncols, C) weight rows once. The row-major (Cout, C) weight is the mma B
//   operand's column-major layout, so a non-transposed ldmatrix loads its
//   fragments. Where C <= 16 KS and the block's columns <= 16 NP (KS, NP of
//   2 or 4), every fragment is loaded once into registers and kept for the
//   whole block (KS, NP fixed at compile time, so only the registers needed
//   are held); otherwise (KS = 0) they are read per k-step.
// - Each warp walks 32-row tiles on its own, in chunks of up to 64 columns
//   of x: a ring of kPbStages chunks per warp, filled by 16-byte cp.async, so
//   later tiles' loads are in flight under this tile's MMAs and stores. A
//   persistent grid (SMs x resident blocks); no block barrier after the
//   weight is staged.
// - Epilogue: the accumulators, rounded to bf16 pairs, go to the warp's own
//   shared tile by stmatrix, then out as 16-byte pieces of whole rows.
// - Shared row strides are odd multiples of 16 bytes (conflict-free
//   ldmatrix/stmatrix); rows past M are zero-filled and never stored.

constexpr int kPbThreads = 256;
constexpr int kPbWarps = kPbThreads / 32;
constexpr int kPbStages = 4;
constexpr int kPbRows = 32;   // rows of a warp tile (two 16-row fragments)
constexpr int kPbCols = 64;   // output columns a block owns at most
constexpr int kPbChunk = 64;  // columns of x a stage holds at most

struct PbGeom {
  long long M;
  int C, Cout;
  int NB;        // output columns per block (the last block may hold fewer)
  int KC;        // columns of x per chunk
  int WS, XS, ES;  // row strides (elements): weight rows, staged chunk rows, epilogue rows
};

__host__ __device__ inline size_t pb_weight_bytes(const PbGeom& g) { return (size_t)g.NB * g.WS * 2; }
__host__ __device__ inline size_t pb_warp_bytes(const PbGeom& g) {
  return (size_t)kPbStages * kPbRows * g.XS * 2 + (size_t)kPbRows * g.ES * 2;
}
inline size_t pb_smem(const PbGeom& g) { return pb_weight_bytes(g) + kPbWarps * pb_warp_bytes(g); }

template <int KS, int NP>
__global__ void __launch_bounds__(kPbThreads)
    pointwise_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ out, PbGeom g) {
  using T = __nv_bfloat16;
  constexpr bool REG = KS > 0;  // the weight's fragments in registers
  constexpr int MF = kPbRows / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  T* xs = reinterpret_cast<T*>(smem + pb_weight_bytes(g) + warp * pb_warp_bytes(g));
  T* es = xs + kPbStages * kPbRows * g.XS;
  const int n0 = blockIdx.y * g.NB;
  const int ncols = min(g.NB, g.Cout - n0);
  const int np = ncols / 16;
  {
    const int vec = g.C / 8;
    for (int i = threadIdx.x; i < ncols * vec; i += kPbThreads) {
      const int n = i / vec, v = i - n * vec;
      cp_async<16>(ws + (size_t)n * g.WS + v * 8, w + (size_t)(n0 + n) * g.C + v * 8, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // B fragments: pair j, k-step ks; lane l addresses row (l & 7) + 8 (l >> 4) of
  // the pair, columns 8 ((l >> 3) & 1) of the k-step
  const T* bbase = ws + (size_t)((lane & 7) + ((lane >> 4) << 3)) * g.WS + ((lane >> 3) & 1) * 8;
  unsigned bfrag[REG ? KS : 1][NP][4];  // [k-step][pair]
  if constexpr (REG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (ks * 16 < g.C && j < np) ldsm_x4(bfrag[ks][j], bbase + (size_t)j * 16 * g.WS + ks * 16);
  }

  // this warp's (tile, chunk) stages in order: tiles gw, gw + nw, ..., each in nk chunks
  const long long tiles = (g.M + kPbRows - 1) / kPbRows;
  const long long gw = (long long)blockIdx.x * kPbWarps + warp, nw = (long long)gridDim.x * kPbWarps;
  const int nk = (g.C + g.KC - 1) / g.KC;
  const long long total = (gw < tiles ? (tiles - gw + nw - 1) / nw : 0) * nk;
  long long it = gw;  // the next stage to fetch: tile, chunk, buffer
  int ik = 0, ib = 0;
  auto fetch = [&]() {
    const long long m0 = it * kPbRows;
    const int k0 = ik * g.KC;
    const int vec = min(g.KC, g.C - k0) / 8;
    T* dst = xs + ib * kPbRows * g.XS;
    for (int i = lane; i < kPbRows * vec; i += 32) {
      const int r = i / vec, v = i - r * vec;
      const bool valid = m0 + r < g.M;
      cp_async<16>(dst + r * g.XS + v * 8, x + (valid ? (m0 + r) * g.C + k0 + v * 8 : 0), valid);
    }
    if (++ik == nk) ik = 0, it += nw;
    if (++ib == kPbStages) ib = 0;
  };

  float acc[MF][NP][2][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[f][j][h][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kPbStages - 1; ++s) {
    if (s < total) fetch();
    cp_async_commit();
  }
  const T* arow = xs + (size_t)(lane & 15) * g.XS + (lane >> 4) * 8;
  T* erow = es + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * g.ES + (lane >> 4) * 8;  // stmatrix rows
  long long ct = gw;  // the stage computed: tile, chunk, buffer
  int ck = 0, cb = 0;
  for (long long s = 0; s < total; ++s) {
    cp_async_wait<kPbStages - 2>();
    __syncwarp();  // every lane's copies of this stage landed; the last stage's buffer and the epilogue tile are free
    if (s + kPbStages - 1 < total) fetch();
    cp_async_commit();
    const T* ab = arow + cb * kPbRows * g.XS;
    if constexpr (REG) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks * 16 >= g.C) break;
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          unsigned a[4];
          ldsm_x4(a, ab + f * 16 * g.XS + ks * 16);
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            if (j < np) {
              mma16816(acc[f][j][0], a, bfrag[ks][j][0], bfrag[ks][j][1]);
              mma16816(acc[f][j][1], a, bfrag[ks][j][2], bfrag[ks][j][3]);
            }
          }
        }
      }
    } else {
      const int k0 = ck * g.KC;
      const int steps = min(g.KC, g.C - k0) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        unsigned a[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) ldsm_x4(a[f], ab + f * 16 * g.XS + ks * 16);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (j < np) {
            unsigned b[4];
            ldsm_x4(b, bbase + (size_t)j * 16 * g.WS + k0 + ks * 16);
#pragma unroll
            for (int f = 0; f < MF; ++f) {
              mma16816(acc[f][j][0], a[f], b[0], b[1]);
              mma16816(acc[f][j][1], a[f], b[2], b[3]);
            }
          }
        }
      }
    }
    if (ck == nk - 1) {
      // stmatrix: matrix q of pair j is rows 8 (q & 1).., columns 16 j + 8 (q >> 1)..
#pragma unroll
      for (int f = 0; f < MF; ++f) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (j < np) {
            __nv_bfloat162 p[4] = {__floats2bfloat162_rn(acc[f][j][0][0], acc[f][j][0][1]),
                                   __floats2bfloat162_rn(acc[f][j][0][2], acc[f][j][0][3]),
                                   __floats2bfloat162_rn(acc[f][j][1][0], acc[f][j][1][1]),
                                   __floats2bfloat162_rn(acc[f][j][1][2], acc[f][j][1][3])};
            const unsigned* u = reinterpret_cast<const unsigned*>(p);
            stsm_x4(erow + (size_t)f * 16 * g.ES + j * 16, u[0], u[1], u[2], u[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[f][j][h][q] = 0.f;
        }
      }
      __syncwarp();
      const long long m0 = ct * kPbRows;
      const int vec = ncols / 8;
      for (int i = lane; i < kPbRows * vec; i += 32) {
        const int r = i / vec, v = i - r * vec;
        if (m0 + r < g.M)
          *reinterpret_cast<uint4*>(out + (m0 + r) * g.Cout + n0 + v * 8) =
              *reinterpret_cast<const uint4*>(es + (size_t)r * g.ES + v * 8);
      }
    }
    if (++ck == nk) ck = 0, ct += nw;
    if (++cb == kPbStages) cb = 0;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// The plan's fields hold together and fit the kernels; false otherwise.
inline bool valid(const PlanIn& p, long long M) {
  if (M < 1 || p.C < 1 || p.E < 1 || p.Cq < p.C || p.Eq < p.E || p.Cq % 16 || p.BM < 16 || p.BM % 16) return false;
  if (p.bf16) {
    if (p.MF < 1 || p.WN < 1 || p.MF * p.WN != kWarps || p.BM != 16 * p.MF || p.Cq > 1024) return false;
    if (p.NPW < 1 || p.NPW > p.NP || p.NPW * p.WN < p.Cq / 16) return false;
    if (!(p.NP == 2 || p.NP == 4 || p.NP == 8) || !(p.KA == 0 || p.KA == 2 || p.KA == 4 || p.KA == 8)) return false;
    if (p.KA && p.KA * 16 < p.Cq) return false;
    if (!(p.CS == 1 || p.CS == 2 || p.CS == 4 || p.CS == 8 || p.CS == 16) || p.BM < p.CS) return false;
    if (p.ES * p.CS != p.Eq || p.EC < 16 || p.EC % 16 || p.ES % p.EC) return false;
    if (!((p.nbuf == 1 && p.EC == p.ES) || p.nbuf == 2)) return false;
    if (p.XR < 2 || p.XR > 4 || (p.nbuf == 2 && p.XR != 2)) return false;
    if (p.CS > 1 && p.NP != 8) return false;  // the cluster's epilogue is built for NP 8
    if (p.WK && (p.CS != 1 || p.nbuf != 1 || p.WN != 1 || p.KA != p.NP || (p.DE && p.C % 2))) return false;
  } else {
    const int txo = p.CB / 8, txh = p.EH / 4;
    if (p.EH < 16 || !pow2(txh) || txh > kThreads || p.Eq % p.EH) return false;
    if (p.CB < 16 || p.Cq % p.CB || !pow2(txo) || txo > kThreads) return false;
    if (p.RH * (kThreads / txh) != p.BM || p.RO * (kThreads / txo) != p.BM) return false;
    if (!pow2(p.RH) || p.RH > 8 || !pow2(p.RO) || p.RO > 8) return false;
  }
  return layout(p).total <= kMaxSmem;
}

template <int NP>
const void* bf16_kernel_np(int ka) {
  switch (ka) {
    case 0: return reinterpret_cast<const void*>(mlp_bf16_kernel<NP, 0>);
    case 2: return reinterpret_cast<const void*>(mlp_bf16_kernel<NP, 2>);
    case 4: return reinterpret_cast<const void*>(mlp_bf16_kernel<NP, 4>);
    default: return reinterpret_cast<const void*>(mlp_bf16_kernel<NP, 8>);
  }
}

template <int RH>
const void* f32_kernel_rh(int ro) {
  switch (ro) {
    case 1: return reinterpret_cast<const void*>(mlp_f32_kernel<RH, 1>);
    case 2: return reinterpret_cast<const void*>(mlp_f32_kernel<RH, 2>);
    case 4: return reinterpret_cast<const void*>(mlp_f32_kernel<RH, 4>);
    default: return reinterpret_cast<const void*>(mlp_f32_kernel<RH, 8>);
  }
}

inline const void* kernel_for(const PlanIn& p) {
  if (p.bf16 && p.WK)  // KA == NP: x's fragments of C = 16 NP
    return p.NP == 2   ? reinterpret_cast<const void*>(mlp_bf16_warp_kernel<2, 2>)
           : p.NP == 4 ? reinterpret_cast<const void*>(mlp_bf16_warp_kernel<4, 4>)
                       : reinterpret_cast<const void*>(mlp_bf16_warp_kernel<8, 8>);
  if (p.bf16) return p.NP == 2 ? bf16_kernel_np<2>(p.KA) : p.NP == 4 ? bf16_kernel_np<4>(p.KA) : bf16_kernel_np<8>(p.KA);
  switch (p.RH) {
    case 1: return f32_kernel_rh<1>(p.RO);
    case 2: return f32_kernel_rh<2>(p.RO);
    case 4: return f32_kernel_rh<4>(p.RO);
    default: return f32_kernel_rh<8>(p.RO);
  }
}

// Clusters of `cs` blocks of kernel `fn` with `smem` bytes each that the
// current device holds at once, asked once per (device, kernel, smem, cs);
// 0, or a cudaError_t. The kernel's shared-memory attribute is set first
// (mednext::occupancy).
inline int active_clusters(const void* fn, size_t smem, int cs, int* n) {
  struct Entry {
    int dev;
    const void* fn;
    size_t smem;
    int cs, n;
  };
  static std::mutex mu;
  static Entry seen[64];
  static int count = 0;
  int dev = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int oe = mednext::occupancy(fn, kThreads, smem, &occ);
  if (oe) return oe;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < count; ++i) {
    if (seen[i].dev == dev && seen[i].fn == fn && seen[i].smem == smem && seen[i].cs == cs) {
      *n = seen[i].n;
      return 0;
    }
  }
  if (cs > 8) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs * mednext::sm_count(), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(n, fn, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (count < 64) seen[count++] = Entry{dev, fn, smem, cs, *n};
  return 0;
}

// The grid of plan p at M rows (persistent blocks, or clusters, as many as
// the card holds at once, at most one a tile); out[0] shared memory a
// block, out[1] tiles, out[2] resident blocks a SM, out[3] blocks of the
// grid, out[4] clusters the card holds at once (0 without a cluster). 0,
// kErrShape, or a cudaError_t.
inline int plan_grid(const PlanIn& p, long long M, int* out, dim3* grid) {
  if (!valid(p, M)) return kErrShape;
  const void* fn = kernel_for(p);
  const size_t smem = layout(p).total;
  const long long tiles = (M + p.BM - 1) / p.BM;
  int occ = 0, ncl = 0;
  int e = mednext::occupancy(fn, kThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  long long blocks;
  if (p.bf16 && p.CS > 1) {
    e = active_clusters(fn, smem, p.CS, &ncl);
    if (e) return e;
    if (ncl < 1) return kErrShape;
    blocks = (tiles < ncl ? tiles : ncl) * p.CS;
    *grid = dim3((unsigned)blocks, 1, 1);
  } else if (p.bf16) {
    // the warp kernel: as many blocks as hold one fragment a warp at most
    const long long want = (long long)mednext::sm_count() * occ;
    const long long need = p.WK ? ((M + 15) / 16 + kWarps - 1) / kWarps : tiles;
    blocks = need < want ? need : want;
    *grid = dim3((unsigned)blocks, 1, 1);
  } else {
    const int ncb = p.Cq / p.CB;
    const long long cap = ((long long)mednext::sm_count() * occ + ncb - 1) / ncb;
    const long long gx = tiles < cap ? tiles : cap;
    blocks = gx * ncb;
    *grid = dim3((unsigned)gx, (unsigned)ncb, 1);
  }
  out[0] = (int)smem;
  out[1] = (int)tiles;
  out[2] = occ;
  out[3] = (int)blocks;
  out[4] = ncl;
  return 0;
}

inline int launch(const PlanIn& p, long long M, const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, cudaStream_t stream) {
  int rep[5];
  dim3 grid;
  const int e = plan_grid(p, M, rep, &grid);
  if (e) return e;
  Geom g{p, M, (M + p.BM - 1) / p.BM};
  void* args[] = {(void*)&x, (void*)&w1, (void*)&b1, (void*)&w2, (void*)&b2, (void*)&out, (void*)&g};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)rep[0];
  cfg.stream = stream;
  if (p.bf16 && p.CS > 1) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.CS;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t le = cudaLaunchKernelExC(&cfg, kernel_for(p), args);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// Weight bytes a pointwise block keeps in shared memory at most.
constexpr size_t kPwWeightBytes = 98304;

template <int BN, int BK>
int launch_pw_f32(const void* x, const void* w, void* out, long long M, int C, int Cout, cudaStream_t stream) {
  using P = PwF32<BN, BK>;
  const auto kernel = pointwise_f32_kernel<BN, BK>;
  const size_t smem = P::smem(C);
  if (smem > kMaxSmem) return kErrShape;
  int occ = 0;
  const int e = mednext::occupancy(reinterpret_cast<const void*>(kernel), kPwThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  const int cols = Cout / BN;
  const long long tiles = (M + P::WM - 1) / P::WM;
  const long long want = (tiles + kPwWarps - 1) / kPwWarps;
  long long cap = (long long)mednext::sm_count() * occ / cols;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)cols);
  kernel<<<grid, kPwThreads, smem, stream>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                             static_cast<float*>(out), M, C, Cout);
  return (int)cudaGetLastError();
}

// The widest column block (64, 32 or 16) that divides Cout and whose weight
// slice fits kPwWeightBytes; chunks of 32 columns of x where C allows.
inline int pointwise_f32(const void* x, const void* w, void* out, long long M, int C, int Cout, cudaStream_t stream) {
  const bool bk32 = C % 32 == 0;
  const auto fits = [&](int bn) { return Cout % bn == 0 && (size_t)C * bn * 4 <= kPwWeightBytes; };
  if (fits(64)) return bk32 ? launch_pw_f32<64, 32>(x, w, out, M, C, Cout, stream)
                            : launch_pw_f32<64, 16>(x, w, out, M, C, Cout, stream);
  if (fits(32)) return bk32 ? launch_pw_f32<32, 32>(x, w, out, M, C, Cout, stream)
                            : launch_pw_f32<32, 16>(x, w, out, M, C, Cout, stream);
  if (fits(16)) return launch_pw_f32<16, 16>(x, w, out, M, C, Cout, stream);
  return kErrShape;
}

// Column blocks of at most 64 columns, balanced, whose weight rows fit 64 KB;
// chunks of x of at most 64 columns; the weight in registers where C <= 64.
inline int pointwise_bf16(const void* x, const void* w, void* out, long long M, int C, int Cout,
                          cudaStream_t stream) {
  if (C > 1024) return kErrShape;
  PbGeom g{};
  g.M = M, g.C = C, g.Cout = Cout;
  g.WS = odd_stride(C);
  g.KC = C < kPbChunk ? C : kPbChunk;
  g.XS = odd_stride(g.KC);
  int most = (int)(65536 / ((size_t)g.WS * 2)) / 16 * 16;
  if (most > kPbCols) most = kPbCols;
  if (most < 16) return kErrShape;
  const int blocks_n = (Cout + most - 1) / most;
  g.NB = ((Cout + blocks_n - 1) / blocks_n + 15) / 16 * 16;
  g.ES = odd_stride(g.NB);
  const int cols = (Cout + g.NB - 1) / g.NB;
  const size_t smem = pb_smem(g);
  if (smem > kMaxSmem) return kErrShape;
  const auto kernel = C <= 32 && g.NB <= 32   ? pointwise_bf16_kernel<2, 2>
                      : C <= 64 && g.NB <= 64 ? pointwise_bf16_kernel<4, 4>
                                              : pointwise_bf16_kernel<0, kPbCols / 16>;
  int occ = 0;
  const int e = mednext::occupancy(reinterpret_cast<const void*>(kernel), kPbThreads, smem, &occ);
  if (e) return e;
  if (occ < 1) return kErrShape;
  const long long tiles = (M + kPbRows - 1) / kPbRows;
  const long long want = (tiles + kPbWarps - 1) / kPbWarps;
  long long cap = (long long)mednext::sm_count() * occ / cols;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)cols);
  kernel<<<grid, kPbThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const __nv_bfloat16*>(w),
                                             static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace fmlp

// dtype: 0 = float32, 1 = bfloat16. All pointers 16-byte aligned, rows
// contiguous. Each returns 0 or an error code (a cudaError_t, or 10001 for a
// shape the kernel does not take).
extern "C" {

}  // namespace fmlp

// dtype: 0 = float32, 1 = bfloat16. All pointers 16-byte aligned, rows
// contiguous. Each returns 0 or an error code (a cudaError_t, or 10001 for a
// shape or plan the kernels do not take).
extern "C" {

// The fields of a plan (fmlp::PlanIn), for the caller to check its own list.
int fused_mlp_plan_fields() { return fmlp::kPlanFields; }

// The MLP with residual under `plan` (fmlp::PlanIn): x (M, C), out (M, C);
// the weights padded to the plan's widths: W1 (Cq, Eq), b1 (Eq,) f32, W2
// (Eq, Cq), b2 (Cq,) f32.
int fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                  const int* plan, long long M, void* stream) {
  fmlp::PlanIn p;
  memcpy(&p, plan, sizeof(p));
  return fmlp::launch(p, M, x, w1, b1, w2, b2, out, static_cast<cudaStream_t>(stream));
}

// What the card makes of `plan` at M rows: out[0] shared memory a block,
// out[1] tiles, out[2] resident blocks a SM, out[3] blocks of the grid,
// out[4] clusters the card holds at once (0 without a cluster), out[5]
// registers a thread. The first call for a kernel on a device lets it take
// all of the shared memory.
int fused_mlp_plan(const int* plan, long long M, int* out) {
  fmlp::PlanIn p;
  memcpy(&p, plan, sizeof(p));
  dim3 grid;
  const int e = fmlp::plan_grid(p, M, out, &grid);
  if (e) return e;
  cudaFuncAttributes fa;
  const cudaError_t fe = cudaFuncGetAttributes(&fa, fmlp::kernel_for(p));
  if (fe != cudaSuccess) return (int)fe;
  out[5] = fa.numRegs;
  return 0;
}

// The pointwise (1x1x1) conv: out (M, Cout) = round(x (M, C) @ w^T) for a
// weight w (Cout, C) in x's type; C and Cout multiples of 16.
int pointwise_fwd(const void* x, const void* w, void* out, int dtype, long long M, int C, int Cout, void* stream) {
  using namespace fmlp;
  if (M < 1 || C < 16 || Cout < 16 || C % 16 || Cout % 16) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  if (!dtype) return pointwise_f32(x, w, out, M, C, Cout, s);
  return pointwise_bf16(x, w, out, M, C, Cout, s);
}

const char* fused_mlp_error_string(int code) {
  if (code == fmlp::kErrShape) return "shape not supported by the fused MLP kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
