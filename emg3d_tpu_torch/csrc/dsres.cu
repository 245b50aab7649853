// Double-single (two-float) residual for Hopper (sm_90a): K6.
//
// Replaces emg3d_tpu/ops/dsres.py:170 (residual_ds), which XLA fuses into
// a few TPU kernels: r = s − A·(hi + lo) of a complex64 solve, evaluated
// on the SAME float32 operator the smoothers relax (the level's float32
// η edge sums, ζ face weights and inverse widths, as ops/dsres.py
// computes them) in double-single arithmetic, and folded to float32
// (hi + lo per channel).  The two-float multigrid evaluates it once per
// cycle as its convergence residual and correction-form source, and the
// Krylov refinement once per pass; in plain torch it is some six hundred
// elementwise launches per evaluation.
//
// The lanes of a batched solve are on grid y: lane b's hi, lo, s and r
// are the lane's slices of (B, ...) tensors, its η sums too where they
// carry a lane axis (``st_lanes``; one frequency per lane), ζ weights
// and widths are shared.  A PEC edge (tangential on the boundary) keeps
// r = s, as in the JAX package.
//
// Arithmetic.  Every sum is Knuth's two-sum and every product by a
// float32 coefficient an error-free two-product, in the order of the
// JAX package's _dadd/_dscale/_cmul_plain.  The two-product here is
// p = a·b, err = fma(a, b, −p), exact on the card; the plain torch
// version keeps Dekker's split (torch ops never fuse), which gives the
// same exact err, so kernel and plain version agree bit for bit.  Every
// operation is an explicit round-to-nearest intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fmaf_rn), which nvcc never contracts: with its
// default --fmad=true a plain `e + lo * c` could become an fma and the
// lo channel would round differently.
//
// Bound on this card: bytes and instructions alike.  Per edge the
// function reads hi, lo and s (24 B) and writes r (8 B), plus the η sum
// and ζ weights: 0.664 ms at 256³ at 3.35 TB/s (chip_smoke.dsres_work).
// It needs ~460 float32 operations per interior edge (each face curl
// once, 150 per face, and 310 for the edge itself), almost all of them
// __fadd_rn/__fsub_rn: one instruction per operation, so the H100's
// 67 TFLOP/s fp32 (an fma counted as two) is 33.5 T instructions/s here
// (132 SMs × 128 lanes × 1.98 GHz), and the instruction floor is
// ≈ 0.69 ms at 256³, level with the bytes.  chip_smoke's bound keeps
// the 67 TFLOP/s peak (0.34 ms), so its share stays comparable.
//
// Design: a block owns a (tj × 32) tile of y-z indices, z fastest (one
// warp a row), and marches along x over a chunk of planes.  For each
// plane it stages ex of the cell plane and ey, ez of the next node
// plane, hi and lo, with a one-cell halo, in shared memory by cp.async
// (8 B per element at any offset, zero-filled outside the arrays) one
// plane ahead, in a ring of three stages.  From those it computes every
// ζ-weighted face curl of the plane once (u1 at node i, u2 and u3 of
// cell plane i), times each of the two inverse widths its second curls
// take, into shared memory, keeping u2·ihx and u3·ihx of plane i−1 for
// the ey/ez rows at node i (the plain version, too, scales each face
// once and differences); then each thread forms the second curl, the η
// term and the fold of the ex, ey and ez edges at its (j, k).  With the
// tile's halo faces and one plane of faces again per chunk that is ~450
// operations per edge at 256³ (chip_smoke.dsres_ops), 0.67 ms at the
// add rate; the first design, one thread per edge recomputing the four
// face curls its row takes (~910 operations per edge, 64-bit div/mod to
// find its indices), took about twice as long.  Index arithmetic is
// 32-bit inside a lane's slice; no div/mod per edge.  The s, η-sum and
// ζ-weight loads of a plane are issued before its barrier.  The grid is
// (tiles × chunks, lanes); ops/dsres.py's ``tile_plan`` chooses it (its
// chunk from the card's table) and the entry point refuses a plan that
// does not cover the level.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct DS {
  float hi, lo;
};
struct CDS {
  DS re, im;
};

__device__ __forceinline__ DS two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bp = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bp)), __fsub_rn(b, bp))};
}
// (dsres._dadd) s, e = two_sum(x.hi, y.hi); e += x.lo + y.lo; two_sum(s, e).
__device__ __forceinline__ DS dadd(DS x, DS y) {
  const DS s = two_sum(x.hi, y.hi);
  return two_sum(s.hi, __fadd_rn(s.lo, __fadd_rn(x.lo, y.lo)));
}
__device__ __forceinline__ DS dsub(DS x, DS y) {
  return dadd(x, DS{-y.hi, -y.lo});
}
// x · c for a float32 coefficient c (dsres._dscale).
__device__ __forceinline__ DS dscale(DS x, float c) {
  const float p = __fmul_rn(x.hi, c);
  const float e = __fmaf_rn(x.hi, c, -p);
  return two_sum(p, __fadd_rn(e, __fmul_rn(x.lo, c)));
}
// x · c for an exact power of two (0.5, 0.25).
__device__ __forceinline__ DS dpow2(DS x, float c) {
  return {__fmul_rn(x.hi, c), __fmul_rn(x.lo, c)};
}

__device__ __forceinline__ CDS cadd(CDS a, CDS b) {
  return {dadd(a.re, b.re), dadd(a.im, b.im)};
}
__device__ __forceinline__ CDS csub(CDS a, CDS b) {
  return {dsub(a.re, b.re), dsub(a.im, b.im)};
}
__device__ __forceinline__ CDS cscale(CDS a, float c) {
  return {dscale(a.re, c), dscale(a.im, c)};
}
__device__ __forceinline__ CDS cpow2(CDS a, float c) {
  return {dpow2(a.re, c), dpow2(a.im, c)};
}
// Complex DS × plain complex w (dsres._cmul_plain).
__device__ __forceinline__ CDS cmul_plain(CDS a, float2 w) {
  return {dsub(dscale(a.re, w.x), dscale(a.im, w.y)),
          dadd(dscale(a.re, w.y), dscale(a.im, w.x))};
}

struct DsArgs {
  float2* rx;           // residual out, same shapes as e
  float2* ry;
  float2* rz;
  const float2* hx;     // hi stream (nx, ny+1, nz+1), (nx+1, ny, nz+1),
  const float2* hy;     //   (nx+1, ny+1, nz)
  const float2* hz;
  const float2* lx;     // lo stream, same shapes, or null (zero)
  const float2* ly;
  const float2* lz;
  const float2* sx;     // source, same shapes
  const float2* sy;
  const float2* sz;
  const float2* stx;    // η edge sums (nx, ny-1, nz-1), (nx-1, ny, nz-1),
  const float2* sty;    //   (nx-1, ny-1, nz)
  const float2* stz;
  const float* wx;      // ζ face weights (nx+1, ny, nz), (nx, ny+1, nz),
  const float* wy;      //   (nx, ny, nz+1)
  const float* wz;
  const float* ihx;     // inverse widths
  const float* ihy;
  const float* ihz;
  int nx, ny, nz;
};

// Moves the lane-carrying pointers to lane blockIdx.y's slices.
__device__ __forceinline__ void lane_slices(DsArgs& a, int st_lanes) {
  const int64_t nx = a.nx, ny = a.ny, nz = a.nz;
  const int64_t nex = nx * (ny + 1) * (nz + 1);
  const int64_t ney = (nx + 1) * ny * (nz + 1);
  const int64_t nez = (nx + 1) * (ny + 1) * nz;
  const int64_t b = blockIdx.y;
  a.rx += b * nex;
  a.hx += b * nex;
  a.sx += b * nex;
  a.ry += b * ney;
  a.hy += b * ney;
  a.sy += b * ney;
  a.rz += b * nez;
  a.hz += b * nez;
  a.sz += b * nez;
  if (a.lx) {
    a.lx += b * nex;
    a.ly += b * ney;
    a.lz += b * nez;
  }
  if (st_lanes) {
    a.stx += b * nx * (ny - 1) * (nz - 1);
    a.sty += b * (nx - 1) * ny * (nz - 1);
    a.stz += b * (nx - 1) * (ny - 1) * nz;
  }
}

// r = s − (½·rr − ¼·(st·e)) at an interior edge, folded to float32.
__device__ __forceinline__ float2 fold(float2 s, CDS rr, float2 st, CDS e) {
  const CDS ax = csub(cpow2(rr, 0.5f), cpow2(cmul_plain(e, st), 0.25f));
  const CDS r = csub(CDS{{s.x, 0.f}, {s.y, 0.f}}, ax);
  return make_float2(__fadd_rn(r.re.hi, r.re.lo), __fadd_rn(r.im.hi, r.im.lo));
}

// ---------------------------------------------------------------------
// tiled
// ---------------------------------------------------------------------

constexpr int kTK = 32;          // tile columns (z): one warp a row
constexpr int kMaxTJ = 8;        // tile rows (y): blockDim.y
constexpr int kES = kTK + 2;     // edge-tile row: one halo column each side
constexpr int kFS = kTK + 1;     // face-tile row: one halo column below
constexpr int kStages = 3;       // edge-stage ring

// Shared-memory bytes of a tile of ``tj`` rows: the ring of edge stages
// (ex, ey, ez of (tj+2) × kES entries, each the hi and lo of a complex64
// value in 16 B) and eight face planes of (tj+1) × kFS complex DS values
// (16 B): each face curl times the two inverse widths its second curls
// take, u1·ihz, u1·ihy, u2·ihz, u3·ihy of this plane and u2·ihx, u3·ihx
// of this plane and the one before (ops/dsres.py mirrors it).
__host__ __device__ constexpr int tile_smem(int tj) {
  return kStages * 3 * (tj + 2) * kES * 16 + 8 * (tj + 1) * kFS * 16;
}

struct Tile {
  int chunk;     // x planes per block
  int tiles_j;   // tiles along y, ceil(ny / tj)
  int tiles_k;   // tiles along z, ceil(nz / kTK)
};

// One 8-byte element global → shared through cp.async.ca, or zeros
// where ``ok`` is false (src-size 0: ``src`` is then any valid address).
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage p of the march: ex of cell plane p (when ``with_ex``) and ey, ez
// of node plane p+1 at rows j0-1 .. j0+tj and columns k0-1 .. k0+kTK,
// into ``dst`` (3 planes of ``ne`` entries: ex, ey, ez; an entry holds
// hi in .x/.y and lo in .z/.w); zeros outside the arrays.
template <bool kLo>
__device__ __forceinline__ void load_stage(const DsArgs& a, float4* dst,
                                           int p, bool with_ex, int j0,
                                           int k0, int ne, int tid,
                                           int nthreads) {
  const int ny = a.ny, nz = a.nz;
  auto put = [](float4* e, const float2* h, const float2* l, int n,
                bool ok) {
    float2* d = reinterpret_cast<float2*>(e);
    cp_async8(d, h + n, ok);
    if constexpr (kLo) cp_async8(d + 1, l + n, ok);
  };
  for (int q = tid; q < ne; q += nthreads) {
    const int r = q / kES;
    const int j = j0 - 1 + r, k = k0 - 1 + (q - r * kES);
    const bool jn = j >= 0 && j <= ny, jc = j >= 0 && j < ny;
    const bool kn = k >= 0 && k <= nz, kc = k >= 0 && k < nz;
    if (with_ex) {
      const bool ok = jn && kn;
      put(dst + q, a.hx, a.lx, ok ? (p * (ny + 1) + j) * (nz + 1) + k : 0,
          ok);
    }
    {
      const bool ok = jc && kn;
      put(dst + ne + q, a.hy, a.ly,
          ok ? ((p + 1) * ny + j) * (nz + 1) + k : 0, ok);
    }
    {
      const bool ok = jn && kc;
      put(dst + 2 * ne + q, a.hz, a.lz,
          ok ? ((p + 1) * (ny + 1) + j) * nz + k : 0, ok);
    }
  }
}

// The DS value of entry q of component c (0 ex, 1 ey, 2 ez) of a stage.
template <bool kLo>
__device__ __forceinline__ CDS edge(const float4* stage, int ne, int c,
                                    int q) {
  const float4 v = stage[c * ne + q];
  return kLo ? CDS{{v.x, v.z}, {v.y, v.w}} : CDS{{v.x, 0.f}, {v.y, 0.f}};
}

__device__ __forceinline__ CDS unpack(float4 v) {
  return {{v.x, v.y}, {v.z, v.w}};
}
__device__ __forceinline__ float4 pack(CDS c) {
  return make_float4(c.re.hi, c.re.lo, c.im.hi, c.im.lo);
}

// The ζ-weighted face curls at tile entry q of x-plane p (dsres: v =
// first curl, u = v·w), from ``prev`` (node plane p: ey, ez) and ``cur``
// (cell plane p: ex; node plane p+1), with their widths and weight.
// u1: x-face at node p, cell (j, k).
template <bool kLo>
__device__ __forceinline__ CDS face_u1(const float4* prev, int ne, int q,
                                       float ihy, float ihz, float w) {
  const CDS v = csub(cscale(csub(edge<kLo>(prev, ne, 2, q + kES),
                                 edge<kLo>(prev, ne, 2, q)), ihy),
                     cscale(csub(edge<kLo>(prev, ne, 1, q + 1),
                                 edge<kLo>(prev, ne, 1, q)), ihz));
  return cscale(v, w);
}
// u2: y-face at y-node j of cell (p, k).
template <bool kLo>
__device__ __forceinline__ CDS face_u2(const float4* prev,
                                       const float4* cur, int ne, int q,
                                       float ihz, float ihx, float w) {
  const CDS v = csub(cscale(csub(edge<kLo>(cur, ne, 0, q + 1),
                                 edge<kLo>(cur, ne, 0, q)), ihz),
                     cscale(csub(edge<kLo>(cur, ne, 2, q),
                                 edge<kLo>(prev, ne, 2, q)), ihx));
  return cscale(v, w);
}
// u3: z-face at z-node k of cell (p, j).
template <bool kLo>
__device__ __forceinline__ CDS face_u3(const float4* prev,
                                       const float4* cur, int ne, int q,
                                       float ihx, float ihy, float w) {
  const CDS v = csub(cscale(csub(edge<kLo>(cur, ne, 1, q),
                                 edge<kLo>(prev, ne, 1, q)), ihx),
                     cscale(csub(edge<kLo>(cur, ne, 0, q + kES),
                                 edge<kLo>(cur, ne, 0, q)), ihy));
  return cscale(v, w);
}

template <bool kLo>
__global__ void __launch_bounds__(kTK * kMaxTJ, 2)
residual_ds_tiled(DsArgs a, Tile t, int st_lanes) {
  extern __shared__ float4 smem[];
  lane_slices(a, st_lanes);
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int tj = blockDim.y;
  // Block → (chunk, tile row, tile column), the tile column fastest.
  int b = blockIdx.x;
  const int ck = b % t.tiles_k;
  b /= t.tiles_k;
  const int cj = b % t.tiles_j;
  const int ch = b / t.tiles_j;
  const int j0 = cj * tj, k0 = ck * kTK;
  const int i0 = ch * t.chunk, i1 = min(i0 + t.chunk, nx);
  const int jl = threadIdx.y, kl = threadIdx.x;
  const int tid = jl * kTK + kl, nthreads = tj * kTK;
  const int nf = (tj + 1) * kFS, ne = (tj + 2) * kES;
  float4* u1z = smem;            // u1·ihz of this plane
  float4* u1y = smem + nf;       // u1·ihy
  float4* u2z = smem + 2 * nf;   // u2·ihz
  float4* u3y = smem + 3 * nf;   // u3·ihy
  float4* u2x = smem + 4 * nf;   // u2·ihx of planes of parity 0, 1
  float4* u3x = smem + 6 * nf;   // u3·ihx likewise
  float4* ring = smem + 8 * nf;  // kStages stages of 3 · ne entries
  // This thread's (j, k), its entry in the face and edge tiles, which of
  // its faces and edges exist, and which edges are interior (ey, ez also
  // need 0 < p < nx).
  const int j = j0 + jl, k = k0 + kl;
  const int fq = (jl + 1) * kFS + kl + 1, eq = (jl + 1) * kES + kl + 1;
  const bool f1 = j < ny && k < nz, f2 = j <= ny && k < nz;
  const bool f3 = j < ny && k <= nz;
  const bool ex_ok = j <= ny && k <= nz, ey_ok = f3, ez_ok = f2;
  const bool ex_in = j > 0 && j < ny && k > 0 && k < nz;
  const bool ey_in = j < ny && k > 0 && k < nz;
  const bool ez_in = j > 0 && j < ny && k < nz;
  // Its inverse widths at j and k, the same on every plane.
  const float ihy0 = j < ny ? a.ihy[j] : 0.f;
  const float ihz0 = k < nz ? a.ihz[k] : 0.f;
  // The index row ny and column nz beyond the last tile's (tj × kTK)
  // (only where tj, kTK divide ny, nz): every edge there is PEC.
  const bool xrow = j0 + tj == ny, xcol = k0 + kTK == nz;
  const int nrow = xrow ? kTK + (xcol ? 1 : 0) : 0;
  const int nextra = nrow + (xcol ? tj : 0);

  // r = s on the (PEC) edges of node plane p at index (jj, kk): ey, ez.
  auto copy_node = [&](int p, int jj, int kk) {
    if (jj < ny && kk <= nz) {
      const int n = (p * ny + jj) * (nz + 1) + kk;
      a.ry[n] = a.sy[n];
    }
    if (jj <= ny && kk < nz) {
      const int n = (p * (ny + 1) + jj) * nz + kk;
      a.rz[n] = a.sz[n];
    }
  };

  // Stage ps holds ey, ez of node plane i0-1 (or 0), from which the
  // chunk's first plane of u2/u3 is computed (each chunk but the first
  // computes plane i0-1 again; its ex is not needed).
  const int ps = i0 > 0 ? i0 - 2 : -1;
  load_stage<kLo>(a, ring, ps, false, j0, k0, ne, tid, nthreads);
  cp_async_commit();
  for (int p = ps, it = 0; p < i1; ++p, ++it) {
    // The plane's global operands, requested before the barrier so that
    // their latency overlaps it: the weights and x-widths of its faces,
    // s and the η sums of its edges.
    const bool faces = it > 0, edges = p >= i0;
    float w1 = 0.f, w2 = 0.f, w3 = 0.f, ihx0 = 0.f;
    float2 sx{}, sy{}, sz{}, tx{}, ty{}, tz{};
    const int nx_ = (p * (ny + 1) + j) * (nz + 1) + k;
    const int ny_ = (p * ny + j) * (nz + 1) + k;
    const int nz_ = (p * (ny + 1) + j) * nz + k;
    if (faces) {
      ihx0 = a.ihx[p];
      if (f1) w1 = a.wx[(p * ny + j) * nz + k];
      if (f2) w2 = a.wy[(p * (ny + 1) + j) * nz + k];
      if (f3) w3 = a.wz[(p * ny + j) * (nz + 1) + k];
    }
    if (edges) {
      if (ex_ok) sx = a.sx[nx_];
      if (ex_in) tx = a.stx[(p * (ny - 1) + j - 1) * (nz - 1) + k - 1];
      if (ey_ok) sy = a.sy[ny_];
      if (ey_in && p > 0) {
        ty = a.sty[((p - 1) * ny + j) * (nz - 1) + k - 1];
      }
      if (ez_ok) sz = a.sz[nz_];
      if (ez_in && p > 0) {
        tz = a.stz[((p - 1) * (ny - 1) + j - 1) * nz + k];
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // Stage p landed; every thread is done with plane p-1's tiles.
    if (p + 1 < i1) {
      load_stage<kLo>(a, ring + ((it + 1) % kStages) * 3 * ne, p + 1, true,
                      j0, k0, ne, tid, nthreads);
    }
    cp_async_commit();
    if (!faces) continue;
    const float4* cur = ring + (it % kStages) * 3 * ne;
    const float4* prev = ring + ((it + 2) % kStages) * 3 * ne;
    float4* u2xc = u2x + (it & 1) * nf;
    float4* u3xc = u3x + (it & 1) * nf;
    const float4* u2xp = u2x + ((it + 1) & 1) * nf;
    const float4* u3xp = u3x + ((it + 1) & 1) * nf;

    // Faces of plane p at this thread's (j, k), where they exist, each
    // times the two widths its second curls take.
    if (f1) {
      const CDS u = face_u1<kLo>(prev, ne, eq, ihy0, ihz0, w1);
      u1z[fq] = pack(cscale(u, ihz0));
      u1y[fq] = pack(cscale(u, ihy0));
    }
    if (f2) {
      const CDS u = face_u2<kLo>(prev, cur, ne, eq, ihz0, ihx0, w2);
      u2z[fq] = pack(cscale(u, ihz0));
      u2xc[fq] = pack(cscale(u, ihx0));
    }
    if (f3) {
      const CDS u = face_u3<kLo>(prev, cur, ne, eq, ihx0, ihy0, w3);
      u3y[fq] = pack(cscale(u, ihy0));
      u3xc[fq] = pack(cscale(u, ihx0));
    }
    // The halo faces the tile's edges take, times the one width they
    // take there: u3·ihy and u1·ihy of row j0-1, u1·ihz and u2·ihz of
    // column k0-1 (warps 0-3, fewer where tj < 4).
    for (int h = jl; h < 4; h += tj) {
      const bool row = h < 2;
      const int hj = row ? j0 - 1 : j0 + kl;
      const int hk = row ? k0 + kl : k0 - 1;
      if (hj < 0 || hk < 0 || (!row && kl >= tj)) continue;
      const int hf = row ? kl + 1 : (kl + 1) * kFS;
      const int he = row ? kl + 1 : (kl + 1) * kES;
      if (h == 0) {
        if (hj < ny && hk <= nz) {
          const float ihy = a.ihy[hj];
          u3y[hf] = pack(cscale(face_u3<kLo>(
              prev, cur, ne, he, ihx0, ihy,
              a.wz[(p * ny + hj) * (nz + 1) + hk]), ihy));
        }
      } else if (h == 3) {
        if (hj <= ny && hk < nz) {
          const float ihz = a.ihz[hk];
          u2z[hf] = pack(cscale(face_u2<kLo>(
              prev, cur, ne, he, ihz, ihx0,
              a.wy[(p * (ny + 1) + hj) * nz + hk]), ihz));
        }
      } else if (hj < ny && hk < nz) {
        const float ihy = a.ihy[hj], ihz = a.ihz[hk];
        const CDS u = face_u1<kLo>(prev, ne, he, ihy, ihz,
                                   a.wx[(p * ny + hj) * nz + hk]);
        if (h == 1) {
          u1y[hf] = pack(cscale(u, ihy));
        } else {
          u1z[hf] = pack(cscale(u, ihz));
        }
      }
    }
    __syncthreads();
    if (!edges) continue;

    // ex of cell plane p at (j, k).
    if (ex_in) {
      const CDS rr = csub(csub(unpack(u3y[fq]), unpack(u3y[fq - kFS])),
                          csub(unpack(u2z[fq]), unpack(u2z[fq - 1])));
      a.rx[nx_] = fold(sx, rr, tx, edge<kLo>(cur, ne, 0, eq));
    } else if (ex_ok) {
      a.rx[nx_] = sx;
    }
    // ey and ez of node plane p at (j, k).
    if (ey_in && p > 0) {
      const CDS rr = csub(csub(unpack(u1z[fq]), unpack(u1z[fq - 1])),
                          csub(unpack(u3xc[fq]), unpack(u3xp[fq])));
      a.ry[ny_] = fold(sy, rr, ty, edge<kLo>(prev, ne, 1, eq));
    } else if (ey_ok) {
      a.ry[ny_] = sy;
    }
    if (ez_in && p > 0) {
      const CDS rr = csub(csub(unpack(u2xc[fq]), unpack(u2xp[fq])),
                          csub(unpack(u1y[fq]), unpack(u1y[fq - kFS])));
      a.rz[nz_] = fold(sz, rr, tz, edge<kLo>(prev, ne, 2, eq));
    } else if (ez_ok) {
      a.rz[nz_] = sz;
    }
    // The extra row/column: ex at cell plane p, ey/ez at node plane p.
    for (int q = tid; q < nextra; q += nthreads) {
      const bool in_row = q < nrow;
      const int jj = in_row ? ny : j0 + q - nrow;
      const int kk = in_row ? k0 + q : nz;
      if (jj <= ny && kk <= nz) {
        const int n = (p * (ny + 1) + jj) * (nz + 1) + kk;
        a.rx[n] = a.sx[n];
      }
      copy_node(p, jj, kk);
    }
  }
  // Node plane nx (the last chunk): every ey, ez edge there is PEC.
  if (i1 == nx) {
    copy_node(nx, j, k);
    for (int q = tid; q < nextra; q += nthreads) {
      const bool in_row = q < nrow;
      copy_node(nx, in_row ? ny : j0 + q - nrow, in_row ? k0 + q : nz);
    }
  }
}

template <bool kLo>
int launch_tiled(const DsArgs& a, Tile t, int st_lanes, int tj, int blocks,
                 int lanes, int smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      residual_ds_tiled<kLo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  residual_ds_tiled<kLo><<<dim3(blocks, lanes), dim3(kTK, tj), smem, s>>>(
      a, t, st_lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by emg3d_tpu_torch/ops/dsres.py: K6 on
// complex64 tensors (float32 weights and widths) over ``lanes`` lanes.
// ``lx``, ``ly``, ``lz`` may be null (a zero lo stream).  The plan is
// ops/dsres.py's ``tile_plan``: tile (tj × tk) cells, ``chunk`` x planes
// per block, ``blocks`` = tiles × chunks, ``threads`` = tj·tk and
// ``smem`` bytes.  A plan that does not cover the level as the kernel
// needs returns cudaErrorInvalidValue and launches nothing; otherwise
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int emg3d_residual_ds_c64(
    void* rx, void* ry, void* rz, const void* hx, const void* hy,
    const void* hz, const void* lx, const void* ly, const void* lz,
    const void* sx, const void* sy, const void* sz, const void* stx,
    const void* sty, const void* stz, const void* wx, const void* wy,
    const void* wz, const void* ihx, const void* ihy, const void* ihz,
    int nx, int ny, int nz, int lanes, int st_lanes, int tj, int tk,
    int chunk, int blocks, int threads, int smem, void* stream) {
  const int64_t node = static_cast<int64_t>(nx + 1) * (ny + 1) * (nz + 1);
  if (nx < 1 || ny < 1 || nz < 1 || lanes < 1 || lanes > 65535 ||
      (lx == nullptr) != (ly == nullptr) ||
      (lx == nullptr) != (lz == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tile t{chunk, (ny + tj - 1) / (tj > 0 ? tj : 1), (nz + kTK - 1) / kTK};
  // 32-bit indices inside a lane's slice; the plan's tiles and chunks.
  if (node >= (int64_t{1} << 31) || tk != kTK || tj < 1 || tj > kMaxTJ ||
      threads != tj * tk || chunk < 1 ||
      static_cast<int64_t>(t.tiles_j) * t.tiles_k *
              ((nx + chunk - 1) / chunk) != blocks ||
      smem != tile_smem(tj)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DsArgs a;
  a.rx = static_cast<float2*>(rx);
  a.ry = static_cast<float2*>(ry);
  a.rz = static_cast<float2*>(rz);
  a.hx = static_cast<const float2*>(hx);
  a.hy = static_cast<const float2*>(hy);
  a.hz = static_cast<const float2*>(hz);
  a.lx = static_cast<const float2*>(lx);
  a.ly = static_cast<const float2*>(ly);
  a.lz = static_cast<const float2*>(lz);
  a.sx = static_cast<const float2*>(sx);
  a.sy = static_cast<const float2*>(sy);
  a.sz = static_cast<const float2*>(sz);
  a.stx = static_cast<const float2*>(stx);
  a.sty = static_cast<const float2*>(sty);
  a.stz = static_cast<const float2*>(stz);
  a.wx = static_cast<const float*>(wx);
  a.wy = static_cast<const float*>(wy);
  a.wz = static_cast<const float*>(wz);
  a.ihx = static_cast<const float*>(ihx);
  a.ihy = static_cast<const float*>(ihy);
  a.ihz = static_cast<const float*>(ihz);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lx ? launch_tiled<true>(a, t, st_lanes, tj, blocks, lanes, smem, s)
            : launch_tiled<false>(a, t, st_lanes, tj, blocks, lanes, smem,
                                  s);
}
