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
// One thread per edge, all three components in one launch (thread t
// takes ex edges first, then ey, then ez, C order), the lanes of a
// batched solve on grid y: lane b's hi, lo, s and r are the lane's
// slices of (B, ...) tensors, its η sums too where they carry a lane axis
// (``st_lanes``; one frequency per lane), ζ weights and widths are shared.
// A PEC edge (tangential on the boundary) keeps r = s, as in the JAX
// package.  Each interior edge recomputes the four ζ-weighted curls its
// row takes (the plain version computes every face once and slices);
// the values, and their operation order, are the same.
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
// Bound on this card: bytes.  Per edge the function reads hi, lo and s
// (24 B) and writes r (8 B), plus the η sum and ζ weights; it needs ~460
// float32 operations per interior edge (each face curl once, 150, and
// 310 for the edge itself; chip_smoke.dsres_work), half the bytes'
// time.  This kernel does ~910, recomputing its four face curls, all
// in registers.
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

__device__ __forceinline__ int64_t at(int i, int j, int k, int n1, int n2) {
  return (static_cast<int64_t>(i) * n1 + j) * n2 + k;
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

// The field's DS value at an edge (hi, and lo or 0).
__device__ __forceinline__ CDS load(const float2* h, const float2* l,
                                    int64_t n) {
  const float2 v = h[n];
  const float2 w = l ? l[n] : make_float2(0.f, 0.f);
  return {{v.x, w.x}, {v.y, w.y}};
}

#define EX(i, j, k) load(a.hx, a.lx, at(i, j, k, a.ny + 1, a.nz + 1))
#define EY(i, j, k) load(a.hy, a.ly, at(i, j, k, a.ny, a.nz + 1))
#define EZ(i, j, k) load(a.hz, a.lz, at(i, j, k, a.ny + 1, a.nz))

// ζ-weighted curls on faces (dsres: v = first curl, u = v·w).
// u1: x-face at x-node i of cell (j, k).
__device__ __forceinline__ CDS u1(const DsArgs& a, int i, int j, int k) {
  const CDS v = csub(cscale(csub(EZ(i, j + 1, k), EZ(i, j, k)), a.ihy[j]),
                     cscale(csub(EY(i, j, k + 1), EY(i, j, k)), a.ihz[k]));
  return cscale(v, a.wx[at(i, j, k, a.ny, a.nz)]);
}
// u2: y-face at y-node j of cell (i, k).
__device__ __forceinline__ CDS u2(const DsArgs& a, int i, int j, int k) {
  const CDS v = csub(cscale(csub(EX(i, j, k + 1), EX(i, j, k)), a.ihz[k]),
                     cscale(csub(EZ(i + 1, j, k), EZ(i, j, k)), a.ihx[i]));
  return cscale(v, a.wy[at(i, j, k, a.ny + 1, a.nz)]);
}
// u3: z-face at z-node k of cell (i, j).
__device__ __forceinline__ CDS u3(const DsArgs& a, int i, int j, int k) {
  const CDS v = csub(cscale(csub(EY(i + 1, j, k), EY(i, j, k)), a.ihx[i]),
                     cscale(csub(EX(i, j + 1, k), EX(i, j, k)), a.ihy[j]));
  return cscale(v, a.wz[at(i, j, k, a.ny, a.nz + 1)]);
}

// r = s − (½·rr − ¼·(st·e)) at an interior edge, folded to float32.
__device__ __forceinline__ float2 fold(float2 s, CDS rr, float2 st, CDS e) {
  const CDS ax = csub(cpow2(rr, 0.5f), cpow2(cmul_plain(e, st), 0.25f));
  const CDS r = csub(CDS{{s.x, 0.f}, {s.y, 0.f}}, ax);
  return make_float2(__fadd_rn(r.re.hi, r.re.lo), __fadd_rn(r.im.hi, r.im.lo));
}

__global__ void __launch_bounds__(256)
residual_ds(DsArgs a, int st_lanes) {
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int64_t nex = static_cast<int64_t>(nx) * (ny + 1) * (nz + 1);
  const int64_t ney = static_cast<int64_t>(nx + 1) * ny * (nz + 1);
  const int64_t nez = static_cast<int64_t>(nx + 1) * (ny + 1) * nz;
  {
    // The batch lane (grid y): its slices.
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
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < nex) {
    const int k = static_cast<int>(t % (nz + 1));
    const int64_t q = t / (nz + 1);
    const int j = static_cast<int>(q % (ny + 1));
    const int i = static_cast<int>(q / (ny + 1));
    if (j == 0 || j == ny || k == 0 || k == nz) {
      a.rx[t] = a.sx[t];
      return;
    }
    const CDS rr = csub(csub(cscale(u3(a, i, j, k), a.ihy[j]),
                             cscale(u3(a, i, j - 1, k), a.ihy[j - 1])),
                        csub(cscale(u2(a, i, j, k), a.ihz[k]),
                             cscale(u2(a, i, j, k - 1), a.ihz[k - 1])));
    a.rx[t] = fold(a.sx[t], rr, a.stx[at(i, j - 1, k - 1, ny - 1, nz - 1)],
                   EX(i, j, k));
    return;
  }
  t -= nex;
  if (t < ney) {
    const int k = static_cast<int>(t % (nz + 1));
    const int64_t q = t / (nz + 1);
    const int j = static_cast<int>(q % ny);
    const int i = static_cast<int>(q / ny);
    if (i == 0 || i == nx || k == 0 || k == nz) {
      a.ry[t] = a.sy[t];
      return;
    }
    const CDS rr = csub(csub(cscale(u1(a, i, j, k), a.ihz[k]),
                             cscale(u1(a, i, j, k - 1), a.ihz[k - 1])),
                        csub(cscale(u3(a, i, j, k), a.ihx[i]),
                             cscale(u3(a, i - 1, j, k), a.ihx[i - 1])));
    a.ry[t] = fold(a.sy[t], rr, a.sty[at(i - 1, j, k - 1, ny, nz - 1)],
                   EY(i, j, k));
    return;
  }
  t -= ney;
  if (t < nez) {
    const int k = static_cast<int>(t % nz);
    const int64_t q = t / nz;
    const int j = static_cast<int>(q % (ny + 1));
    const int i = static_cast<int>(q / (ny + 1));
    if (i == 0 || i == nx || j == 0 || j == ny) {
      a.rz[t] = a.sz[t];
      return;
    }
    const CDS rr = csub(csub(cscale(u2(a, i, j, k), a.ihx[i]),
                             cscale(u2(a, i - 1, j, k), a.ihx[i - 1])),
                        csub(cscale(u1(a, i, j, k), a.ihy[j]),
                             cscale(u1(a, i, j - 1, k), a.ihy[j - 1])));
    a.rz[t] = fold(a.sz[t], rr, a.stz[at(i - 1, j - 1, k, ny - 1, nz)],
                   EZ(i, j, k));
  }
}

#undef EX
#undef EY
#undef EZ

}  // namespace

// C interface, bound with ctypes by emg3d_tpu_torch/ops/dsres.py: K6 on
// complex64 tensors (float32 weights and widths) over ``lanes`` lanes,
// in blocks of ``threads`` (a multiple of 32, ≤ 256) covering every edge.
// ``lx``, ``ly``, ``lz`` may be null (a zero lo stream).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int emg3d_residual_ds_c64(
    void* rx, void* ry, void* rz, const void* hx, const void* hy,
    const void* hz, const void* lx, const void* ly, const void* lz,
    const void* sx, const void* sy, const void* sz, const void* stx,
    const void* sty, const void* stz, const void* wx, const void* wy,
    const void* wz, const void* ihx, const void* ihy, const void* ihz,
    int nx, int ny, int nz, int lanes, int st_lanes, int blocks,
    int threads, void* stream) {
  const int64_t edges =
      static_cast<int64_t>(nx) * (ny + 1) * (nz + 1) +
      static_cast<int64_t>(nx + 1) * ny * (nz + 1) +
      static_cast<int64_t>(nx + 1) * (ny + 1) * nz;
  if (nx < 1 || ny < 1 || nz < 1 || threads < 32 || threads > 256 ||
      threads % 32 != 0 || lanes < 1 || lanes > 65535 ||
      static_cast<int64_t>(blocks) * threads < edges ||
      (static_cast<int64_t>(blocks) - 1) * threads >= edges ||
      (lx == nullptr) != (ly == nullptr) ||
      (lx == nullptr) != (lz == nullptr)) {
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
  residual_ds<<<dim3(blocks, lanes), threads, 0, s>>>(a, st_lanes);
  return static_cast<int>(cudaGetLastError());
}
