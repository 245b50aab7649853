// Complex helpers and the curl-curl residual at one edge, shared by the
// point (point_gs.cu) and line (line_gs.cu) kernels, for both scalar
// types of a solve: complex128 (double2 with double weights) and
// complex64 (float2 with float weights).
//
// The residual functions take any argument struct ``a`` with a member
// type ``real`` (double or float) and the members ex, ey, ez (edge
// fields), sx, sy, sz (source), stx, sty, stz (η edge sums,
// stencil.eta_edge_sums), wx, wy, wz (ζ face weights,
// stencil.zeta_face_weights), ihx, ihy, ihz (inverse widths) and the
// level's cell shape nx, ny, nz.  All tensors are C-ordered, unpadded.
//
// A complex64 solve may store s, the η sums and the ζ weights in
// bfloat16 (the JAX package's pack_params(pdtype=), pack_fields(sdtype=),
// pallas_gs.py:433-484): an argument struct then declares those members
// of the storage types of Store<float, __nv_bfloat16>, and every read
// below goes through up(), which widens a stored value exactly to the
// compute type (and is the identity for float and double), as the JAX
// kernels' _up does (pallas_gs.py:312-322).  The arithmetic after the
// load is the same in every instance.
//
// Complex products are complex-SYMMETRIC (no conjugation anywhere), as
// in blocksolve.py.  The complex reciprocal follows the scaled (Smith)
// division that PyTorch uses, in IEEE division (no fast-math flag), so
// the kernels and the plain torch versions agree to rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace emg3d {

// The complex type of a real type: double2 for double, float2 for float.
template <class R>
struct Cplx;
template <>
struct Cplx<double> {
  using type = double2;
};
template <>
struct Cplx<float> {
  using type = float2;
};
template <class R>
using cplx_t = typename Cplx<R>::type;
// The complex type of an argument struct (its ``real`` member type).
template <class A>
using cplx_of = cplx_t<typename A::real>;

// The stored types of a stream computed in R and stored in S: R's own
// (S = R), or bfloat16 for float (a complex value as one
// __nv_bfloat162, .x the real part, .y the imaginary part: the layout of
// a torch bfloat16 tensor with a trailing (re, im) axis).
template <class R, class S>
struct Store {
  static_assert(sizeof(S) == sizeof(R), "S = R, or Store's specialisation");
  using cplx = cplx_t<R>;
  using real = R;
};
template <>
struct Store<float, __nv_bfloat16> {
  using cplx = __nv_bfloat162;
  using real = __nv_bfloat16;
};

// A stored value in its compute type, exactly.
__device__ __forceinline__ double up(double v) { return v; }
__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ float up(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double2 up(double2 v) { return v; }
__device__ __forceinline__ float2 up(float2 v) { return v; }
__device__ __forceinline__ float2 up(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
// Store a computed value: as it is, or rounded to the nearest bfloat16
// (ties to even, as torch's Tensor.to and JAX's astype round).
__device__ __forceinline__ void put(double2* p, double2 v) { *p = v; }
__device__ __forceinline__ void put(float2* p, float2 v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat162* p, float2 v) {
  *p = __float22bfloat162_rn(v);
}

__device__ __forceinline__ double2 cmake(double re, double im) {
  return make_double2(re, im);
}
__device__ __forceinline__ float2 cmake(float re, float im) {
  return make_float2(re, im);
}

template <class C>
__device__ __forceinline__ C cadd(C a, C b) {
  return cmake(a.x + b.x, a.y + b.y);
}
template <class C>
__device__ __forceinline__ C csub(C a, C b) {
  return cmake(a.x - b.x, a.y - b.y);
}
// Complex product without conjugation.
template <class C>
__device__ __forceinline__ C cmul(C a, C b) {
  return cmake(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// Complex times real; a literal factor (0.5, 0.25) is taken in the
// complex type's precision, as the plain version takes a Python float.
template <class C>
__device__ __forceinline__ C cscale(C a, decltype(a.x) s) {
  return cmake(a.x * s, a.y * s);
}
__device__ __forceinline__ double rabs(double v) { return fabs(v); }
__device__ __forceinline__ float rabs(float v) { return fabsf(v); }
// 1 / (c + d i) by the scaled division of c10::complex.
template <class C>
__device__ __forceinline__ C crecip(C z) {
  using R = decltype(z.x);
  const R c = z.x, d = z.y;
  if (rabs(c) >= rabs(d)) {
    const R rat = d / c;
    const R scl = R(1) / (c + d * rat);
    return cmake(scl, -rat * scl);
  }
  const R rat = c / d;
  const R scl = R(1) / (d + c * rat);
  return cmake(rat * scl, -scl);
}

__device__ __forceinline__ int64_t at(int i, int j, int k, int n1, int n2) {
  return (static_cast<int64_t>(i) * n1 + j) * n2 + k;
}

// Field, source and parameter accessors in global edge/face indices.
#define EX(i, j, k) a.ex[emg3d::at(i, j, k, a.ny + 1, a.nz + 1)]
#define EY(i, j, k) a.ey[emg3d::at(i, j, k, a.ny, a.nz + 1)]
#define EZ(i, j, k) a.ez[emg3d::at(i, j, k, a.ny + 1, a.nz)]
#define WX(i, j, k) emg3d::up(a.wx[emg3d::at(i, j, k, a.ny, a.nz)])
#define WY(i, j, k) emg3d::up(a.wy[emg3d::at(i, j, k, a.ny + 1, a.nz)])
#define WZ(i, j, k) emg3d::up(a.wz[emg3d::at(i, j, k, a.ny, a.nz + 1)])

// The edge field e enters the residual through an accessor ``f`` with
// members x(i, j, k), y(i, j, k), z(i, j, k) in global edge indices:
// GlobalE reads the level's tensors (K1, K2), the residual kernel K3
// reads a slab staged in shared memory (line_gs.cu).  The operation
// order is the same whatever the accessor, so the results are too.
template <class A>
struct GlobalE {
  const A& a;
  __device__ __forceinline__ cplx_of<A> x(int i, int j, int k) const {
    return EX(i, j, k);
  }
  __device__ __forceinline__ cplx_of<A> y(int i, int j, int k) const {
    return EY(i, j, k);
  }
  __device__ __forceinline__ cplx_of<A> z(int i, int j, int k) const {
    return EZ(i, j, k);
  }
};

// ζ-weighted curls on faces (stencil.curl_factors), the face weight
// ``w`` given.
// u1: x-face at x-node i of cell (j, k).
template <class A, class F>
__device__ __forceinline__ cplx_of<A> u1(const A& a, const F& f, int i, int j,
                                         int k, typename A::real w) {
  const cplx_of<A> v =
      csub(cscale(csub(f.z(i, j + 1, k), f.z(i, j, k)), a.ihy[j]),
           cscale(csub(f.y(i, j, k + 1), f.y(i, j, k)), a.ihz[k]));
  return cscale(v, w);
}
// u2: y-face at y-node j of cell (i, k).
template <class A, class F>
__device__ __forceinline__ cplx_of<A> u2(const A& a, const F& f, int i, int j,
                                         int k, typename A::real w) {
  const cplx_of<A> v =
      csub(cscale(csub(f.x(i, j, k + 1), f.x(i, j, k)), a.ihz[k]),
           cscale(csub(f.z(i + 1, j, k), f.z(i, j, k)), a.ihx[i]));
  return cscale(v, w);
}
// u3: z-face at z-node k of cell (i, j).
template <class A, class F>
__device__ __forceinline__ cplx_of<A> u3(const A& a, const F& f, int i, int j,
                                         int k, typename A::real w) {
  const cplx_of<A> v =
      csub(cscale(csub(f.y(i + 1, j, k), f.y(i, j, k)), a.ihx[i]),
           cscale(csub(f.x(i, j + 1, k), f.x(i, j, k)), a.ihy[j]));
  return cscale(v, w);
}

// Residual r = s − A e at one interior edge (stencil.amat_interior):
// A e = ½·(second curl) − ¼·(η edge sum)·e, with the edge's η sum ``st``
// and the four face weights of its curls given (p: the face at the
// edge's own index, m: the one below it).  Point kernel K2 passes them
// from its node's packed data; the overloads below read them from the
// level's tensors.  The operation order is the same either way.
template <class A, class F>
__device__ cplx_of<A> res_x(const A& a, const F& f, int i, int j, int k,
                            cplx_of<A> st, typename A::real w3p,
                            typename A::real w3m, typename A::real w2p,
                            typename A::real w2m) {
  const cplx_of<A> rr = csub(
      csub(cscale(u3(a, f, i, j, k, w3p), a.ihy[j]),
           cscale(u3(a, f, i, j - 1, k, w3m), a.ihy[j - 1])),
      csub(cscale(u2(a, f, i, j, k, w2p), a.ihz[k]),
           cscale(u2(a, f, i, j, k - 1, w2m), a.ihz[k - 1])));
  const cplx_of<A> ax =
      csub(cscale(rr, 0.5), cmul(cscale(st, 0.25), f.x(i, j, k)));
  return csub(up(a.sx[at(i, j, k, a.ny + 1, a.nz + 1)]), ax);
}
template <class A, class F>
__device__ cplx_of<A> res_y(const A& a, const F& f, int i, int j, int k,
                            cplx_of<A> st, typename A::real w1p,
                            typename A::real w1m, typename A::real w3p,
                            typename A::real w3m) {
  const cplx_of<A> rr = csub(
      csub(cscale(u1(a, f, i, j, k, w1p), a.ihz[k]),
           cscale(u1(a, f, i, j, k - 1, w1m), a.ihz[k - 1])),
      csub(cscale(u3(a, f, i, j, k, w3p), a.ihx[i]),
           cscale(u3(a, f, i - 1, j, k, w3m), a.ihx[i - 1])));
  const cplx_of<A> ay =
      csub(cscale(rr, 0.5), cmul(cscale(st, 0.25), f.y(i, j, k)));
  return csub(up(a.sy[at(i, j, k, a.ny, a.nz + 1)]), ay);
}
template <class A, class F>
__device__ cplx_of<A> res_z(const A& a, const F& f, int i, int j, int k,
                            cplx_of<A> st, typename A::real w2p,
                            typename A::real w2m, typename A::real w1p,
                            typename A::real w1m) {
  const cplx_of<A> rr = csub(
      csub(cscale(u2(a, f, i, j, k, w2p), a.ihx[i]),
           cscale(u2(a, f, i - 1, j, k, w2m), a.ihx[i - 1])),
      csub(cscale(u1(a, f, i, j, k, w1p), a.ihy[j]),
           cscale(u1(a, f, i, j - 1, k, w1m), a.ihy[j - 1])));
  const cplx_of<A> az =
      csub(cscale(rr, 0.5), cmul(cscale(st, 0.25), f.z(i, j, k)));
  return csub(up(a.sz[at(i, j, k, a.ny + 1, a.nz)]), az);
}

// The same with η sum and face weights read from the level's tensors.
template <class A, class F>
__device__ cplx_of<A> res_x(const A& a, const F& f, int i, int j, int k) {
  return res_x(a, f, i, j, k,
               up(a.stx[at(i, j - 1, k - 1, a.ny - 1, a.nz - 1)]),
               WZ(i, j, k), WZ(i, j - 1, k), WY(i, j, k), WY(i, j, k - 1));
}
template <class A, class F>
__device__ cplx_of<A> res_y(const A& a, const F& f, int i, int j, int k) {
  return res_y(a, f, i, j, k,
               up(a.sty[at(i - 1, j, k - 1, a.ny, a.nz - 1)]),
               WX(i, j, k), WX(i, j, k - 1), WZ(i, j, k), WZ(i - 1, j, k));
}
template <class A, class F>
__device__ cplx_of<A> res_z(const A& a, const F& f, int i, int j, int k) {
  return res_z(a, f, i, j, k,
               up(a.stz[at(i - 1, j - 1, k, a.ny - 1, a.nz)]),
               WY(i, j, k), WY(i - 1, j, k), WX(i, j, k), WX(i, j - 1, k));
}

// The same at an edge of the level's own tensors.
template <class A>
__device__ cplx_of<A> res_x(const A& a, int i, int j, int k) {
  return res_x(a, GlobalE<A>{a}, i, j, k);
}
template <class A>
__device__ cplx_of<A> res_y(const A& a, int i, int j, int k) {
  return res_y(a, GlobalE<A>{a}, i, j, k);
}
template <class A>
__device__ cplx_of<A> res_z(const A& a, int i, int j, int k) {
  return res_z(a, GlobalE<A>{a}, i, j, k);
}

}  // namespace emg3d
