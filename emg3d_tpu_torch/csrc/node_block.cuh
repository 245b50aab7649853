// The 6×6 block of A at one interior node, assembled in registers from
// the node's η edge sums, ζ face weights and inverse widths: the math
// of coeffs.node_coefficients and node_block_entries in the face-weight
// form of the JAX package's fused Pallas kernel (pallas_gs.py:345-371).
// Shared by the fused point kernel K2 (point_gs.cu), which factors the
// block, and the line-factor kernel K5 (line_gs.cu), which picks a line
// station's entries out of it.
//
// A node (i, j, k) (global node indices) has the block edges
// ex(i-1), ex(i), ey(j-1), ey(j), ez(k-1), ez(k) of its cell corner.
// Its field-independent inputs (NodeParams):
//   st[0..5]  the η edge sums at those six edges (stencil.eta_edge_sums):
//             stx(i-1|i, j-1, k-1), sty(i-1, j-1|j, k-1),
//             stz(i-1, j-1, k-1|k);
//   w[0..5]   its twelve ζ face weights in pairs (.x the face below,
//             .y the one above along the pair's axis):
//             w[0] = WZ(i-1, j-1|j, k)   w[1] = WZ(i, j-1|j, k)
//             w[2] = WY(i-1, j, k-1|k)   w[3] = WY(i, j, k-1|k)
//             w[4] = WX(i, j-1, k-1|k)   w[5] = WX(i, j, k-1|k)
// (point_gs.node_planes holds the same list for the packed layout.)
// These are also exactly the sums and weights that the residuals at the
// node's six edges read.
#pragma once

#include "stencil.cuh"

namespace emg3d {

template <class R>
struct NodeParams {
  cplx_t<R> st[6];
  cplx_t<R> w[6];
};

// The node's parameters from the level's tensors (widened from their
// storage where the η sums and ζ weights are stored in bfloat16).
template <class A>
__device__ __forceinline__ NodeParams<typename A::real> node_params(
    const A& a, int i, int j, int k) {
  NodeParams<typename A::real> p;
  p.st[0] = up(a.stx[at(i - 1, j - 1, k - 1, a.ny - 1, a.nz - 1)]);
  p.st[1] = up(a.stx[at(i, j - 1, k - 1, a.ny - 1, a.nz - 1)]);
  p.st[2] = up(a.sty[at(i - 1, j - 1, k - 1, a.ny, a.nz - 1)]);
  p.st[3] = up(a.sty[at(i - 1, j, k - 1, a.ny, a.nz - 1)]);
  p.st[4] = up(a.stz[at(i - 1, j - 1, k - 1, a.ny - 1, a.nz)]);
  p.st[5] = up(a.stz[at(i - 1, j - 1, k, a.ny - 1, a.nz)]);
  p.w[0] = cmake(WZ(i - 1, j - 1, k), WZ(i - 1, j, k));
  p.w[1] = cmake(WZ(i, j - 1, k), WZ(i, j, k));
  p.w[2] = cmake(WY(i - 1, j, k - 1), WY(i - 1, j, k));
  p.w[3] = cmake(WY(i, j, k - 1), WY(i, j, k));
  p.w[4] = cmake(WX(i, j - 1, k - 1), WX(i, j - 1, k));
  p.w[5] = cmake(WX(i, j, k - 1), WX(i, j, k));
  return p;
}

// The 24 ζ-average coefficients of the node (coeffs.NodeCoeffs names)
// and its six inverse widths.
template <class R>
struct NodeCoef {
  R mzyLxm, mzyRxm, myzLxm, myzRxm, mzyLxp, mzyRxp, myzLxp, myzRxp;
  R mzxLym, mzxRym, mxzLym, mxzRym, mzxLyp, mzxRyp, mxzLyp, mxzRyp;
  R myxLzm, myxRzm, mxyLzm, mxyRzm, myxLzp, myxRzp, mxyLzp, mxyRzp;
  R ihxm, ihxp, ihym, ihyp, ihzm, ihzp;
};

template <class R>
__device__ __forceinline__ NodeCoef<R> node_coef(const cplx_t<R> (&w)[6],
                                                 R ihxm, R ihxp, R ihym,
                                                 R ihyp, R ihzm, R ihzp) {
  const R half = R(0.5);
  const R kxm = half * ihxm, kxp = half * ihxp;
  const R kym = half * ihym, kyp = half * ihyp;
  const R kzm = half * ihzm, kzp = half * ihzp;
  NodeCoef<R> c;
  c.mzyLxm = kym * w[0].x;
  c.mzyRxm = kyp * w[0].y;
  c.myzLxm = kzm * w[2].x;
  c.myzRxm = kzp * w[2].y;
  c.mzyLxp = kym * w[1].x;
  c.mzyRxp = kyp * w[1].y;
  c.myzLxp = kzm * w[3].x;
  c.myzRxp = kzp * w[3].y;
  c.mzxLym = kxm * w[0].x;
  c.mzxRym = kxp * w[1].x;
  c.mxzLym = kzm * w[4].x;
  c.mxzRym = kzp * w[4].y;
  c.mzxLyp = kxm * w[0].y;
  c.mzxRyp = kxp * w[1].y;
  c.mxzLyp = kzm * w[5].x;
  c.mxzRyp = kzp * w[5].y;
  c.myxLzm = kxm * w[2].x;
  c.myxRzm = kxp * w[3].x;
  c.mxyLzm = kym * w[4].x;
  c.mxyRzm = kyp * w[5].x;
  c.myxLzp = kxm * w[2].y;
  c.myxRzp = kxp * w[3].y;
  c.mxyLzp = kym * w[4].y;
  c.mxyRzp = kyp * w[5].y;
  c.ihxm = ihxm;
  c.ihxp = ihxp;
  c.ihym = ihym;
  c.ihyp = ihyp;
  c.ihzm = ihzm;
  c.ihzp = ihzp;
  return c;
}

// The block's diagonal and its present strict-lower entries
// (coeffs.node_block_entries, same operation order); the structurally
// zero (1,0), (3,2) and (5,4), and the upper triangle, are not written.
template <class R>
__device__ __forceinline__ void node_block(const NodeCoef<R>& c,
                                           const cplx_t<R> (&st)[6],
                                           cplx_t<R> (&A)[6][6]) {
  const R quarter = R(0.25), zero = R(0);
  const R d[6] = {
      c.mzyRxm * c.ihyp + c.mzyLxm * c.ihym + c.myzRxm * c.ihzp + c.myzLxm * c.ihzm,
      c.mzyRxp * c.ihyp + c.mzyLxp * c.ihym + c.myzRxp * c.ihzp + c.myzLxp * c.ihzm,
      c.mzxRym * c.ihxp + c.mzxLym * c.ihxm + c.mxzRym * c.ihzp + c.mxzLym * c.ihzm,
      c.mzxRyp * c.ihxp + c.mzxLyp * c.ihxm + c.mxzRyp * c.ihzp + c.mxzLyp * c.ihzm,
      c.myxRzm * c.ihxp + c.myxLzm * c.ihxm + c.mxyRzm * c.ihyp + c.mxyLzm * c.ihym,
      c.myxRzp * c.ihxp + c.myxLzp * c.ihxm + c.mxyRzp * c.ihyp + c.mxyLzp * c.ihym};
#pragma unroll
  for (int n = 0; n < 6; ++n) {
    A[n][n] = cmake(d[n] - quarter * st[n].x, -(quarter * st[n].y));
  }
  A[2][0] = cmake(-c.mzyLxm * c.ihxm, zero);
  A[3][0] = cmake(c.mzyRxm * c.ihxm, zero);
  A[4][0] = cmake(-c.myzLxm * c.ihxm, zero);
  A[5][0] = cmake(c.myzRxm * c.ihxm, zero);
  A[2][1] = cmake(c.mzyLxp * c.ihxp, zero);
  A[3][1] = cmake(-c.mzyRxp * c.ihxp, zero);
  A[4][1] = cmake(c.myzLxp * c.ihxp, zero);
  A[5][1] = cmake(-c.myzRxp * c.ihxp, zero);
  A[4][2] = cmake(-c.mxzLym * c.ihym, zero);
  A[5][2] = cmake(c.mxzRym * c.ihym, zero);
  A[4][3] = cmake(c.mxzLyp * c.ihyp, zero);
  A[5][3] = cmake(-c.mxzRyp * c.ihyp, zero);
}

}  // namespace emg3d
