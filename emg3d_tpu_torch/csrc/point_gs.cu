// Point Gauss-Seidel colour step for Hopper (sm_90a), complex128.
//
// Replaces the two Pallas point-smoother kernels of the JAX package,
// emg3d_tpu/ops/pallas_gs.py:
//
//   K1  point_gs_step<true>   ("factored") <- _kernel_resident (644-747),
//       the colour update against LDLᵀ factors built once per level
//       (pack_factors, 614-641): each step runs substitution only.
//   K2  point_gs_step<false>  ("fused")    <- _kernel (237-403), which
//       assembles each node's 6×6 block from the ζ face weights, η edge
//       sums and inverse widths (pallas_gs.py:345-371 = coeffs.py:47-152)
//       and factors and solves it in registers (blocksolve.py:32-85).
//
// One launch is one colour step; the smoother makes 8·nu launches per
// call (colours 0..7 on even sweeps, 7..0 on odd ones).  One thread
// owns one ACTIVE interior node (ix, iy, iz), i.e. one whose index
// parity equals the colour's.  It
//   1. evaluates the residual r = s − A e at its six block edges
//      (rb order: ex(ix-1), ex(ix), ey(iy-1), ey(iy), ez(iz-1), ez(iz));
//   2. solves the block system A_b δ = rb;
//   3. adds δ into those six edges IN PLACE.  This is the counterpart of
//      the Pallas kernels' input_output_aliases on the field stack.
//
// Races: the edges a thread reads for its residual are its own six
// block edges and edges that no other active node of the same colour
// writes (same-colour nodes are two apart along every axis in which
// they differ; a node's residual stencil reaches one edge beyond its
// own block in the transverse directions only).  So the thread-per-node
// update reproduces "residual of the whole field, then deposit" of the
// JAX math exactly, and a colour step is deterministic.
//
// Design difference to the Pallas kernels: they recompute the residual
// over the whole halo'd slab every colour step, though only one node in
// eight updates (the TPU's vector unit works on whole (8,128) tiles).
// Here only the active node's six edges are evaluated.
//
// Bound on this card: memory.  Per active node K1 loads 20 complex128
// factors (320 B) plus about 30 field, source and parameter values that
// are mostly shared with neighbouring threads through L1/L2; fp64
// arithmetic is ~200 FLOP per node, far below the H100's fp64 rate per
// byte.  wgmma and TMA do not apply (no matrix product, no regular
// tile).  Coalescing of the stride-2 colour pattern and the launch
// overhead of the many tiny coarse-level steps per F-cycle are the
// known costs; they are left for later work.
//
// The complex arithmetic and the residual at an edge are in
// stencil.cuh, shared with the line kernels (line_gs.cu).

#include "stencil.cuh"

using namespace emg3d;

namespace {

// Structure of the 6×6 node block (coeffs.node_block_entries): the
// strict lower entries present in A, and in L (A's plus the (3,2) and
// (5,4) fill-in of the factorization).
__host__ __device__ constexpr bool a_present(int i, int j) {
  return i == j || (i >= 2 && j <= 1) || (i >= 4 && (j == 2 || j == 3));
}
__host__ __device__ constexpr bool l_present(int i, int j) {
  return i > j && (a_present(i, j) || (i == 3 && j == 2) ||
                   (i == 5 && j == 4));
}
// Plane of L(i, j) in the factor stack: the order of _LKEYS in
// pallas_gs.py:566 and point_gs.LKEYS.
__host__ __device__ constexpr int l_plane(int i, int j) {
  return i == 2 ? j : i == 3 ? 2 + j : i == 4 ? 5 + j : 9 + j;
}
constexpr int kDinvPlane = 14;

struct Args {
  double2* ex;          // (nx, ny+1, nz+1), updated in place
  double2* ey;          // (nx+1, ny, nz+1)
  double2* ez;          // (nx+1, ny+1, nz)
  const double2* sx;    // source, same shapes as e
  const double2* sy;
  const double2* sz;
  const double2* stx;   // η edge sums (nx, ny-1, nz-1)
  const double2* sty;   // (nx-1, ny, nz-1)
  const double2* stz;   // (nx-1, ny-1, nz)
  const double* wx;     // ζ face weights (nx+1, ny, nz)
  const double* wy;     // (nx, ny+1, nz)
  const double* wz;     // (nx, ny, nz+1)
  const double* ihx;    // inverse widths (nx,), (ny,), (nz,)
  const double* ihy;
  const double* ihz;
  const double2* fac;   // K1: (20, nx-1, ny-1, nz-1); K2: unused
  int nx, ny, nz;
  int x0, y0, z0;       // first active node index per axis
  int cnx, cny, cnz;    // active nodes per axis
};

// K2: assemble the node block (coeffs.node_coefficients and
// node_block_entries, in the face-weight form of pallas_gs.py:345-371)
// and factor it (blocksolve.ldl_factor_sparse, same operation order).
__device__ void factor_block(const Args& a, int i, int j, int k,
                             double2 (&L)[6][6], double2 (&dinv)[6]) {
  const double ihxm = a.ihx[i - 1], ihxp = a.ihx[i];
  const double ihym = a.ihy[j - 1], ihyp = a.ihy[j];
  const double ihzm = a.ihz[k - 1], ihzp = a.ihz[k];
  const double kxm = 0.5 * ihxm, kxp = 0.5 * ihxp;
  const double kym = 0.5 * ihym, kyp = 0.5 * ihyp;
  const double kzm = 0.5 * ihzm, kzp = 0.5 * ihzp;

  const double mzyLxm = kym * WZ(i - 1, j - 1, k), mzyRxm = kyp * WZ(i - 1, j, k);
  const double myzLxm = kzm * WY(i - 1, j, k - 1), myzRxm = kzp * WY(i - 1, j, k);
  const double mzyLxp = kym * WZ(i, j - 1, k), mzyRxp = kyp * WZ(i, j, k);
  const double myzLxp = kzm * WY(i, j, k - 1), myzRxp = kzp * WY(i, j, k);
  const double mzxLym = kxm * WZ(i - 1, j - 1, k), mzxRym = kxp * WZ(i, j - 1, k);
  const double mxzLym = kzm * WX(i, j - 1, k - 1), mxzRym = kzp * WX(i, j - 1, k);
  const double mzxLyp = kxm * WZ(i - 1, j, k), mzxRyp = kxp * WZ(i, j, k);
  const double mxzLyp = kzm * WX(i, j, k - 1), mxzRyp = kzp * WX(i, j, k);
  const double myxLzm = kxm * WY(i - 1, j, k - 1), myxRzm = kxp * WY(i, j, k - 1);
  const double mxyLzm = kym * WX(i, j - 1, k - 1), mxyRzm = kyp * WX(i, j, k - 1);
  const double myxLzp = kxm * WY(i - 1, j, k), myxRzp = kxp * WY(i, j, k);
  const double mxyLzp = kym * WX(i, j - 1, k), mxyRzp = kyp * WX(i, j, k);

  const double2 st0 = a.stx[at(i - 1, j - 1, k - 1, a.ny - 1, a.nz - 1)];
  const double2 st1 = a.stx[at(i, j - 1, k - 1, a.ny - 1, a.nz - 1)];
  const double2 st2 = a.sty[at(i - 1, j - 1, k - 1, a.ny, a.nz - 1)];
  const double2 st3 = a.sty[at(i - 1, j, k - 1, a.ny, a.nz - 1)];
  const double2 st4 = a.stz[at(i - 1, j - 1, k - 1, a.ny - 1, a.nz)];
  const double2 st5 = a.stz[at(i - 1, j - 1, k, a.ny - 1, a.nz)];

  double2 A[6][6];
  const double d[6] = {
      mzyRxm * ihyp + mzyLxm * ihym + myzRxm * ihzp + myzLxm * ihzm,
      mzyRxp * ihyp + mzyLxp * ihym + myzRxp * ihzp + myzLxp * ihzm,
      mzxRym * ihxp + mzxLym * ihxm + mxzRym * ihzp + mxzLym * ihzm,
      mzxRyp * ihxp + mzxLyp * ihxm + mxzRyp * ihzp + mxzLyp * ihzm,
      myxRzm * ihxp + myxLzm * ihxm + mxyRzm * ihyp + mxyLzm * ihym,
      myxRzp * ihxp + myxLzp * ihxm + mxyRzp * ihyp + mxyLzp * ihym};
  const double2 st[6] = {st0, st1, st2, st3, st4, st5};
#pragma unroll
  for (int n = 0; n < 6; ++n) {
    A[n][n] = make_double2(d[n] - 0.25 * st[n].x, -(0.25 * st[n].y));
  }
  A[2][0] = make_double2(-mzyLxm * ihxm, 0.0);
  A[3][0] = make_double2(mzyRxm * ihxm, 0.0);
  A[4][0] = make_double2(-myzLxm * ihxm, 0.0);
  A[5][0] = make_double2(myzRxm * ihxm, 0.0);
  A[2][1] = make_double2(mzyLxp * ihxp, 0.0);
  A[3][1] = make_double2(-mzyRxp * ihxp, 0.0);
  A[4][1] = make_double2(myzLxp * ihxp, 0.0);
  A[5][1] = make_double2(-myzRxp * ihxp, 0.0);
  A[4][2] = make_double2(-mxzLym * ihym, 0.0);
  A[5][2] = make_double2(mxzRym * ihym, 0.0);
  A[4][3] = make_double2(mxzLyp * ihyp, 0.0);
  A[5][3] = make_double2(-mxzRyp * ihyp, 0.0);

  double2 D[6];  // D[k] = 1 / dinv[k], as blocksolve._d recomputes it
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    double2 acc = A[c][c];
#pragma unroll
    for (int m = 0; m < c; ++m) {
      if (l_present(c, m)) {
        acc = csub(acc, cmul(cmul(L[c][m], L[c][m]), D[m]));
      }
    }
    dinv[c] = crecip(acc);
    D[c] = crecip(dinv[c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (!l_present(r, c)) continue;
      bool has_s = false;
      double2 s = make_double2(0.0, 0.0);
#pragma unroll
      for (int m = 0; m < c; ++m) {
        if (l_present(r, m) && l_present(c, m)) {
          const double2 t = cmul(cmul(L[r][m], L[c][m]), D[m]);
          s = has_s ? cadd(s, t) : t;
          has_s = true;
        }
      }
      double2 val = a_present(r, c) ? A[r][c] : make_double2(0.0, 0.0);
      if (has_s) val = csub(val, s);
      L[r][c] = cmul(val, dinv[c]);
    }
  }
}

template <bool kFactored>
__global__ void __launch_bounds__(256)
point_gs_step(Args a) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t n_active = static_cast<int64_t>(a.cnx) * a.cny * a.cnz;
  if (tid >= n_active) return;
  const int c = static_cast<int>(tid % a.cnz);
  const int64_t t = tid / a.cnz;
  const int b = static_cast<int>(t % a.cny);
  const int q = static_cast<int>(t / a.cny);
  const int i = a.x0 + 2 * q;
  const int j = a.y0 + 2 * b;
  const int k = a.z0 + 2 * c;

  // 1. Residual at the six block edges, from the pre-step field.
  double2 y[6] = {res_x(a, i - 1, j, k), res_x(a, i, j, k),
                  res_y(a, i, j - 1, k), res_y(a, i, j, k),
                  res_z(a, i, j, k - 1), res_z(a, i, j, k)};

  // 2. LDLᵀ factors of the block: loaded (K1) or built here (K2).
  double2 L[6][6];
  double2 dinv[6];
  if constexpr (kFactored) {
    const int64_t plane = static_cast<int64_t>(a.nx - 1) * (a.ny - 1) *
                          (a.nz - 1);
    const int64_t node = at(i - 1, j - 1, k - 1, a.ny - 1, a.nz - 1);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int m = 0; m < r; ++m) {
        if (l_present(r, m)) L[r][m] = a.fac[l_plane(r, m) * plane + node];
      }
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) dinv[r] = a.fac[(kDinvPlane + r) * plane + node];
  } else {
    factor_block(a, i, j, k, L, dinv);
  }

  // Forward, diagonal and backward substitution
  // (blocksolve.ldl_solve_factored, same operation order).
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int m = 0; m < r; ++m) {
      if (l_present(r, m)) y[r] = csub(y[r], cmul(L[r][m], y[m]));
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) y[r] = cmul(y[r], dinv[r]);
#pragma unroll
  for (int r = 4; r >= 0; --r) {
#pragma unroll
    for (int m = r + 1; m < 6; ++m) {
      if (l_present(m, r)) y[r] = csub(y[r], cmul(L[m][r], y[m]));
    }
  }

  // 3. Deposit δ into the node's six edges (in place).
  EX(i - 1, j, k) = cadd(EX(i - 1, j, k), y[0]);
  EX(i, j, k) = cadd(EX(i, j, k), y[1]);
  EY(i, j - 1, k) = cadd(EY(i, j - 1, k), y[2]);
  EY(i, j, k) = cadd(EY(i, j, k), y[3]);
  EZ(i, j, k - 1) = cadd(EZ(i, j, k - 1), y[4]);
  EZ(i, j, k) = cadd(EZ(i, j, k), y[5]);
}

}  // namespace

// C interface, bound with ctypes by emg3d_tpu_torch/ops/point_gs.py.
// Launches one colour step on ``stream`` and returns cudaGetLastError()
// (0 on success).  ``blocks`` and ``threads`` come from the Python
// launch-geometry function; the caller skips colours without nodes.
extern "C" int emg3d_point_gs_step(
    int factored, void* ex, void* ey, void* ez, const void* sx,
    const void* sy, const void* sz, const void* stx, const void* sty,
    const void* stz, const void* wx, const void* wy, const void* wz,
    const void* ihx, const void* ihy, const void* ihz, const void* fac,
    int nx, int ny, int nz, int x0, int y0, int z0, int cnx, int cny,
    int cnz, int blocks, int threads, void* stream) {
  Args a;
  a.ex = static_cast<double2*>(ex);
  a.ey = static_cast<double2*>(ey);
  a.ez = static_cast<double2*>(ez);
  a.sx = static_cast<const double2*>(sx);
  a.sy = static_cast<const double2*>(sy);
  a.sz = static_cast<const double2*>(sz);
  a.stx = static_cast<const double2*>(stx);
  a.sty = static_cast<const double2*>(sty);
  a.stz = static_cast<const double2*>(stz);
  a.wx = static_cast<const double*>(wx);
  a.wy = static_cast<const double*>(wy);
  a.wz = static_cast<const double*>(wz);
  a.ihx = static_cast<const double*>(ihx);
  a.ihy = static_cast<const double*>(ihy);
  a.ihz = static_cast<const double*>(ihz);
  a.fac = static_cast<const double2*>(fac);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.x0 = x0;
  a.y0 = y0;
  a.z0 = z0;
  a.cnx = cnx;
  a.cny = cny;
  a.cnz = cnz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (factored) {
    point_gs_step<true><<<blocks, threads, 0, s>>>(a);
  } else {
    point_gs_step<false><<<blocks, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
