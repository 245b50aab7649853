// Line Gauss-Seidel colour step for Hopper (sm_90a), complex128.
//
// Replaces the two Pallas line-smoother kernels of the JAX package,
// emg3d_tpu/ops/pallas_lr.py, launched once each per colour step as the
// Pallas pair is (ops/line_gs.py runs them in the rotated frame whose
// x-lines are the lines being relaxed):
//
//   K3  line_residual <- _kernel_res (457-568): the curl-curl residual
//       r = s − A e of the whole level, one thread per edge, into a
//       residual buffer (the math of stencil.residual_parts; PEC edges
//       get r = s).  Pallas tiled x (and y) slabs and blended the owned
//       rows into an aliased (8,128)-padded stack; here every thread
//       owns its edge, so there is nothing to blend.
//   K4  line_thomas <- _kernel_thomas (591-790): one thread per line of
//       the colour runs the block-tridiagonal substitution along x,
//         forward   y_i = r_i − B_i z_{i-1},  z_i = C_i⁻¹ y_i,
//         backward  δ_{S-1} = z_{S-1},  δ_i = z_i − C_i⁻¹ B_{i+1}ᵀ δ_{i+1},
//       against the factor stack built once per (level, axis)
//       (smoothers.line_factor_stack: LDLᵀ of the eliminated station
//       blocks C_i and the sparse B_i), and adds δ into the line's
//       ex(i, j, k) and its adjacent ey(i+1, j-1|j, k), ez(i+1, j,
//       k-1|k) edges in place.  Station i's unknowns are those five
//       edges (smoothers.py:372-399 of the JAX package); the last
//       station has ex only.  z_i goes to a global scratch.
//
// Races: K4 reads only r (K3's buffer) and the factors, never e.  Lines
// of one colour share transverse parity, so they are two apart in y or
// z and touch disjoint edges: the in-place update is race-free and a
// colour step is deterministic.
//
// Layout: the factor stack is (nx, 23, 2, 2, ny2, nz2), with the lines
// of one transverse parity fastest-varying; consecutive threads of a
// colour take consecutive lines, so each factor load of a warp is one
// contiguous run.  The scratch z is (nx, 5, ny2·nz2), the same way.
// The residual and field accesses of a colour are stride 2 along z
// (half-used sectors); that is left for later work.
//
// Bound on this card: memory and latency.  K4 streams 23 complex128
// factors (368 B) per line-station twice (forward and backward), plus
// the scratch z; the arithmetic is ~600 FLOP per line-station.  A
// colour has only a quarter of the (ny-1)(nz-1) lines as threads (~1k
// at 64³, ~16k at 256³), each a sequential chain of nx stations, so at
// small levels the kernel is latency-bound.  wgmma and TMA do not apply
// (no matrix product; the recurrence is sequential along the line).
// The operation order is that of blocksolve.block_tridiag_solve_entries
// (and of the JAX package), so kernel and plain version agree to
// rounding.

#include "stencil.cuh"

using namespace emg3d;

namespace {

constexpr int kNent = 23;      // factor-stack planes per station
constexpr int kDinv = 10;      // first inverse-diagonal plane
constexpr int kB = 15;         // first B plane: (0,1) (0,2) (0,3) (0,4)
                               //   (1,1) (2,2) (3,3) (4,4)

struct ResArgs {
  double2* rx;          // residual out, same shapes as e
  double2* ry;
  double2* rz;
  const double2* ex;    // (nx, ny+1, nz+1)
  const double2* ey;    // (nx+1, ny, nz+1)
  const double2* ez;    // (nx+1, ny+1, nz)
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
  int nx, ny, nz;
};

__global__ void __launch_bounds__(256)
line_residual(ResArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int64_t n_x = static_cast<int64_t>(nx) * (ny + 1) * (nz + 1);
  const int64_t n_y = static_cast<int64_t>(nx + 1) * ny * (nz + 1);
  const int64_t n_z = static_cast<int64_t>(nx + 1) * (ny + 1) * nz;
  if (t < n_x) {
    const int k = static_cast<int>(t % (nz + 1));
    const int64_t q = t / (nz + 1);
    const int j = static_cast<int>(q % (ny + 1));
    const int i = static_cast<int>(q / (ny + 1));
    a.rx[t] = (j == 0 || j == ny || k == 0 || k == nz) ? a.sx[t]
                                                      : res_x(a, i, j, k);
  } else if (t < n_x + n_y) {
    const int64_t u = t - n_x;
    const int k = static_cast<int>(u % (nz + 1));
    const int64_t q = u / (nz + 1);
    const int j = static_cast<int>(q % ny);
    const int i = static_cast<int>(q / ny);
    a.ry[u] = (i == 0 || i == nx || k == 0 || k == nz) ? a.sy[u]
                                                      : res_y(a, i, j, k);
  } else if (t < n_x + n_y + n_z) {
    const int64_t u = t - n_x - n_y;
    const int k = static_cast<int>(u % nz);
    const int64_t q = u / nz;
    const int j = static_cast<int>(q % (ny + 1));
    const int i = static_cast<int>(q / (ny + 1));
    a.rz[u] = (i == 0 || i == nx || j == 0 || j == ny) ? a.sz[u]
                                                      : res_z(a, i, j, k);
  }
}

struct ThomasArgs {
  double2* ex;          // fields, updated in place
  double2* ey;
  double2* ez;
  const double2* rx;    // residual of the colour step (K3)
  const double2* ry;
  const double2* rz;
  const double2* fac;   // (nx, 23, 2, 2, ny2, nz2)
  double2* zs;          // scratch (nx, 5, ny2*nz2)
  int nx, ny, nz;
  int cy, cz;           // the colour's transverse parity
  int cny, cnz;         // active lines per transverse axis
};

#define RX(i, j, k) a.rx[at(i, j, k, a.ny + 1, a.nz + 1)]
#define RY(i, j, k) a.ry[at(i, j, k, a.ny, a.nz + 1)]
#define RZ(i, j, k) a.rz[at(i, j, k, a.ny + 1, a.nz)]

// Plane of L(i, k), i > k, in _lower_keys(5) order.
__host__ __device__ constexpr int l_plane(int i, int k) {
  return i * (i - 1) / 2 + k;
}

// y ← C⁻¹ y with the LDLᵀ factors of one station
// (blocksolve.ldl_solve_factored, all ten L entries, same order).
__device__ __forceinline__ void ldl_solve5(const double2* f, int64_t pstride,
                                           double2 (&y)[5]) {
  double2 L[5][5];
#pragma unroll
  for (int i = 1; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) L[i][k] = f[l_plane(i, k) * pstride];
  }
#pragma unroll
  for (int i = 1; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) y[i] = csub(y[i], cmul(L[i][k], y[k]));
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) y[i] = cmul(y[i], f[(kDinv + i) * pstride]);
#pragma unroll
  for (int i = 3; i >= 0; --i) {
#pragma unroll
    for (int k = i + 1; k < 5; ++k) y[i] = csub(y[i], cmul(L[k][i], y[k]));
  }
}

__global__ void __launch_bounds__(128)
line_thomas(ThomasArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(a.cny) * a.cnz) return;
  const int q = static_cast<int>(t / a.cnz);
  const int r = static_cast<int>(t % a.cnz);
  const int j = 1 + a.cy + 2 * q;          // the line's y- and z-node
  const int k = 1 + a.cz + 2 * r;
  const int nz2 = a.nz / 2;
  // Entry n of station i of this line: fac[(i*23 + n)*4*P + quarter*P
  // + line]; consecutive planes are 4*P apart.
  const int64_t P = static_cast<int64_t>(a.ny / 2) * nz2;
  const int64_t line = static_cast<int64_t>(q) * nz2 + r;
  const int64_t pstride = 4 * P;
  const double2* fq = a.fac + (a.cy * 2 + a.cz) * P + line;
  double2* zq = a.zs + line;
  const int nx = a.nx;

  // Forward: y_i = r_i − B_i z_{i-1} (no B term at station 0),
  // z_i = C_i⁻¹ y_i.
  double2 zp[5];
  for (int i = 0; i < nx; ++i) {
    const double2* f = fq + static_cast<int64_t>(i) * kNent * pstride;
    double2 y[5];
    y[0] = RX(i, j, k);
    if (i < nx - 1) {
      y[1] = RY(i + 1, j - 1, k);
      y[2] = RY(i + 1, j, k);
      y[3] = RZ(i + 1, j, k - 1);
      y[4] = RZ(i + 1, j, k);
    } else {
#pragma unroll
      for (int m = 1; m < 5; ++m) y[m] = make_double2(0.0, 0.0);
    }
    if (i > 0) {
#pragma unroll
      for (int m = 1; m < 5; ++m) {
        y[0] = csub(y[0], cmul(f[(kB + m - 1) * pstride], zp[m]));
      }
#pragma unroll
      for (int m = 1; m < 5; ++m) {
        y[m] = csub(y[m], cmul(f[(kB + 3 + m) * pstride], zp[m]));
      }
    }
    ldl_solve5(f, pstride, y);
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      zq[(static_cast<int64_t>(i) * 5 + m) * P] = y[m];
      zp[m] = y[m];
    }
  }

  // Backward: δ_{S-1} = z_{S-1}; δ_i = z_i − C_i⁻¹ (B_{i+1}ᵀ δ_{i+1}),
  // each δ_i added into the line's edges as soon as it is known.
  double2 dn[5];
  for (int i = nx - 1; i >= 0; --i) {
    double2 d[5];
    if (i == nx - 1) {
#pragma unroll
      for (int m = 0; m < 5; ++m) d[m] = zp[m];
    } else {
      const double2* f = fq + static_cast<int64_t>(i) * kNent * pstride;
      const double2* fn = f + kNent * pstride;   // station i+1
      // (Bᵀ)_{ak} = B_{ka}: row 0 of Bᵀ is zero.
      double2 u[5];
      u[0] = make_double2(0.0, 0.0);
#pragma unroll
      for (int m = 1; m < 5; ++m) {
        u[m] = cadd(cmul(fn[(kB + m - 1) * pstride], dn[0]),
                    cmul(fn[(kB + 3 + m) * pstride], dn[m]));
      }
      ldl_solve5(f, pstride, u);
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        d[m] = csub(zq[(static_cast<int64_t>(i) * 5 + m) * P], u[m]);
      }
    }
    EX(i, j, k) = cadd(EX(i, j, k), d[0]);
    if (i < nx - 1) {
      EY(i + 1, j - 1, k) = cadd(EY(i + 1, j - 1, k), d[1]);
      EY(i + 1, j, k) = cadd(EY(i + 1, j, k), d[2]);
      EZ(i + 1, j, k - 1) = cadd(EZ(i + 1, j, k - 1), d[3]);
      EZ(i + 1, j, k) = cadd(EZ(i + 1, j, k), d[4]);
    }
#pragma unroll
    for (int m = 0; m < 5; ++m) dn[m] = d[m];
  }
}

}  // namespace

// C interface, bound with ctypes by emg3d_tpu_torch/ops/line_gs.py.
// Each launches one kernel on ``stream`` and returns cudaGetLastError()
// (0 on success); ``blocks`` and ``threads`` come from the Python
// launch-geometry functions, which skip colours without lines.
extern "C" int emg3d_line_residual(
    void* rx, void* ry, void* rz, const void* ex, const void* ey,
    const void* ez, const void* sx, const void* sy, const void* sz,
    const void* stx, const void* sty, const void* stz, const void* wx,
    const void* wy, const void* wz, const void* ihx, const void* ihy,
    const void* ihz, int nx, int ny, int nz, int blocks, int threads,
    void* stream) {
  ResArgs a;
  a.rx = static_cast<double2*>(rx);
  a.ry = static_cast<double2*>(ry);
  a.rz = static_cast<double2*>(rz);
  a.ex = static_cast<const double2*>(ex);
  a.ey = static_cast<const double2*>(ey);
  a.ez = static_cast<const double2*>(ez);
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
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  line_residual<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int emg3d_line_thomas(
    void* ex, void* ey, void* ez, const void* rx, const void* ry,
    const void* rz, const void* fac, void* zs, int nx, int ny, int nz,
    int cy, int cz, int cny, int cnz, int blocks, int threads,
    void* stream) {
  ThomasArgs a;
  a.ex = static_cast<double2*>(ex);
  a.ey = static_cast<double2*>(ey);
  a.ez = static_cast<double2*>(ez);
  a.rx = static_cast<const double2*>(rx);
  a.ry = static_cast<const double2*>(ry);
  a.rz = static_cast<const double2*>(rz);
  a.fac = static_cast<const double2*>(fac);
  a.zs = static_cast<double2*>(zs);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.cy = cy;
  a.cz = cz;
  a.cny = cny;
  a.cnz = cnz;
  line_thomas<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
