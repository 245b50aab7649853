// Line Gauss-Seidel for Hopper (sm_90a), in the two scalar types of a
// solve: complex128 and complex64 (every kernel templated on its real
// type R; each C entry point has a ``_c64`` twin for the float
// instance, the precision the Pallas kernels compute in,
// pallas_lr.py:40).  The launch plans are the complex128 ones, every byte
// count taken at the element size: a complex64 element is 8 bytes, so
// the staging copies are cp.async of 8 bytes (a complex64 plane at an
// odd element offset is not 16-byte aligned).
//
// Replaces the two Pallas line-smoother kernels of the JAX package,
// emg3d_tpu/ops/pallas_lr.py, launched once each per colour step as the
// Pallas pair is, and the lax.scan that builds their factor stack
// (ops/line_gs.py runs them in the rotated frame whose x-lines are the
// lines being relaxed):
//
//   K3  line_residual <- _kernel_res (457-568): the curl-curl residual
//       r = s − A e (the math of stencil.residual_parts) at exactly the
//       edges K4 of the colour reads, into a residual buffer: rx on the
//       colour's lines, ry(1..nx-1, j-1|j, k), rz(1..nx-1, j, k-1|k)
//       (line_gs.colour_edges; ~5/12 of the level's edges).  None of
//       them lies on the PEC boundary, so r = s never arises.  Pallas
//       computed the whole level and blended the owned rows into an
//       aliased (8,128)-padded stack; a residual of every edge, one
//       thread per edge, would be 7/12 overwritten before any read.
//   K4  line_thomas <- _kernel_thomas (591-790): the block-tridiagonal
//       substitution of every line of the colour along x,
//         forward   y_i = r_i − B_i z_{i-1},  z_i = C_i⁻¹ y_i,
//         backward  δ_{S-1} = z_{S-1},  δ_i = z_i − C_i⁻¹ B_{i+1}ᵀ δ_{i+1},
//       against the factor stack (K5), adding δ into the line's
//       ex(i, j, k) and its adjacent ey(i+1, j-1|j, k), ez(i+1, j,
//       k-1|k) edges in place.  Station i's unknowns are those five
//       edges (smoothers.py:372-399 of the JAX package); the last
//       station has ex only.
//   K5  line_factor <- pallas_lr.line_factors (356-450) whole: the
//       station entries of every line (smoothers._line_entries_x_parity
//       of the JAX package) and the block-Thomas elimination it runs as
//       one lax.scan (emg3d_tpu/ops/blocksolve.py:305): per line,
//       C_0 = D_0 and C_i = D_i − B_i C_{i-1}⁻¹ B_iᵀ, and the sparse LDLᵀ
//       of every C_i.  Each station's D and B are assembled in registers
//       from the rotated frame's η sums, ζ weights and inverse widths
//       (node_block.cuh, the code of the fused point kernel K2): station
//       i's D is node (i+1)'s block restricted to ex(i) and its four
//       transverse edges, its B row 0 node i's ex(i)-row, its B diagonal
//       node (i+1)'s x-couplings of the transverse edges
//       (smoothers.pack_line_entries, the plain version, picks the same
//       entries out of whole-level tensors).
//
// Layout: the factor stack is (nx, 23, 2, 2, ny2, nz2), with the lines
// of one transverse parity fastest-varying: planes 0-9 L (_lower_keys(5)
// order), 10-14 the inverse diagonal, 15-22 B (LINE_BKEYS order).
// Consecutive threads (K5) or lanes (K4) take consecutive lines, so each
// plane load of a warp is one contiguous run.
//
// Bounds on this card (3.35 TB/s, 34 TFLOP/s fp64 outside the tensor
// cores), each input byte read once and each output written once, in
// complex128 (complex64: half the bytes, fp32 at 67 TFLOP/s):
//   K5  st, w and ih read once (~72 B per line-station) and the 23
//       planes written once (368 B); ~1.5 kFLOP per station: memory-
//       bound at 256³, a latency chain per line below.  The first design
//       read 21 packed entry planes and wrote 15 (576 B) and waited on
//       ~2 ms of host work per stack that built those entries with torch
//       ops.  One thread per line over all four parities (4·ny2·nz2),
//       stations in a loop, C_{i-1}'s 15 factors in registers, the next
//       node's inputs loaded one station ahead, blocks of one warp so
//       that few lines still spread over the SMs.  Below 256³ a line is
//       a latency chain (the LDLᵀ's ten complex reciprocals per station
//       in sequence), not bytes.  Splitting a station's five column
//       solves over eight lanes per line (shuffles between them, every
//       lane running the LDLᵀ) was timed on the card and read slower at
//       every shape: it shortens the solves, not the LDLᵀ chain.
//   K4  23 factors, 5 residuals and 5 field reads and writes per
//       line-station (608 B): memory-bound, 11.9 µs per colour at 64³,
//       0.76 ms at 256³.  What held the first design back was not the
//       bytes but latency: one thread per line on 128-thread blocks
//       left the card almost empty at 64³ (8 blocks for 132 SMs), and
//       every station waited on its 23 factor loads.  Now a block is one
//       warp that owns LPB lines (a power of two ≤ 32, a template
//       parameter chosen in Python: 4 at 64³, so a colour spreads over
//       256 blocks; 32 at 256³, where the kernel is bound by bandwidth
//       and a warp's plane runs are 512 B).  All 32 lanes fill a ring of
//       kStages station slots in shared memory with cp.async, kAhead
//       stations ahead of the lanes that compute (lane l < lines per
//       block runs line l); a slot holds the station's 23 factor planes
//       and its 5 residuals (forward) or 5 field values and, where z is
//       not on chip, 5 z values (backward).  z stays in shared memory
//       where it fits (Python decides: 5 KB per line at 64³; timed on the
//       card, z on chip saves ~10 % at 4-16 lines per block of 32-128
//       stations, and costs where its bytes cut the blocks per SM), else
//       it goes to a global scratch.  The station arithmetic is not
//       split across lanes: in the operation order kept here the backward
//       LDLᵀ substitution is a chain of ten dependent steps, and a
//       shuffle per step would lengthen it.
//   K3  a block owns a slab of the rotated level: R line rows × ZL lines
//       along z × XC stations along x.  It walks the slab's x planes
//       with a ring of four plane slots in shared memory, each holding
//       the slab's e (ex, ey, ez) with its one-edge halo in y and z,
//       filled by cp.async one plane ahead of the compute; the colour's
//       edges of plane i are computed from the slots of planes i-1..i+1
//       (the residual code of stencil.cuh through a shared-memory
//       accessor).  So each e value comes from DRAM once per block
//       (amplified only by the halos: (2R+1)/2R in y, (2ZL+1)/2ZL in z,
//       (XC+1)/XC in x), not once per neighbouring edge through L1; s,
//       η sums and ζ weights are read only at the colour's edges.
//       Bound: memory (e read once, s read and r written at the colour
//       edges, η sums and ζ weights read where they are needed).  On
//       levels too small for slabs of several stations to fill the card
//       (a run of one or two stations per block; Python's rule, timed),
//       line_residual<false> reads e directly through L1/L2 instead: the
//       ring's fill and barriers cost more latency there than the
//       re-reads they save.
// Lanes.  K3 and K4 take the B lanes of a batched solve (its sources and
// frequencies) in one launch: the lane is the grid's y index.  A lane's
// e, s, residual and z scratch are the lane's slices of (B, ...) tensors;
// its η sums and factor stack are those of the lane's frequency group,
// slices of (G, ...) tensors picked by a lane → group table (int32, B
// entries); ζ weights and widths are shared by all lanes.  A one-lane
// launch (no table) is lane 0 of group 0: the arithmetic of a lane is
// the same whatever B, only its addresses move.
//
// The residual and field accesses of a colour are stride 2 along z
// (half-used sectors).  wgmma and TMA tiles do not apply (no matrix
// product; the recurrences are sequential along the line).  The
// operation orders are those of blocksolve.block_tridiag_factor_entries,
// ldl_factor_sparse and block_tridiag_solve_entries (and of the JAX
// package), so kernels and plain versions agree to rounding.
//
// bfloat16 storage (the ``_bf16`` entry points, complex64 only), as the
// JAX package's Pallas path stores: K3 reads s, the η sums and the ζ
// weights stored in bfloat16 (pack_params(pdtype=), pack_fields(sdtype=);
// _kernel_res upcasts them, pallas_lr.py:539-545); K5 eliminates in
// float32 and rounds each factor to bfloat16 when it writes it
// (line_factors(fdtype=), pallas_lr.py:356-402); K4 reads that stack
// (_kernel_thomas's F, :657-667), each complex factor one 4-byte
// __nv_bfloat162 instead of 8 bytes.  Every load widens exactly
// (stencil.cuh: up) and the arithmetic stays float32.  K4's ring slot
// then holds the 23 factor planes at 4 B an entry, padded to 8 B, before
// its residual, field and z planes at 8 B (slot_bytes; line_gs._slot_bytes
// in Python): each cp.async is 4 or 8 bytes, aligned to its size.
//
// Segments.  K4 and K5 take ``stations`` ≤ nx: the first ``stations``
// stations of every line.  A line cut after station S − 1 < nx − 1 has
// no PEC end: its last station is a full one (its five unknowns, node
// S's block), which the elimination and the substitution reach as any
// other station, and nothing beyond it is read or written.  Together
// with a level that starts where the segment starts (its first station
// then has no coupling below), that is the interior segment of a line
// split over ranks (parallel/lines.py: the Schur-complement smoother);
// stations == nx is the whole line, as before.
//
// Races: K4 reads only r (K3's buffer), the factors and the e values of
// its own lines.  Lines of one colour share transverse parity, so they
// are two apart in y or z and touch disjoint edges: the in-place update
// is race-free and a colour step is deterministic.  K5 writes only its
// own line's planes.

#include "node_block.cuh"
#include "stencil.cuh"

using namespace emg3d;

namespace {

constexpr int kNent = 23;      // factor-stack planes per station
constexpr int kDinv = 10;      // first inverse-diagonal plane
constexpr int kB = 15;         // first B plane: (0,1) (0,2) (0,3) (0,4)
                               //   (1,1) (2,2) (3,3) (4,4)
constexpr int kWarp = 32;      // K4: one warp per block
constexpr int kStages = 6;     // K4's ring of station slots
constexpr int kAhead = kStages - 2;   // stations loaded ahead

// R: the compute (real) type; S: the storage of s, η sums and ζ weights.
template <class R, class S = R>
struct ResArgs {
  using real = R;
  using C = cplx_t<R>;
  using SC = typename Store<R, S>::cplx;
  using SR = typename Store<R, S>::real;
  C* rx;          // residual out, same shapes as e
  C* ry;
  C* rz;
  const C* ex;    // (nx, ny+1, nz+1)
  const C* ey;    // (nx+1, ny, nz+1)
  const C* ez;    // (nx+1, ny+1, nz)
  const SC* sx;   // source, same shapes as e
  const SC* sy;
  const SC* sz;
  const SC* stx;  // η edge sums (nx, ny-1, nz-1)
  const SC* sty;  // (nx-1, ny, nz-1)
  const SC* stz;  // (nx-1, ny-1, nz)
  const SR* wx;    // ζ face weights (nx+1, ny, nz)
  const SR* wy;    // (nx, ny+1, nz)
  const SR* wz;    // (nx, ny, nz+1)
  const R* ihx;    // inverse widths (nx,), (ny,), (nz,)
  const R* ihy;
  const R* ihz;
  const int* group;     // lane → frequency group (B entries), or null
  int nx, ny, nz;
  int cy, cz;           // the colour's transverse parity
  int cny, cnz;         // its lines per transverse axis
  int rows, lines;      // R line rows and ZL lines per block
  int xplanes;          // XC stations per block
};

// Point ``a`` at lane ``lane``: e, s and r at the lane's slices, the η
// sums at its group's.
template <class R, class S>
__device__ __forceinline__ void lane_offsets(ResArgs<R, S>& a, int lane) {
  const int64_t g = a.group ? a.group[lane] : 0;
  const int64_t nx = a.nx, ny = a.ny, nz = a.nz;
  const int64_t ex = nx * (ny + 1) * (nz + 1), ey = (nx + 1) * ny * (nz + 1),
                ez = (nx + 1) * (ny + 1) * nz;
  a.rx += lane * ex;
  a.ex += lane * ex;
  a.sx += lane * ex;
  a.ry += lane * ey;
  a.ey += lane * ey;
  a.sy += lane * ey;
  a.rz += lane * ez;
  a.ez += lane * ez;
  a.sz += lane * ez;
  a.stx += g * nx * (ny - 1) * (nz - 1);
  a.sty += g * (nx - 1) * ny * (nz - 1);
  a.stz += g * (nx - 1) * (ny - 1) * nz;
}

constexpr int kResSlots = 4;   // K3's ring of x-plane slots

// A slab's e in the ring: plane i in slot i % 4; per slot ex
// (2R+1)×(2ZL+1), ey 2R×(2ZL+1), ez (2R+1)×2ZL values, y-major, in
// global edge indices offset by (Y0, Z0).
template <class C>
struct SlabE {
  const C* s;
  int slot, nex, ney;   // slot size; ex and ey tile sizes
  int y0, z0;
  int zx, zz;           // z extents: 2ZL+1 (ex, ey), 2ZL (ez)
  __device__ __forceinline__ const C* plane(int i) const {
    return s + (i & (kResSlots - 1)) * slot;
  }
  __device__ __forceinline__ C x(int i, int j, int k) const {
    return plane(i)[(j - y0) * zx + (k - z0)];
  }
  __device__ __forceinline__ C y(int i, int j, int k) const {
    return plane(i)[nex + (j - y0) * zx + (k - z0)];
  }
  __device__ __forceinline__ C z(int i, int j, int k) const {
    return plane(i)[nex + ney + (j - y0) * zz + (k - z0)];
  }
};

// One element from global into shared memory: a complex128 element
// (16 B) bypassing L1, a complex64 one (8 B, at any element offset, so
// not always 16-byte aligned) and a bfloat16 complex (4 B) through
// cp.async.ca.
template <class C>
__device__ __forceinline__ void cp_async(C* smem, const C* gmem) {
  static_assert(sizeof(C) == 16 || sizeof(C) == 8 || sizeof(C) == 4,
                "complex elements");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(C) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else if constexpr (sizeof(C) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Copy a (ny_t × nz_t) tile of plane p of a field with row lengths
// (n1, n2) at (y0, z0) into ``dst`` (row length ``zs``).
template <class C>
__device__ __forceinline__ void load_tile(C* dst, const C* src,
                                          int p, int y0, int z0, int ny_t,
                                          int nz_t, int zs, int n1, int n2) {
  const int total = ny_t * nz_t;
  for (int n = threadIdx.x; n < total; n += blockDim.x) {
    const int yy = n / nz_t, zz = n - yy * nz_t;
    cp_async(dst + yy * zs + zz, src + at(p, y0 + yy, z0 + zz, n1, n2));
  }
}

// (T: the real type; R is the slab's line rows below; S the storage of
// s, η sums and ζ weights.)
template <bool kStaged, class T, class S>
__global__ void __launch_bounds__(256)
line_residual(ResArgs<T, S> a) {
  using C = cplx_t<T>;
  // Raw bytes: the float and double instances share the symbol.
  extern __shared__ __align__(16) unsigned char res_smem[];
  C* ring = reinterpret_cast<C*>(res_smem);
  lane_offsets(a, blockIdx.y);
  const int R = a.rows, ZL = a.lines;
  const int ngz = (a.cnz + ZL - 1) / ZL, ngy = (a.cny + R - 1) / R;
  int b = blockIdx.x;
  const int gz = b % ngz;
  b /= ngz;
  const int gy = b % ngy;
  const int gx = b / ngy;
  const int q0 = gy * R, r0 = gz * ZL;
  const int nrows = min(R, a.cny - q0), nl = min(ZL, a.cnz - r0);
  const int xa = gx * a.xplanes, xb = min(a.nx, xa + a.xplanes);
  SlabE<C> f;
  f.s = ring;
  f.y0 = a.cy + 2 * q0;
  f.z0 = a.cz + 2 * r0;
  f.zx = 2 * ZL + 1;
  f.zz = 2 * ZL;
  f.nex = (2 * R + 1) * f.zx;
  f.ney = 2 * R * f.zx;
  f.slot = f.nex + f.ney + (2 * R + 1) * f.zz;
  const int nx = a.nx, ny = a.ny, nz = a.nz;

  // Plane p of the slab, one commit group (only what this block's
  // stations, rows and lines need: ex planes xa-1..xb-1, ey and ez
  // xa-1..xb; ex and ez rows y0..y0+2·nrows, ey rows y0..y0+2·nrows-1;
  // ex and ey z-nodes z0..z0+2·nl, ez z0..z0+2·nl-1).
  auto fill = [&](int p) {
    if (p >= 0 && p <= xb) {
      C* d = ring + (p & (kResSlots - 1)) * f.slot;
      if (p < xb) {
        load_tile(d, a.ex, p, f.y0, f.z0, 2 * nrows + 1, 2 * nl + 1, f.zx,
                  ny + 1, nz + 1);
      }
      load_tile(d + f.nex, a.ey, p, f.y0, f.z0, 2 * nrows, 2 * nl + 1, f.zx,
                ny, nz + 1);
      load_tile(d + f.nex + f.ney, a.ez, p, f.y0, f.z0, 2 * nrows + 1,
                2 * nl, f.zz, ny + 1, nz);
    }
    cp_async_commit();
  };

  // This thread's edge of each plane: rx (t < R·ZL), ry (next 2R·ZL),
  // rz (next 2R·ZL); lines fastest.
  const int t = threadIdx.x, rzl = R * ZL;
  int comp = -1, j = 0, k = 0;
  if (t < rzl) {
    const int row = t / ZL, l = t - row * ZL;
    if (row < nrows && l < nl) {
      comp = 0;
      j = 1 + a.cy + 2 * (q0 + row);
      k = 1 + a.cz + 2 * (r0 + l);
    }
  } else if (t < 3 * rzl) {
    const int u = t - rzl, yy = u / ZL, l = u - yy * ZL;
    if (yy / 2 < nrows && l < nl) {
      comp = 1;
      j = f.y0 + yy;
      k = 1 + a.cz + 2 * (r0 + l);
    }
  } else if (t < 5 * rzl) {
    const int u = t - 3 * rzl, row = u / (2 * ZL), kk = u - row * 2 * ZL;
    if (row < nrows && kk / 2 < nl) {
      comp = 2;
      j = 1 + a.cy + 2 * (q0 + row);
      k = f.z0 + kk;
    }
  }

  if constexpr (!kStaged) {
    // Direct: e through L1/L2, no staging and no barrier (levels too
    // small for the ring's fill latency to pay).
    for (int i = xa; i < xb; ++i) {
      if (comp == 0) {
        a.rx[at(i, j, k, ny + 1, nz + 1)] = res_x(a, i, j, k);
      } else if (comp == 1 && i > 0) {
        a.ry[at(i, j, k, ny, nz + 1)] = res_y(a, i, j, k);
      } else if (comp == 2 && i > 0) {
        a.rz[at(i, j, k, ny + 1, nz)] = res_z(a, i, j, k);
      }
    }
    return;
  }
  fill(xa - 1);
  fill(xa);
  fill(xa + 1);
  for (int i = xa; i < xb; ++i) {
    fill(i + 2);
    asm volatile("cp.async.wait_group 1;\n" ::);   // planes ≤ i+1 landed
    __syncthreads();
    if (comp == 0) {
      a.rx[at(i, j, k, ny + 1, nz + 1)] = res_x(a, f, i, j, k);
    } else if (comp == 1 && i > 0) {
      a.ry[at(i, j, k, ny, nz + 1)] = res_y(a, f, i, j, k);
    } else if (comp == 2 && i > 0) {
      a.rz[at(i, j, k, ny + 1, nz)] = res_z(a, f, i, j, k);
    }
    __syncthreads();   // slot (i-1) % 4 is refilled at the next step
  }
}

// Plane of L(i, k), i > k, in _lower_keys(5) order.
__host__ __device__ constexpr int l_plane(int i, int k) {
  return i * (i - 1) / 2 + k;
}

// Station-block entries absent from D (zeros in the packed stack).
__host__ __device__ constexpr bool d_absent(int a, int b) {
  return (a == 2 && b == 1) || (a == 4 && b == 3);
}

// ---------------------------------------------------------------------
// K5: station entries and block-Thomas elimination
// ---------------------------------------------------------------------

constexpr int kFactorThreads = 256;   // most threads per block

// F: the storage of the stack it writes (R, or bfloat16 for float).
template <class R, class F = R>
struct FactorArgs {
  using real = R;
  using C = cplx_t<R>;
  using FC = typename Store<R, F>::cplx;
  FC* fac;        // (nx, 23, 2, 2, ny2, nz2) out
  const C* stx;   // η edge sums of the rotated frame
  const C* sty;
  const C* stz;
  const R* wx;     // ζ face weights
  const R* wy;
  const R* wz;
  const R* ihx;    // inverse widths
  const R* ihy;
  const R* ihz;
  int nx, ny, nz;
  int stations;         // stations factored (≤ nx; < nx: a segment)
  int nz2;
  int64_t P;            // ny2·nz2: lines per parity
};

// y ← C⁻¹ y with dense LDLᵀ factors in registers
// (blocksolve.ldl_solve_factored, all ten L entries, same order).
template <class C>
__device__ __forceinline__ void ldl_solve_reg(const C (&L)[5][5],
                                              const C (&dinv)[5],
                                              C (&y)[5]) {
#pragma unroll
  for (int i = 1; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) y[i] = csub(y[i], cmul(L[i][k], y[k]));
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) y[i] = cmul(y[i], dinv[i]);
#pragma unroll
  for (int i = 3; i >= 0; --i) {
#pragma unroll
    for (int k = i + 1; k < 5; ++k) y[i] = csub(y[i], cmul(L[k][i], y[k]));
  }
}

// One line per thread.  Line l of the stack is parity quarter l / P
// (y parity, z parity), transverse node (2q + py, 2r + pz) zero-based at
// q = (l % P) / nz2, r = l % nz2; a padded line (beyond the level's
// interior nodes) gets identity diagonals and no coupling.
template <class R, class F>
__global__ void __launch_bounds__(kFactorThreads)
line_factor(FactorArgs<R, F> a) {
  using C = cplx_t<R>;
  const int64_t line = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const int64_t ps = 4 * a.P;   // plane stride
  if (line >= ps) return;
  const int quarter = static_cast<int>(line / a.P);
  const int64_t rem = line % a.P;
  const int j0 = 2 * static_cast<int>(rem / a.nz2) + quarter / 2;
  const int k0 = 2 * static_cast<int>(rem % a.nz2) + quarter % 2;
  const bool valid = j0 < a.ny - 1 && k0 < a.nz - 1;
  const int j = j0 + 1, k = k0 + 1;
  const int nx = a.nx;
  R ihym = 0, ihyp = 0, ihzm = 0, ihzp = 0;
  NodeParams<R> pn;                // node i+1's inputs, loaded a station ahead
  if (valid) {
    ihym = a.ihy[j - 1];
    ihyp = a.ihy[j];
    ihzm = a.ihz[k - 1];
    ihzp = a.ihz[k];
    pn = node_params(a, 1, j, k);
  }
  const C zero = cmake(R(0), R(0));
  const C one = cmake(R(1), R(0));
  C L[5][5];      // factors of the previous station, then this one
  C dinv[5];
  C prev[5];      // node i's A(1,1), A(2..5,1): station i+1's needs
  for (int i = 0; i < a.stations; ++i) {
    // Station i's entries: D (lower triangle; the absent (2,1) and (4,3)
    // zero), B's row 0 (0, b0[1..4]) and diagonal bd[1..4].
    C Cm[5][5], b0[5], bd[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      b0[r] = zero;
      bd[r] = zero;
#pragma unroll
      for (int c = 0; c <= r; ++c) Cm[r][c] = r == c ? one : zero;
    }
    if (valid && i + 1 < nx) {
      // Node i+1: its block gives D; its x-couplings B's diagonal.
      const NodeCoef<R> nc = node_coef(pn.w, a.ihx[i], a.ihx[i + 1], ihym,
                                    ihyp, ihzm, ihzp);
      C A[6][6];
      node_block(nc, pn.st, A);
      if (i + 2 < nx) pn = node_params(a, i + 2, j, k);
      Cm[0][0] = A[0][0];
      Cm[1][1] = A[2][2];
      Cm[2][2] = A[3][3];
      Cm[3][3] = A[4][4];
      Cm[4][4] = A[5][5];
      Cm[1][0] = A[2][0];
      Cm[2][0] = A[3][0];
      Cm[3][0] = A[4][0];
      Cm[4][0] = A[5][0];
      Cm[3][1] = A[4][2];
      Cm[4][1] = A[5][2];
      Cm[3][2] = A[4][3];
      Cm[4][2] = A[5][3];
      if (i > 0) {
        bd[1] = cmake(-(nc.mzxLym * nc.ihxm), R(0));
        bd[2] = cmake(-(nc.mzxLyp * nc.ihxm), R(0));
        bd[3] = cmake(-(nc.myxLzm * nc.ihxm), R(0));
        bd[4] = cmake(-(nc.myxLzp * nc.ihxm), R(0));
#pragma unroll
        for (int m = 1; m < 5; ++m) b0[m] = prev[m];
      }
      prev[0] = A[1][1];
      prev[1] = A[2][1];
      prev[2] = A[3][1];
      prev[3] = A[4][1];
      prev[4] = A[5][1];
    } else if (valid) {
      // The ex-only last station: node nx-1's (1,1), identity rows.
      Cm[0][0] = prev[0];
#pragma unroll
      for (int m = 1; m < 5; ++m) b0[m] = prev[m];
    }
    if (i > 0) {
      // Column b of C_{i-1}⁻¹ B_iᵀ (row b of B_i solved), then column b
      // of C_i = D_i − B_i (C_{i-1}⁻¹ B_iᵀ).
#pragma unroll
      for (int b = 0; b < 5; ++b) {
        C col[5];
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          col[m] = zero;
          if (b == 0 && m > 0) col[m] = b0[m];
          if (b > 0 && m == b) col[m] = bd[b];
        }
        ldl_solve_reg(L, dinv, col);
        if (b == 0) {
#pragma unroll
          for (int m = 1; m < 5; ++m) {
            Cm[0][0] = csub(Cm[0][0], cmul(b0[m], col[m]));
          }
        }
#pragma unroll
        for (int r = 1; r < 5; ++r) {
          if (r < b) continue;
          const C tt = cmul(bd[r], col[r]);
          Cm[r][b] = d_absent(r, b) ? cmake(-tt.x, -tt.y)
                                   : csub(Cm[r][b], tt);
        }
      }
    }
    // Sparse LDLᵀ of C (blocksolve.ldl_factor_sparse, same order; every
    // entry is present from station 1 on, and at station 0 an absent
    // D entry gives 0 − s there as here).
    C D[5];   // D[k] = 1 / dinv[k], as blocksolve._d recomputes it
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      C acc = Cm[c][c];
#pragma unroll
      for (int m = 0; m < c; ++m) {
        acc = csub(acc, cmul(cmul(L[c][m], L[c][m]), D[m]));
      }
      dinv[c] = crecip(acc);
      D[c] = crecip(dinv[c]);
#pragma unroll
      for (int r = c + 1; r < 5; ++r) {
        C val = Cm[r][c];
        if (c > 0) {
          C sum = cmul(cmul(L[r][0], L[c][0]), D[0]);
#pragma unroll
          for (int m = 1; m < c; ++m) {
            sum = cadd(sum, cmul(cmul(L[r][m], L[c][m]), D[m]));
          }
          val = csub(val, sum);
        }
        L[r][c] = cmul(val, dinv[c]);
      }
    }
    // The station's 23 planes, stored (rounded where F is bfloat16;
    // the recurrence above keeps the unrounded factors).
    typename FactorArgs<R, F>::FC* s =
        a.fac + static_cast<int64_t>(i) * kNent * ps + line;
#pragma unroll
    for (int r = 1; r < 5; ++r) {
#pragma unroll
      for (int c = 0; c < r; ++c) put(&s[l_plane(r, c) * ps], L[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 5; ++r) put(&s[(kDinv + r) * ps], dinv[r]);
#pragma unroll
    for (int m = 1; m < 5; ++m) {
      put(&s[(kB + m - 1) * ps], b0[m]);
      put(&s[(kB + 3 + m) * ps], bd[m]);
    }
  }
}

// ---------------------------------------------------------------------
// K4: block-Thomas substitution of one colour, in place
// ---------------------------------------------------------------------

// F: the storage of the factor stack (R, or bfloat16 for float).
template <class R, class F = R>
struct ThomasArgs {
  using real = R;
  using C = cplx_t<R>;
  using FC = typename Store<R, F>::cplx;
  C* ex;          // fields, updated in place
  C* ey;
  C* ez;
  const C* rx;    // residual of the colour step (K3)
  const C* ry;
  const C* rz;
  const FC* fac;  // (nx, 23, 2, 2, ny2, nz2)
  C* zs;          // global scratch (B, nx, 5, ny2·nz2) if !zshared
  const int* group;     // lane → frequency group (B entries), or null
  int nx, ny, nz;
  int stations;         // stations solved (≤ nx; < nx: a segment)
  int cy, cz;           // the colour's transverse parity
  int cny, cnz;         // active lines per transverse axis
  int zshared;          // 1: z in shared memory after the ring
  int planes;           // ring planes per slot: 28, or 33 with global z
};

__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead));
}

// y ← C⁻¹ y with the LDLᵀ factors of one station at f[p·stride], stored
// as FC (blocksolve.ldl_solve_factored, all ten L entries, same order).
template <class FC, class C>
__device__ __forceinline__ void ldl_solve5(const FC* f, int stride,
                                           C (&y)[5]) {
#pragma unroll
  for (int i = 1; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) {
      y[i] = csub(y[i], cmul(up(f[l_plane(i, k) * stride]), y[k]));
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    y[i] = cmul(y[i], up(f[(kDinv + i) * stride]));
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
#pragma unroll
    for (int k = i + 1; k < 5; ++k) {
      y[i] = csub(y[i], cmul(up(f[l_plane(k, i) * stride]), y[k]));
    }
  }
}

// Bytes of one K4 ring slot of ``planes`` planes of ``lpb`` lines: the
// kNent factor planes (FC entries) padded to a whole C, then the others
// (residuals, fields, z; C entries).  For FC = C, planes·lpb C entries.
template <class C, class FC>
__host__ __device__ constexpr int factor_part_bytes(int lpb) {
  return static_cast<int>((kNent * lpb * sizeof(FC) + sizeof(C) - 1) /
                          sizeof(C) * sizeof(C));
}
template <class C, class FC>
__host__ __device__ constexpr int slot_bytes(int planes, int lpb) {
  return factor_part_bytes<C, FC>(lpb) +
         static_cast<int>((planes - kNent) * lpb * sizeof(C));
}

// The ring copies of one lane.  Lane ``lane`` loads, for line
// l = lane mod LPB, the slot planes p0, p0 + kStep, ... (kStep =
// 32 / LPB): the factor planes among them at one address step each, the
// others (residuals r_i forward; field values e_i and, with global z,
// z_i backward) from a table of station-0 addresses and strides set once
// per sweep.  All trip counts are compile-time, so the copies of lanes
// that own different planes unroll into predicated instructions instead
// of diverging.  The last station has an ex residual and edge only
// (``last`` bits).
template <int kStep, class C, class FC>
struct Copies {
  static constexpr int kF = (kNent + kStep - 1) / kStep;   // factor, max
  static constexpr int kX = (10 + kStep - 1) / kStep;      // others, max
  const FC* f;    // factor plane p0 of station 0
  int nf;               // factor planes of this lane
  int px;               // first non-factor plane of this lane
  int nx_;              // non-factor planes of this lane
  unsigned last;        // bit n: table entry n skipped at the last station
  const C* base[kX];
  int64_t stride[kX];
};

template <int kStep, class R, class F, class C = cplx_t<R>,
          class FC = typename Store<R, F>::cplx>
__device__ __forceinline__ Copies<kStep, C, FC> plan_copies(
    const ThomasArgs<R, F>& a, bool forward, int p0, int j, int k,
    int64_t fline, int64_t zline, int64_t pstride, int64_t P) {
  Copies<kStep, C, FC> c;
  const int nplanes = forward ? kNent + 5 : a.planes;
  c.f = a.fac + p0 * pstride + fline;
  c.nf = p0 < kNent ? (kNent - 1 - p0) / kStep + 1 : 0;
  c.px = p0 + c.nf * kStep;
  c.nx_ = 0;
  c.last = 0;
  const C* fx = forward ? a.rx : a.ex;
  const C* fy = forward ? a.ry : a.ey;
  const C* fz = forward ? a.rz : a.ez;
#pragma unroll
  for (int n = 0; n < Copies<kStep, C, FC>::kX; ++n) {
    const int m = c.px + n * kStep - kNent;
    c.base[n] = nullptr;
    c.stride[n] = 0;
    if (m >= nplanes - kNent) continue;
    // Station i's edges: ex(i, j, k), ey(i+1, j-1|j, k), ez(i+1, j,
    // k-1|k); the bases are station 0's.
    if (m == 0) {
      c.base[n] = fx + at(0, j, k, a.ny + 1, a.nz + 1);
      c.stride[n] = static_cast<int64_t>(a.ny + 1) * (a.nz + 1);
    } else if (m < 3) {
      c.base[n] = fy + at(1, j - 2 + m, k, a.ny, a.nz + 1);
      c.stride[n] = static_cast<int64_t>(a.ny) * (a.nz + 1);
    } else if (m < 5) {
      c.base[n] = fz + at(1, j, k - 4 + m, a.ny + 1, a.nz);
      c.stride[n] = static_cast<int64_t>(a.ny + 1) * a.nz;
    } else {
      c.base[n] = a.zs + (m - 5) * P + zline;
      c.stride[n] = 5 * P;
    }
    if (m > 0 && m < 5) c.last |= 1u << n;
    c.nx_ = n + 1;
  }
  return c;
}

template <int LPB, class R, class F>
__global__ void __launch_bounds__(kWarp)
line_thomas(ThomasArgs<R, F> a) {
  using C = cplx_t<R>;
  using FC = typename ThomasArgs<R, F>::FC;
  // Raw bytes: the float and double instances share the symbol.
  extern __shared__ __align__(16) unsigned char thomas_smem[];
  const int lane = threadIdx.x;
  constexpr int lpb = LPB, kStep = kWarp / LPB;
  const int64_t nlines = static_cast<int64_t>(a.cny) * a.cnz;
  const int nz2 = a.nz / 2;
  const int64_t P = static_cast<int64_t>(a.ny / 2) * nz2;
  {
    // The batch lane (grid y): its fields, residual and z scratch, its
    // group's factor stack.
    const int64_t b = blockIdx.y, grp = a.group ? a.group[b] : 0;
    const int64_t nx = a.nx, ny = a.ny, nz = a.nz;
    const int64_t ex = nx * (ny + 1) * (nz + 1),
                  ey = (nx + 1) * ny * (nz + 1), ez = (nx + 1) * (ny + 1) * nz;
    a.ex += b * ex;
    a.rx += b * ex;
    a.ey += b * ey;
    a.ry += b * ey;
    a.ez += b * ez;
    a.rz += b * ez;
    a.fac += grp * a.stations * kNent * 4 * P;
    if (!a.zshared) a.zs += b * nx * 5 * P;
  }
  const int64_t pstride = 4 * P;   // consecutive planes of one station
  const int64_t quarter = (a.cy * 2 + a.cz) * P;
  // Slot i % kStages: the factor planes (fslot), then the residual,
  // field and z planes (oslot); after the ring z, (nx, 5, lpb), if
  // zshared.
  const int fbytes = factor_part_bytes<C, FC>(lpb);
  const int sbytes = slot_bytes<C, FC>(a.planes, lpb);
  C* zsm = reinterpret_cast<C*>(thomas_smem + kStages * sbytes);

  // The line this lane loads for, and the one it computes if lane < lpb
  // (the same: l = lane mod lpb).
  const int l = lane & (lpb - 1);
  const int64_t g = static_cast<int64_t>(blockIdx.x) * lpb + l;
  const bool valid = g < nlines;
  const int q = valid ? static_cast<int>(g / a.cnz) : 0;
  const int r = valid ? static_cast<int>(g % a.cnz) : 0;
  const int j = 1 + a.cy + 2 * q;          // the line's y- and z-node
  const int k = 1 + a.cz + 2 * r;
  const int64_t zline = static_cast<int64_t>(q) * nz2 + r;
  const int64_t fline = quarter + zline;
  const int p0 = lane / lpb;
  const bool active = valid && lane < lpb;
  const int nx = a.nx;
  const int ns = a.stations;

  auto fslot = [&](int i) {
    return reinterpret_cast<FC*>(thomas_smem + (i % kStages) * sbytes);
  };
  auto oslot = [&](int i) {
    return reinterpret_cast<C*>(thomas_smem + (i % kStages) * sbytes +
                                fbytes);
  };
  Copies<kStep, C, FC> cp;
  auto fill = [&](int i) {
    if (valid && i >= 0 && i < ns) {
      FC* dstf = fslot(i) + l;
      C* dsto = oslot(i) + l;
      const FC* f = cp.f + static_cast<int64_t>(i) * kNent * pstride;
#pragma unroll
      for (int n = 0; n < Copies<kStep, C, FC>::kF; ++n) {
        if (n < cp.nf) {
          cp_async(dstf + (p0 + n * kStep) * lpb, f + n * kStep * pstride);
        }
      }
#pragma unroll
      for (int n = 0; n < Copies<kStep, C, FC>::kX; ++n) {
        if (n < cp.nx_ && !(i == nx - 1 && ((cp.last >> n) & 1u))) {
          cp_async(dsto + (cp.px + n * kStep - kNent) * lpb,
                   cp.base[n] + i * cp.stride[n]);
        }
      }
    }
    cp_async_commit();
  };

  // Forward: y_i = r_i − B_i z_{i-1} (no B term at station 0),
  // z_i = C_i⁻¹ y_i.
  C zp[5];
  cp = plan_copies<kStep>(a, true, p0, j, k, fline, zline, pstride, P);
  for (int i = 0; i < kAhead; ++i) fill(i);
  for (int i = 0; i < ns; ++i) {
    fill(i + kAhead);
    cp_async_wait_ahead();
    __syncwarp();
    if (active) {
      const FC* f = fslot(i) + lane;
      const C* o = oslot(i) + lane;
      C y[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        y[m] = (m == 0 || i < nx - 1) ? o[m * lpb] : cmake(R(0), R(0));
      }
      if (i > 0) {
#pragma unroll
        for (int m = 1; m < 5; ++m) {
          y[0] = csub(y[0], cmul(up(f[(kB + m - 1) * lpb]), zp[m]));
        }
#pragma unroll
        for (int m = 1; m < 5; ++m) {
          y[m] = csub(y[m], cmul(up(f[(kB + 3 + m) * lpb]), zp[m]));
        }
      }
      ldl_solve5(f, lpb, y);
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        if (a.zshared) {
          zsm[(i * 5 + m) * lpb + lane] = y[m];
        } else {
          a.zs[(static_cast<int64_t>(i) * 5 + m) * P + zline] = y[m];
        }
        zp[m] = y[m];
      }
    }
    __syncwarp();
  }
  // The global z of the forward sweep is read back through the ring.
  __threadfence_block();
  __syncwarp();

  // Backward: δ_{S-1} = z_{S-1}; δ_i = z_i − C_i⁻¹ (B_{i+1}ᵀ δ_{i+1}),
  // each δ_i added into the line's edges as soon as it is known.
  C dn[5];
  cp = plan_copies<kStep>(a, false, p0, j, k, fline, zline, pstride,
                          P);
  for (int n = 0; n < kAhead; ++n) fill(ns - 1 - n);
  for (int i = ns - 1; i >= 0; --i) {
    fill(i - kAhead);
    cp_async_wait_ahead();
    __syncwarp();
    if (active) {
      const FC* f = fslot(i) + lane;
      const C* o = oslot(i) + lane;
      C d[5];
      if (i == ns - 1) {
#pragma unroll
        for (int m = 0; m < 5; ++m) d[m] = zp[m];
      } else {
        const FC* fn = fslot(i + 1) + lane;   // station i+1
        // (Bᵀ)_{ak} = B_{ka}: row 0 of Bᵀ is zero.
        C u[5];
        u[0] = cmake(R(0), R(0));
#pragma unroll
        for (int m = 1; m < 5; ++m) {
          u[m] = cadd(cmul(up(fn[(kB + m - 1) * lpb]), dn[0]),
                      cmul(up(fn[(kB + 3 + m) * lpb]), dn[m]));
        }
        ldl_solve5(f, lpb, u);
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          const C z = a.zshared ? zsm[(i * 5 + m) * lpb + lane]
                                : o[(5 + m) * lpb];
          d[m] = csub(z, u[m]);
        }
      }
      EX(i, j, k) = cadd(o[0], d[0]);
      if (i < nx - 1) {
        EY(i + 1, j - 1, k) = cadd(o[1 * lpb], d[1]);
        EY(i + 1, j, k) = cadd(o[2 * lpb], d[2]);
        EZ(i + 1, j, k - 1) = cadd(o[3 * lpb], d[3]);
        EZ(i + 1, j, k) = cadd(o[4 * lpb], d[4]);
      }
#pragma unroll
      for (int m = 0; m < 5; ++m) dn[m] = d[m];
    }
    __syncwarp();
  }
}

template <int LPB, class R, class F>
int launch_thomas(const ThomasArgs<R, F>& a, dim3 blocks, int smem,
                  cudaStream_t stream) {
  using C = cplx_t<R>;
  using FC = typename ThomasArgs<R, F>::FC;
  // The ring and z (the Python geometry's smem_bytes) or nothing.
  const int want = kStages * slot_bytes<C, FC>(a.planes, LPB) +
                   (a.zshared ? a.nx * 5 * LPB * static_cast<int>(sizeof(C))
                              : 0);
  if (smem != want) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        line_thomas<LPB, R, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  line_thomas<LPB, R, F><<<blocks, kWarp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class R, class S>
int residual(void* rx, void* ry, void* rz, const void* ex, const void* ey,
             const void* ez, const void* sx, const void* sy, const void* sz,
             const void* stx, const void* sty, const void* stz,
             const void* wx, const void* wy, const void* wz, const void* ihx,
             const void* ihy, const void* ihz, const void* group, int nx,
             int ny, int nz, int cy, int cz, int cny, int cnz, int rows,
             int lines, int xplanes, int staged, int blocks, int lanes,
             int threads, int smem, void* stream) {
  using C = cplx_t<R>;
  const int ring = kResSlots * static_cast<int>(sizeof(C)) *
                   ((2 * rows + 1) * (2 * lines + 1) +
                    2 * rows * (2 * lines + 1) + (2 * rows + 1) * 2 * lines);
  if (rows < 1 || lines < 1 || xplanes < 1 || threads > 256 ||
      threads < 5 * rows * lines || smem != (staged ? ring : 0) ||
      lanes < 1 || lanes > 65535 || (lanes > 1 && group == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using A = ResArgs<R, S>;
  using SC = typename A::SC;
  using SR = typename A::SR;
  A a;
  a.rx = static_cast<C*>(rx);
  a.ry = static_cast<C*>(ry);
  a.rz = static_cast<C*>(rz);
  a.ex = static_cast<const C*>(ex);
  a.ey = static_cast<const C*>(ey);
  a.ez = static_cast<const C*>(ez);
  a.sx = static_cast<const SC*>(sx);
  a.sy = static_cast<const SC*>(sy);
  a.sz = static_cast<const SC*>(sz);
  a.stx = static_cast<const SC*>(stx);
  a.sty = static_cast<const SC*>(sty);
  a.stz = static_cast<const SC*>(stz);
  a.wx = static_cast<const SR*>(wx);
  a.wy = static_cast<const SR*>(wy);
  a.wz = static_cast<const SR*>(wz);
  a.ihx = static_cast<const R*>(ihx);
  a.ihy = static_cast<const R*>(ihy);
  a.ihz = static_cast<const R*>(ihz);
  a.group = static_cast<const int*>(group);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.cy = cy;
  a.cz = cz;
  a.cny = cny;
  a.cnz = cnz;
  a.rows = rows;
  a.lines = lines;
  a.xplanes = xplanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, lanes);
  if (!staged) {
    line_residual<false, R, S><<<grid, threads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        line_residual<true, R, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  line_residual<true, R, S><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class R, class F>
int thomas(void* ex, void* ey, void* ez, const void* rx, const void* ry,
           const void* rz, const void* fac, void* zs, const void* group,
           int nx, int ny, int nz, int stations, int cy, int cz, int cny,
           int cnz, int lpb, int zshared, int planes, int stages, int blocks,
           int lanes, int threads, int smem, void* stream) {
  using C = cplx_t<R>;
  if (stations < 1 || stations > nx || stages != kStages || threads != kWarp ||
      lanes < 1 || lanes > 65535 || (lanes > 1 && group == nullptr) ||
      lpb < 1 || lpb > kWarp || (lpb & (lpb - 1)) != 0 ||
      (planes != kNent + 5 && planes != kNent + 10) ||
      (!zshared && planes != kNent + 10)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ThomasArgs<R, F> a;
  a.ex = static_cast<C*>(ex);
  a.ey = static_cast<C*>(ey);
  a.ez = static_cast<C*>(ez);
  a.rx = static_cast<const C*>(rx);
  a.ry = static_cast<const C*>(ry);
  a.rz = static_cast<const C*>(rz);
  a.fac = static_cast<const typename ThomasArgs<R, F>::FC*>(fac);
  a.zs = static_cast<C*>(zs);
  a.group = static_cast<const int*>(group);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.stations = stations;
  a.cy = cy;
  a.cz = cz;
  a.cny = cny;
  a.cnz = cnz;
  a.zshared = zshared;
  a.planes = planes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, lanes);
  switch (lpb) {
    case 1: return launch_thomas<1, R, F>(a, grid, smem, st);
    case 2: return launch_thomas<2, R, F>(a, grid, smem, st);
    case 4: return launch_thomas<4, R, F>(a, grid, smem, st);
    case 8: return launch_thomas<8, R, F>(a, grid, smem, st);
    case 16: return launch_thomas<16, R, F>(a, grid, smem, st);
    default: return launch_thomas<32, R, F>(a, grid, smem, st);
  }
}

template <class R, class F>
int factor(void* fac, const void* stx, const void* sty, const void* stz,
           const void* wx, const void* wy, const void* wz, const void* ihx,
           const void* ihy, const void* ihz, int nx, int ny, int nz,
           int stations, int blocks, int threads, void* stream) {
  using C = cplx_t<R>;
  if (threads < 32 || threads % 32 != 0 || threads > kFactorThreads ||
      nx < 2 || stations < 1 || stations > nx || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FactorArgs<R, F> a;
  a.fac = static_cast<typename FactorArgs<R, F>::FC*>(fac);
  a.stx = static_cast<const C*>(stx);
  a.sty = static_cast<const C*>(sty);
  a.stz = static_cast<const C*>(stz);
  a.wx = static_cast<const R*>(wx);
  a.wy = static_cast<const R*>(wy);
  a.wz = static_cast<const R*>(wz);
  a.ihx = static_cast<const R*>(ihx);
  a.ihy = static_cast<const R*>(ihy);
  a.ihz = static_cast<const R*>(ihz);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.stations = stations;
  a.nz2 = nz / 2;
  a.P = static_cast<int64_t>(ny / 2) * (nz / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  line_factor<R, F><<<blocks, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by emg3d_tpu_torch/ops/line_gs.py.
// Each launches one kernel on ``stream`` and returns cudaGetLastError()
// (0 on success); the launch geometry comes from the Python
// launch-geometry functions, which skip colours without lines.  Every
// entry point takes complex128 tensors (float64 weights and widths);
// its ``_c64`` twin the same in complex64 (float32); its ``_bf16`` twin
// complex64 with its stream stored in bfloat16 (each complex value two
// bfloat16, re and im): K3 s, st and w, K4 the stack it reads, K5 the
// stack it writes.
//
// K3 and K4 take ``lanes`` batch lanes (the grid's y extent) and
// ``group``, the lane → frequency-group table on the card (null: one
// lane).
#define EMG3D_RES_PARAMS                                                     \
  void *rx, void *ry, void *rz, const void *ex, const void *ey,              \
      const void *ez, const void *sx, const void *sy, const void *sz,        \
      const void *stx, const void *sty, const void *stz, const void *wx,     \
      const void *wy, const void *wz, const void *ihx, const void *ihy,      \
      const void *ihz, const void *group, int nx, int ny, int nz, int cy,    \
      int cz, int cny, int cnz, int rows, int lines, int xplanes,            \
      int staged, int blocks, int lanes, int threads, int smem, void *stream
#define EMG3D_RES_ARGS                                                       \
  rx, ry, rz, ex, ey, ez, sx, sy, sz, stx, sty, stz, wx, wy, wz, ihx, ihy,   \
      ihz, group, nx, ny, nz, cy, cz, cny, cnz, rows, lines, xplanes,        \
      staged, blocks, lanes, threads, smem, stream
extern "C" int emg3d_line_residual(EMG3D_RES_PARAMS) {
  return residual<double, double>(EMG3D_RES_ARGS);
}
extern "C" int emg3d_line_residual_c64(EMG3D_RES_PARAMS) {
  return residual<float, float>(EMG3D_RES_ARGS);
}
extern "C" int emg3d_line_residual_bf16(EMG3D_RES_PARAMS) {
  return residual<float, __nv_bfloat16>(EMG3D_RES_ARGS);
}

// ``stages`` and ``threads`` must equal kStages and kWarp (the Python
// geometry's constants); ``smem`` is the block's dynamic shared memory,
// which must equal the ring's and z's bytes (slot_bytes).
#define EMG3D_THOMAS_PARAMS                                                  \
  void *ex, void *ey, void *ez, const void *rx, const void *ry,              \
      const void *rz, const void *fac, void *zs, const void *group, int nx,  \
      int ny, int nz, int stations, int cy, int cz, int cny, int cnz,        \
      int lpb, int zshared, int planes, int stages, int blocks, int lanes,   \
      int threads, int smem, void *stream
#define EMG3D_THOMAS_ARGS                                                    \
  ex, ey, ez, rx, ry, rz, fac, zs, group, nx, ny, nz, stations, cy, cz, cny, \
      cnz, lpb, zshared, planes, stages, blocks, lanes, threads, smem, stream
extern "C" int emg3d_line_thomas(EMG3D_THOMAS_PARAMS) {
  return thomas<double, double>(EMG3D_THOMAS_ARGS);
}
extern "C" int emg3d_line_thomas_c64(EMG3D_THOMAS_PARAMS) {
  return thomas<float, float>(EMG3D_THOMAS_ARGS);
}
extern "C" int emg3d_line_thomas_bf16(EMG3D_THOMAS_PARAMS) {
  return thomas<float, __nv_bfloat16>(EMG3D_THOMAS_ARGS);
}

// K5 on the rotated level (nx, ny, nz) into ``fac`` (its (stations, 23,
// 2, 2, ny/2, nz/2) stack: the whole lines where stations == nx), one
// line per thread.
#define EMG3D_FACTOR_PARAMS                                                  \
  void *fac, const void *stx, const void *sty, const void *stz,              \
      const void *wx, const void *wy, const void *wz, const void *ihx,       \
      const void *ihy, const void *ihz, int nx, int ny, int nz,              \
      int stations, int blocks, int threads, void *stream
#define EMG3D_FACTOR_ARGS                                                    \
  fac, stx, sty, stz, wx, wy, wz, ihx, ihy, ihz, nx, ny, nz, stations,       \
      blocks, threads, stream
extern "C" int emg3d_line_factor(EMG3D_FACTOR_PARAMS) {
  return factor<double, double>(EMG3D_FACTOR_ARGS);
}
extern "C" int emg3d_line_factor_c64(EMG3D_FACTOR_PARAMS) {
  return factor<float, float>(EMG3D_FACTOR_ARGS);
}
extern "C" int emg3d_line_factor_bf16(EMG3D_FACTOR_PARAMS) {
  return factor<float, __nv_bfloat16>(EMG3D_FACTOR_ARGS);
}
