// Point Gauss-Seidel colour step for Hopper (sm_90a), in the two scalar
// types of a solve: complex128 and complex64 (every kernel is templated
// on its real type R, double or float; each C entry point below has a
// ``_c64`` twin that launches the float instance).  The complex64
// instances are the precision the Pallas kernels compute in (float32
// split re/im, pallas_gs.py:48); their plans and launch geometry are the
// complex128 ones, with every byte count taken at the element size.
//
// Replaces the two Pallas point-smoother kernels of the JAX package,
// emg3d_tpu/ops/pallas_gs.py:
//
//   K1  "factored" <- _kernel_resident (644-747), the colour update
//       against LDLᵀ factors built once per level (pack_factors,
//       614-641): each step runs substitution only.
//   K2  "fused"    <- _kernel (237-403), which assembles each node's 6×6
//       block from the ζ face weights, η edge sums and inverse widths
//       (pallas_gs.py:345-371 = coeffs.py:47-152; node_block.cuh) and
//       factors and solves it in registers (blocksolve.py:32-85).
//
// A colour step: one thread owns one ACTIVE interior node (ix, iy, iz),
// i.e. one whose index parity equals the colour's.  It
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
// Launch plans, of both kernels (the Python rule point_gs.sweep_plan
// picks one per level and kernel from times measured on the card):
//   step     point_gs_step<kernel>: one launch per colour step, 8·nu per
//            smoothing call (colours 0..7 on even sweeps, 7..0 on odd).
//   cluster  point_gs_sweep<kCluster, kernel>: the whole colour sequence
//            of a smoothing call in ONE launch of one thread-block
//            cluster (≤ 8 CTAs), grid-stride over each colour's nodes, a
//            cluster barrier between colour steps.
//   grid     point_gs_sweep<kGrid, kernel>: the same as a cooperative
//            launch of up to one block per SM, a grid barrier between
//            colour steps.
//   shared   point_gs_sweep<kShared, kernel>: one CTA for a level that
//            fits its shared memory whole (e, s, η sums, ζ weights,
//            widths and, for K1, the factors: 8³ takes 200 KB of 227 KB
//            with factors, 95 KB without): copied in once with cp.async,
//            every step runs from shared memory with a block barrier
//            between steps, and e is copied back once.  The counterpart
//            of _kernel_resident's VMEM copy-in/copy-out
//            (pallas_gs.py:667-676, 742-746), which also runs every colour
//            step of a call in one pallas_call (grid (len(seq), tiles)).
// On the small levels a step is a latency chain per node (the stencil's
// index arithmetic, ~50 loads, ~730 fp64 operations for K1, ~1590 for
// K2), and warps that share an SM wait on each other's issue slots: the
// sweep plans therefore size their blocks (32-256 threads, Python) so
// that a colour's nodes spread over as many SMs as the plan has blocks.
// Every node's arithmetic is the same code in every plan, so a plan is
// bitwise equal to the step plan.  Between steps e is written by other
// threads: it is never read through the non-coherent path (no __ldg,
// no const __restrict__ on the e pointers); the barriers order the
// writes (release) before the next step's reads (acquire).
//
// Colour-major data.  Colour c's active nodes are packed contiguously,
// z fastest, in the order of the thread index; plane p of the node of
// thread t sits at off_c + p·n_c + t (point_gs.pack_colour_major), so a
// warp's plane load is one 512 B run, where a node-indexed array spreads
// it over 1 KB at stride 2 along z, half of it the other colours' nodes.
//   K1 reads its 20 factor planes so (point_gs.pack_factors).
//   K2 reads its node's field-independent inputs so
//   (point_gs.pack_node_data, kernel kFusedPacked): 12 complex planes,
//   the six η sums and the twelve ζ weights in pairs (192 B a node in
//   complex128, NodeParams of node_block.cuh).  Those are all the sums and
//   weights that the node's six residuals and its block read.  Where the
//   packed data does not fit the card (Python's rule), K2 reads st and
//   w at the node's indices instead (kFused); the values, and so the
//   results, are the same.
//
// Bound on this card: memory.  Per active node K1 loads 20 complex128
// factors (320 B), K2 12 packed planes (192 B), plus the node's e, s
// and widths and stencil neighbours that are mostly shared with
// neighbouring threads through L1/L2; fp64 arithmetic is below the
// H100's fp64 rate per byte for K1 and near it for K2.  wgmma and TMA
// do not apply (no matrix product, no regular tile).  In complex64 every
// byte count halves and the arithmetic is fp32, twice the fp64 rate.
// On the coarse levels of a cycle the cost was the launches: 8·nu per
// smoothing call, ~4 µs of device time each whatever their size, and a
// host call each; the sweep plans make it one.
//
// bfloat16 storage (the ``_bf16`` entry points): a complex64 solve may
// store s, the η sums and the ζ weights in bfloat16 (the JAX package's
// pack_params(pdtype=) and pack_fields(sdtype=), pallas_gs.py:433-484,
// read by _kernel and _kernel_resident through _up, :312-322).  Every
// kernel is templated on that storage type S as well (S = R, or
// __nv_bfloat16 with R = float): the loads widen (stencil.cuh: up), the
// arithmetic stays float32.  K1's factors and K2's packed node data stay
// float32 (K2's built from the rounded sums and weights), e and the
// widths too.  A node then reads 4 B instead of 8 for each of its s, η
// sum and ζ weight values; the shared plan stacks the level's tensors by
// element size, largest first, so that each starts aligned.
//
// The complex arithmetic and the residual at an edge are in
// stencil.cuh, shared with the line kernels (line_gs.cu); the node
// block's assembly is in node_block.cuh, shared with K5.

#include <cooperative_groups.h>

#include "node_block.cuh"
#include "stencil.cuh"

namespace cg = cooperative_groups;

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
constexpr int kNodePlanes = 12;   // K2's packed planes: 6 η sums, 6 ζ pairs

// The kernel a launch runs: K1, K2 reading st/w at the node's indices,
// or K2 reading its colour-major packed node data.
enum Kernel { kFactored = 0, kFused = 1, kFusedPacked = 2 };

// R: the compute (real) type; S: the storage of s, η sums and ζ weights.
template <class R, class S = R>
struct Args {
  using real = R;
  using C = cplx_t<R>;
  using SC = typename Store<R, S>::cplx;
  using SR = typename Store<R, S>::real;
  C* ex;                // (nx, ny+1, nz+1), updated in place
  C* ey;                // (nx+1, ny, nz+1)
  C* ez;                // (nx+1, ny+1, nz)
  const SC* sx;         // source, same shapes as e
  const SC* sy;
  const SC* sz;
  const SC* stx;        // η edge sums (nx, ny-1, nz-1)
  const SC* sty;        // (nx-1, ny, nz-1)
  const SC* stz;        // (nx-1, ny-1, nz)
  const SR* wx;         // ζ face weights (nx+1, ny, nz)
  const SR* wy;         // (nx, ny+1, nz)
  const SR* wz;         // (nx, ny, nz+1)
  const R* ihx;         // inverse widths (nx,), (ny,), (nz,)
  const R* ihy;
  const R* ihz;
  const C* buf;         // colour-major planes: K1's factors, K2's packed
                        // node data; unused by kFused
  int nx, ny, nz;
  int x0, y0, z0;       // first active node index per axis
  int cnx, cny, cnz;    // active nodes per axis
};

// K2: the block's LDLᵀ (blocksolve.ldl_factor_sparse, same operation
// order) from its assembly (node_block.cuh).
template <class A, class C = cplx_of<A>>
__device__ void factor_block(const A& a,
                             const NodeParams<typename A::real>& p, int i,
                             int j, int k, C (&L)[6][6], C (&dinv)[6]) {
  C Ab[6][6];
  node_block(node_coef(p.w, a.ihx[i - 1], a.ihx[i], a.ihy[j - 1], a.ihy[j],
                       a.ihz[k - 1], a.ihz[k]),
             p.st, Ab);
  C D[6];  // D[k] = 1 / dinv[k], as blocksolve._d recomputes it
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    C acc = Ab[c][c];
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
      C s = cmake(typename A::real(0), typename A::real(0));
#pragma unroll
      for (int m = 0; m < c; ++m) {
        if (l_present(r, m) && l_present(c, m)) {
          const C t = cmul(cmul(L[r][m], L[c][m]), D[m]);
          s = has_s ? cadd(s, t) : t;
          has_s = true;
        }
      }
      C val = a_present(r, c) ? Ab[r][c]
                              : cmake(typename A::real(0), typename A::real(0));
      if (has_s) val = csub(val, s);
      L[r][c] = cmul(val, dinv[c]);
    }
  }
}

// One colour's node ``tid`` (of n = cnx·cny·cnz): residual at its six
// block edges, the block solve, the in-place deposit.  ``buf`` holds
// the colour's planes of n nodes each: K1's 20 factors, or K2's 12
// packed parameter planes (unused by kFused).
template <int kKernel, class A, class C = cplx_of<A>>
__device__ __forceinline__ void node_update(const A& a, const C* buf,
                                            int64_t n, int64_t tid, int x0,
                                            int y0, int z0, int cny,
                                            int cnz) {
  const int c = static_cast<int>(tid % cnz);
  const int64_t t = tid / cnz;
  const int b = static_cast<int>(t % cny);
  const int q = static_cast<int>(t / cny);
  const int i = x0 + 2 * q;
  const int j = y0 + 2 * b;
  const int k = z0 + 2 * c;

  C y[6];
  C L[6][6];
  C dinv[6];
  if constexpr (kKernel == kFactored) {
    // 1. Residual at the six block edges, from the pre-step field.
    y[0] = res_x(a, i - 1, j, k);
    y[1] = res_x(a, i, j, k);
    y[2] = res_y(a, i, j - 1, k);
    y[3] = res_y(a, i, j, k);
    y[4] = res_z(a, i, j, k - 1);
    y[5] = res_z(a, i, j, k);
    // 2. The block's LDLᵀ factors, loaded.
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int m = 0; m < r; ++m) {
        if (l_present(r, m)) L[r][m] = buf[l_plane(r, m) * n + tid];
      }
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) dinv[r] = buf[(kDinvPlane + r) * n + tid];
  } else {
    // 1. The node's η sums and ζ weights, then the residual at its six
    // block edges from them and the pre-step field.
    NodeParams<typename A::real> p;
    if constexpr (kKernel == kFusedPacked) {
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        p.st[m] = buf[m * n + tid];
        p.w[m] = buf[(6 + m) * n + tid];
      }
    } else {
      p = node_params(a, i, j, k);
    }
    const GlobalE<A> f{a};
    y[0] = res_x(a, f, i - 1, j, k, p.st[0], p.w[0].y, p.w[0].x, p.w[2].y,
                 p.w[2].x);
    y[1] = res_x(a, f, i, j, k, p.st[1], p.w[1].y, p.w[1].x, p.w[3].y,
                 p.w[3].x);
    y[2] = res_y(a, f, i, j - 1, k, p.st[2], p.w[4].y, p.w[4].x, p.w[1].x,
                 p.w[0].x);
    y[3] = res_y(a, f, i, j, k, p.st[3], p.w[5].y, p.w[5].x, p.w[1].y,
                 p.w[0].y);
    y[4] = res_z(a, f, i, j, k - 1, p.st[4], p.w[3].x, p.w[2].x, p.w[5].x,
                 p.w[4].x);
    y[5] = res_z(a, f, i, j, k, p.st[5], p.w[3].y, p.w[2].y, p.w[5].y,
                 p.w[4].y);
    // 2. The block, assembled and factored here.
    factor_block(a, p, i, j, k, L, dinv);
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

constexpr int kThreads = 256;   // most threads per block, every plan

template <int kKernel, class R, class S>
__global__ void __launch_bounds__(kThreads)
point_gs_step(Args<R, S> a) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t n = static_cast<int64_t>(a.cnx) * a.cny * a.cnz;
  if (tid >= n) return;
  node_update<kKernel>(a, a.buf, n, tid, a.x0, a.y0, a.z0, a.cny, a.cnz);
}

// ---------------------------------------------------------------------
// Sweep: every colour step of a smoothing call in one launch
// ---------------------------------------------------------------------

constexpr int kMaxSeq = 64;     // colour steps per launch (nu ≤ 8)
constexpr int kMaxCluster = 8;  // CTAs of the cluster plan (portable)
enum Plan { kCluster = 1, kGrid = 2, kShared = 3 };

struct Colour {
  int x0, y0, z0;               // first active node per axis
  int cnx, cny, cnz;            // active nodes per axis (0: none)
  int64_t off;                  // the colour's planes in the buffer
};

template <class R, class S>
struct SweepArgs {
  Args<R, S> a;                    // a.buf: the whole colour-major buffer
  Colour col[8];
  int nseq;
  signed char seq[kMaxSeq];
};

// One element from global into shared memory: 16-byte elements
// (complex128) bypass L1, 8- and 4-byte ones (complex64 at any element
// offset, float64, float32, a bfloat16 complex) take the sizes
// cp.async.ca allows; cp.async has no 2-byte copy, so a bfloat16 weight
// is a plain load and store (ordered by the barrier after the copies).
template <class T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 16 || sizeof(T) == 8 || sizeof(T) == 4 ||
                    sizeof(T) == 2,
                "elements of 2, 4, 8 or 16 bytes");
  if constexpr (sizeof(T) == 2) {
    *smem = *gmem;
  } else {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (sizeof(T) == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(gmem));
    } else if constexpr (sizeof(T) == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(gmem));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(gmem));
    }
  }
}

// Sizes of a level's tensors in elements and their element bytes: e (3),
// s (3), η sums (3), factors (K1 only; complex), ζ weights (3) and
// inverse widths (3) (real).  The resident plan stacks them in shared
// memory by element size, largest first (in this order within a size):
// every tensor then starts aligned to its element, with no padding.  In
// complex128 and complex64 that is the order above.
template <class R, class S>
struct Sizes {
  int64_t n[16];
  int esz[16];
  __host__ __device__ Sizes(int nx, int ny, int nz, bool factored) {
    const int64_t x = nx, y = ny, z = nz;
    const int64_t e[3] = {x * (y + 1) * (z + 1), (x + 1) * y * (z + 1),
                          (x + 1) * (y + 1) * z};
    for (int c = 0; c < 3; ++c) n[c] = n[3 + c] = e[c];
    n[6] = x * (y - 1) * (z - 1);
    n[7] = (x - 1) * y * (z - 1);
    n[8] = (x - 1) * (y - 1) * z;
    n[9] = factored ? 20 * (x - 1) * (y - 1) * (z - 1) : 0;
    n[10] = (x + 1) * y * z;
    n[11] = x * (y + 1) * z;
    n[12] = x * y * (z + 1);
    n[13] = x;
    n[14] = y;
    n[15] = z;
    using St = Store<R, S>;
    for (int c = 0; c < 16; ++c) {
      esz[c] = static_cast<int>(
          c < 3 || c == 9 ? sizeof(cplx_t<R>)
          : c < 9         ? sizeof(typename St::cplx)
          : c < 13        ? sizeof(typename St::real)
                          : sizeof(R));
    }
  }
  __host__ __device__ int64_t bytes() const {
    int64_t b = 0;
    for (int c = 0; c < 16; ++c) b += n[c] * esz[c];
    return b;
  }
};

// Copy ``n`` elements of ``bytes`` bytes each into shared memory.
__device__ __forceinline__ void copy_in(unsigned char* dst, const void* src,
                                        int64_t n, int bytes) {
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    switch (bytes) {
      case 16:
        cp_async(reinterpret_cast<uint4*>(dst) + i,
                 static_cast<const uint4*>(src) + i);
        break;
      case 8:
        cp_async(reinterpret_cast<uint2*>(dst) + i,
                 static_cast<const uint2*>(src) + i);
        break;
      case 4:
        cp_async(reinterpret_cast<unsigned*>(dst) + i,
                 static_cast<const unsigned*>(src) + i);
        break;
      default:
        cp_async(reinterpret_cast<unsigned short*>(dst) + i,
                 static_cast<const unsigned short*>(src) + i);
    }
  }
}

template <int kPlan>
__device__ __forceinline__ void step_barrier() {
  if constexpr (kPlan == kCluster) {
    cg::this_cluster().sync();
  } else if constexpr (kPlan == kGrid) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

template <int kPlan, int kKernel, class R, class S>
__global__ void __launch_bounds__(kThreads)
point_gs_sweep(const __grid_constant__ SweepArgs<R, S> sa) {
  static_assert(kPlan != kShared || kKernel != kFusedPacked,
                "the shared plan reads st and w from shared memory");
  using A = Args<R, S>;
  using C = cplx_t<R>;
  using SC = typename A::SC;
  using SR = typename A::SR;
  // Raw bytes: the float and double instances share the symbol.
  extern __shared__ __align__(16) unsigned char smem[];
  A a = sa.a;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const Sizes<R, S> sz(a.nx, a.ny, a.nz, kKernel == kFactored);
  if constexpr (kPlan == kShared) {
    // The whole level resident: copy e, s, the η sums, the factors (K1),
    // the ζ weights and the inverse widths in once, largest elements
    // first; from here on the steps address shared memory through the
    // same accessors (generic pointers), so the arithmetic is that of
    // every other plan.
    const void* src[16] = {sa.a.ex, sa.a.ey, sa.a.ez, sa.a.sx, sa.a.sy,
                           sa.a.sz, sa.a.stx, sa.a.sty, sa.a.stz, sa.a.buf,
                           sa.a.wx, sa.a.wy, sa.a.wz, sa.a.ihx, sa.a.ihy,
                           sa.a.ihz};
    void* base[16];
    unsigned char* dst = smem;
    for (int bytes = 16; bytes >= 2; bytes /= 2) {
      for (int c = 0; c < 16; ++c) {
        if (sz.esz[c] != bytes) continue;
        base[c] = dst;
        copy_in(dst, src[c], sz.n[c], bytes);
        dst += sz.n[c] * bytes;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    a.ex = static_cast<C*>(base[0]);
    a.ey = static_cast<C*>(base[1]);
    a.ez = static_cast<C*>(base[2]);
    a.sx = static_cast<const SC*>(base[3]);
    a.sy = static_cast<const SC*>(base[4]);
    a.sz = static_cast<const SC*>(base[5]);
    a.stx = static_cast<const SC*>(base[6]);
    a.sty = static_cast<const SC*>(base[7]);
    a.stz = static_cast<const SC*>(base[8]);
    a.buf = static_cast<const C*>(base[9]);
    a.wx = static_cast<const SR*>(base[10]);
    a.wy = static_cast<const SR*>(base[11]);
    a.wz = static_cast<const SR*>(base[12]);
    a.ihx = static_cast<const R*>(base[13]);
    a.ihy = static_cast<const R*>(base[14]);
    a.ihz = static_cast<const R*>(base[15]);
  }
  for (int s = 0; s < sa.nseq; ++s) {
    const Colour c = sa.col[sa.seq[s]];
    const int64_t n = static_cast<int64_t>(c.cnx) * c.cny * c.cnz;
    if (n == 0) continue;           // the same for every thread
    const C* buf = a.buf + c.off;
    for (int64_t tid = t0; tid < n; tid += stride) {
      node_update<kKernel>(a, buf, n, tid, c.x0, c.y0, c.z0, c.cny, c.cnz);
    }
    if (s + 1 < sa.nseq) step_barrier<kPlan>();
  }
  if constexpr (kPlan == kShared) {
    __syncthreads();
    C* out[3] = {sa.a.ex, sa.a.ey, sa.a.ez};
    const C* in[3] = {a.ex, a.ey, a.ez};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      for (int64_t i = threadIdx.x; i < sz.n[c]; i += blockDim.x) {
        out[c][i] = in[c][i];
      }
    }
  }
}

template <class R, class S>
Args<R, S> make_args(void* ex, void* ey, void* ez, const void* sx,
                     const void* sy, const void* sz, const void* stx,
                     const void* sty, const void* stz, const void* wx,
                     const void* wy, const void* wz, const void* ihx,
                     const void* ihy, const void* ihz, const void* buf,
                     int nx, int ny, int nz) {
  using A = Args<R, S>;
  using C = cplx_t<R>;
  using SC = typename A::SC;
  using SR = typename A::SR;
  A a;
  a.ex = static_cast<C*>(ex);
  a.ey = static_cast<C*>(ey);
  a.ez = static_cast<C*>(ez);
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
  a.buf = static_cast<const C*>(buf);
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.x0 = a.y0 = a.z0 = 0;
  a.cnx = a.cny = a.cnz = 0;
  return a;
}

bool valid_kernel(int kernel) {
  return kernel == kFactored || kernel == kFused || kernel == kFusedPacked;
}

// Blocks of the grid plan of ``kKernel`` that the card holds
// co-resident at ``threads`` threads per block (the kernels differ in
// registers).
template <int kKernel, class R, class S>
int grid_capacity(int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, point_gs_sweep<kGrid, kKernel, R, S>, threads, 0);
  }
  *blocks = sms * per_sm;
  return static_cast<int>(err);
}

template <class R, class S>
int grid_capacity(int kernel, int threads, int* blocks) {
  switch (kernel) {
    case kFactored: return grid_capacity<kFactored, R, S>(threads, blocks);
    case kFused: return grid_capacity<kFused, R, S>(threads, blocks);
    default: return grid_capacity<kFusedPacked, R, S>(threads, blocks);
  }
}

template <int kKernel, class R, class S>
cudaError_t launch_sweep(int plan, const SweepArgs<R, S>& sa, int blocks,
                         int threads, int smem, cudaStream_t s) {
  if (plan == kCluster) {
    if (blocks > kMaxCluster || smem != 0) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, point_gs_sweep<kCluster, kKernel, R, S>,
                              sa);
  }
  if (plan == kGrid) {
    if (smem != 0) return cudaErrorInvalidValue;
    int cap = 0;
    cudaError_t err = static_cast<cudaError_t>(
        grid_capacity<kKernel, R, S>(threads, &cap));
    if (err != cudaSuccess) return err;
    if (blocks > cap) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {const_cast<SweepArgs<R, S>*>(&sa)};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(point_gs_sweep<kGrid, kKernel, R, S>),
        dim3(blocks, 1, 1), dim3(threads, 1, 1), args, 0, s);
  }
  if constexpr (kKernel != kFusedPacked) {
    if (plan == kShared) {
      const Sizes<R, S> sz(sa.a.nx, sa.a.ny, sa.a.nz, kKernel == kFactored);
      if (blocks != 1 || smem != sz.bytes()) return cudaErrorInvalidValue;
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            point_gs_sweep<kShared, kKernel, R, S>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
      }
      point_gs_sweep<kShared, kKernel, R, S><<<1, threads, smem, s>>>(sa);
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

template <class R, class S>
int step(int kernel, void* ex, void* ey, void* ez, const void* sx,
         const void* sy, const void* sz, const void* stx, const void* sty,
         const void* stz, const void* wx, const void* wy, const void* wz,
         const void* ihx, const void* ihy, const void* ihz, const void* buf,
         int nx, int ny, int nz, int x0, int y0, int z0, int cnx, int cny,
         int cnz, int blocks, int threads, void* stream) {
  if (threads > kThreads || !valid_kernel(kernel)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<R, S> a = make_args<R, S>(ex, ey, ez, sx, sy, sz, stx, sty, stz, wx,
                                 wy, wz, ihx, ihy, ihz, buf, nx, ny, nz);
  a.x0 = x0;
  a.y0 = y0;
  a.z0 = z0;
  a.cnx = cnx;
  a.cny = cny;
  a.cnz = cnz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == kFactored) {
    point_gs_step<kFactored, R, S><<<blocks, threads, 0, s>>>(a);
  } else if (kernel == kFused) {
    point_gs_step<kFused, R, S><<<blocks, threads, 0, s>>>(a);
  } else {
    point_gs_step<kFusedPacked, R, S><<<blocks, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class R, class S>
int sweep(int plan, int kernel, void* ex, void* ey, void* ez,
          const void* sx, const void* sy, const void* sz, const void* stx,
          const void* sty, const void* stz, const void* wx, const void* wy,
          const void* wz, const void* ihx, const void* ihy, const void* ihz,
          const void* buf, int nx, int ny, int nz, const int* geom,
          const long long* offs, const int* seq, int nseq, int blocks,
          int threads, int smem, void* stream) {
  if (nseq < 1 || nseq > kMaxSeq || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || blocks < 1 || !valid_kernel(kernel)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SweepArgs<R, S> sa;
  sa.a = make_args<R, S>(ex, ey, ez, sx, sy, sz, stx, sty, stz, wx, wy, wz,
                         ihx, ihy, ihz, buf, nx, ny, nz);
  for (int c = 0; c < 8; ++c) {
    sa.col[c] = Colour{geom[6 * c], geom[6 * c + 1], geom[6 * c + 2],
                       geom[6 * c + 3], geom[6 * c + 4], geom[6 * c + 5],
                       static_cast<int64_t>(offs[c])};
  }
  sa.nseq = nseq;
  for (int n = 0; n < kMaxSeq; ++n) {
    if (n < nseq && (seq[n] < 0 || seq[n] > 7)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sa.seq[n] = static_cast<signed char>(n < nseq ? seq[n] : 0);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kernel == kFactored) {
    err = launch_sweep<kFactored, R, S>(plan, sa, blocks, threads, smem, s);
  } else if (kernel == kFused) {
    err = launch_sweep<kFused, R, S>(plan, sa, blocks, threads, smem, s);
  } else {
    err = launch_sweep<kFusedPacked, R, S>(plan, sa, blocks, threads, smem,
                                           s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes by emg3d_tpu_torch/ops/point_gs.py.
// Each launches on ``stream`` and returns a cudaError_t as int (0 on
// success): cudaGetLastError() after the launch, or the error of a
// launch the card refuses.  The launch geometry comes from the Python
// plan functions.  ``kernel`` is 0 (K1, ``buf`` its factors), 1 (K2
// reading st and w) or 2 (K2, ``buf`` its packed node data).  Every
// entry point takes complex128 tensors (float64 weights and widths);
// its ``_c64`` twin the same in complex64 (float32), and its ``_bf16``
// twin complex64 with s, st (each complex value two bfloat16, re and
// im) and w (bfloat16) stored in bfloat16.

#define EMG3D_STEP_PARAMS                                                   \
  int kernel, void *ex, void *ey, void *ez, const void *sx, const void *sy, \
      const void *sz, const void *stx, const void *sty, const void *stz,   \
      const void *wx, const void *wy, const void *wz, const void *ihx,     \
      const void *ihy, const void *ihz, const void *buf, int nx, int ny,   \
      int nz, int x0, int y0, int z0, int cnx, int cny, int cnz,           \
      int blocks, int threads, void *stream
#define EMG3D_STEP_ARGS                                                     \
  kernel, ex, ey, ez, sx, sy, sz, stx, sty, stz, wx, wy, wz, ihx, ihy, ihz, \
      buf, nx, ny, nz, x0, y0, z0, cnx, cny, cnz, blocks, threads, stream

// One colour step (the ``step`` plan).  ``buf`` points at the colour's
// planes of the colour-major buffer; the caller skips colours without
// nodes.
extern "C" int emg3d_point_gs_step(EMG3D_STEP_PARAMS) {
  return step<double, double>(EMG3D_STEP_ARGS);
}
extern "C" int emg3d_point_gs_step_c64(EMG3D_STEP_PARAMS) {
  return step<float, float>(EMG3D_STEP_ARGS);
}
extern "C" int emg3d_point_gs_step_bf16(EMG3D_STEP_PARAMS) {
  return step<float, __nv_bfloat16>(EMG3D_STEP_ARGS);
}

// Blocks of ``kernel``'s grid plan that the card holds co-resident at
// its largest blocks (kThreads threads).
extern "C" int emg3d_point_gs_grid_capacity(int kernel, int* blocks) {
  if (!valid_kernel(kernel)) return static_cast<int>(cudaErrorInvalidValue);
  return grid_capacity<double, double>(kernel, kThreads, blocks);
}
extern "C" int emg3d_point_gs_grid_capacity_c64(int kernel, int* blocks) {
  if (!valid_kernel(kernel)) return static_cast<int>(cudaErrorInvalidValue);
  return grid_capacity<float, float>(kernel, kThreads, blocks);
}
extern "C" int emg3d_point_gs_grid_capacity_bf16(int kernel, int* blocks) {
  if (!valid_kernel(kernel)) return static_cast<int>(cudaErrorInvalidValue);
  return grid_capacity<float, __nv_bfloat16>(kernel, kThreads, blocks);
}

#define EMG3D_SWEEP_PARAMS                                                   \
  int plan, int kernel, void *ex, void *ey, void *ez, const void *sx,        \
      const void *sy, const void *sz, const void *stx, const void *sty,      \
      const void *stz, const void *wx, const void *wy, const void *wz,       \
      const void *ihx, const void *ihy, const void *ihz, const void *buf,    \
      int nx, int ny, int nz, const int *geom, const long long *offs,        \
      const int *seq, int nseq, int blocks, int threads, int smem,           \
      void *stream
#define EMG3D_SWEEP_ARGS                                                     \
  plan, kernel, ex, ey, ez, sx, sy, sz, stx, sty, stz, wx, wy, wz, ihx, ihy, \
      ihz, buf, nx, ny, nz, geom, offs, seq, nseq, blocks, threads, smem,    \
      stream

// The whole colour sequence ``seq[0..nseq)`` of a smoothing call in one
// launch (the cluster, grid and shared plans).  ``geom`` holds per
// colour x0, y0, z0, cnx, cny, cnz; ``offs`` its offset in ``buf``.  A
// plan the card cannot run is refused, never replaced: a cluster beyond
// kMaxCluster CTAs, a grid beyond the co-resident blocks, shared memory
// beyond the block's, the shared plan of packed K2.
extern "C" int emg3d_point_gs_sweep(EMG3D_SWEEP_PARAMS) {
  return sweep<double, double>(EMG3D_SWEEP_ARGS);
}
extern "C" int emg3d_point_gs_sweep_c64(EMG3D_SWEEP_PARAMS) {
  return sweep<float, float>(EMG3D_SWEEP_ARGS);
}
extern "C" int emg3d_point_gs_sweep_bf16(EMG3D_SWEEP_PARAMS) {
  return sweep<float, __nv_bfloat16>(EMG3D_SWEEP_ARGS);
}
