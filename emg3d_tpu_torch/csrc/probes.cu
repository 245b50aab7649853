// Hopper counterparts of the JAX package's Mosaic probe kernels, fp32.
//
// The probes in scripts/ are Pallas kernels that found which on-chip
// copies, layouts and scratch sizes Mosaic would lower for the 256³
// line kernels.  Here each probe family is one small kernel that does
// the same work on this card, held bitwise (or to 1e-6) against its
// plain PyTorch version in ops/probes.py:
//
//   tile_copy    <- hw_probe_ztile.py: probe (46), probe3 (95), probe23
//       (134), probe12 (174).  Copy +1 of a sub-box of a 4-D fp32
//       array, in place, at dynamic offsets along any of its dims, in
//       and out of shared memory.  pltpu.make_async_copy with a DMA
//       semaphore becomes the Tensor Memory Accelerator with mbarriers:
//       the sub-box is cut into TMA boxes (a CUtensorMap built on the
//       host), and each of a grid of persistent blocks, sized to the
//       SMs, streams its run of boxes through a ring of 2-3 box buffers:
//       one thread keeps the loads of the next stages in flight while
//       the block adds 1 to the current box (float4 over its 16-byte
//       rows), fences the shared writes to the async proxy and stores
//       it back with one more bulk tensor copy; a stage is refilled
//       once its store has read it.  The map's extents end at the
//       sub-box's end, so the hardware drops the part of a box beyond
//       it along x and y.  Along z (the contiguous dim) a box starts
//       and the map ends on 16 bytes: boxes at z offsets of 13 floats
//       (the map ending off 16 bytes too) raised an illegal instruction
//       on the card, so the boxes span the sub-box rounded out to 16
//       bytes, in equal z boxes that end at the map's end, and only the
//       sub-box's own elements get +1 (the others go back as they came;
//       boxes of one launch never overlap).  Offsets along the other
//       dims need no alignment.
//   smem_limit   <- hw_probe_ztile.py: probe_vmem (209).  The probe
//       declares a (rows, 512) fp32 VMEM scratch of a given size, copies
//       x's first 8 rows into it with make_async_copy and a DMA
//       semaphore, adds 1 to its row 0 and copies the 8 rows back onto
//       x (in place): x[0] += 1 through on-chip scratch of that size.
//       Mosaic's question was the scoped-VMEM limit; the card's is the
//       dynamic shared memory a block may opt in to (232 448 bytes on an
//       H100).  ``smem_stage`` declares N bytes of it and stages the 8
//       rows (16 KB) through the buffer's top with 1-D bulk async copies
//       (cp.async.bulk) that complete on mbarriers at the buffer's
//       start, so a size the card admitted but did not back faults; the
//       block's 128 threads add 1 to row 0 (a float4 each), fence the
//       writes to the async proxy, and the rows go back by bulk copies
//       (one of 16 KB, or one a row issued by eight threads).  No static
//       shared memory: it would count toward the opt-in.  The host sets
//       cudaFuncAttributeMaxDynamicSharedMemorySize to N first and
//       returns the launch's cudaGetLastError, so a size beyond the
//       limit reads as the card's refusal, with x untouched.
//   smem_sum     <- hw_bisect_zp256.py fbuf5d (49): the sum over
//       chx stations of one plane of a (nx, NF, ty, Zp) array, which the
//       Pallas probe copied whole into a 5-D VMEM buffer.  Here only the
//       plane moves: a 3-D CUtensorMap over f[:chx, plane] (z, y,
//       stations) cuts it into TMA boxes of (bz, by, bc) floats, and
//       persistent blocks, at most two an SM, stream their run of boxes
//       through a ring of 2-3 stages (an mbarrier each).  Each thread
//       sums one float4 of a box over its stations in station order
//       (bitwise the plain version's order) and stores it straight to
//       the output; more than 256 stations (TMA's box limit) go in
//       chunks, in order, into the same sums.  Boxes past the map's end
//       in y or z are zero-filled by the TMA and their stores masked.
//   tile_roll    <- hw_bisect_zp256.py rolllane/rollsub (65): roll a
//       (ty, Zp) tile along either axis.  pltpu.roll is a lane rotation
//       of the TPU's vregs; here it is a gather through L1 (the rolled
//       read of a warp's 32 consecutive outputs touches at most two
//       128-byte segments of the row), one kernel for both axes.
//   dyn_slice    <- hw_bisect_zp256.py dynslice, dynslice_al, _al12
//       (84, 108): a dim-2 slice of a 4-D array at offsets read on the
//       card (Pallas' scalar prefetch), through shared memory.
//   station_solve <- hw_bisect_zp256.py station (136): the 5×5 complex
//       LDLᵀ substitution of blocksolve.ldl_solve_factored on (ty, Zp)
//       tiles.  No byte is used twice, so nothing is staged: four
//       points a thread with 16-byte streaming loads and stores where
//       the point count allows (one otherwise), every load issued
//       before the arithmetic, so each thread keeps 640 bytes in
//       flight.  The kernel walks the points grid-stride; the default
//       plan (ops/probes.py ``station_plan``) gives each thread one
//       group, so the card starts the blocks in order as others end,
//       which read faster than a grid sized to the SMs sweeping them.
//
// Bounds: each probe moves each input byte once and writes each output
// once (tile_copy 8 B per element of the box, dyn_slice 8 B per element
// of the slice, smem_sum the plane's chx·ty·Zp floats in and ty·Zp out,
// station_solve 200 B a point); none does enough arithmetic to be bound
// by it.  smem_limit moves 2 × 16 KB of device memory whatever N is, so
// one SM's shared-memory traffic bounds it (the staged rows written and
// read, row 0 read and written).  The
// 128³ bisection (hw_bisect_lr128.py) needs no probe here: K3 and K4
// run at 128³ in chip_smoke.py's phase 3b, each alone.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------
// tile_copy: a persistent block streams its run of TMA boxes through a
// ring of stages: box in, +1, box out.
// ---------------------------------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kMaxStages = 4;

// The box plan (ops/probes.py ``tile_plan``): the first box's corner,
// the sub-box's own z range, boxes along each dim (z fastest), the box
// extents, the box count and the ring's stages.
struct TileBoxes {
  int o0, o1, o2, a3;
  int lo3, hi3;
  int n1, n2, n3;
  int b0, b1, b2, b3;
  int boxes, stages;
};

// Box t's corner (x, y, z rows and z) in the map's coordinates.
__device__ __forceinline__ void box_corner(const TileBoxes& p, int t,
                                           int c[4]) {
  const int t3 = t % p.n3;
  t /= p.n3;
  const int t2 = t % p.n2;
  t /= p.n2;
  const int t1 = t % p.n1;
  const int t0 = t / p.n1;
  c[0] = p.o0 + t0 * p.b0;
  c[1] = p.o1 + t1 * p.b1;
  c[2] = p.o2 + t2 * p.b2;
  c[3] = p.a3 + t3 * p.b3;
}

// Thread 0: the bulk tensor load of the box at ``c`` into ``dst``,
// completing ``bytes`` on the stage's mbarrier.
__device__ __forceinline__ void box_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t mb, const int c[4],
                                         uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c[3]), "r"(c[2]), "r"(c[1]),
      "r"(c[0]), "r"(mb)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t mb, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mb), "r"(parity)
        : "memory");
  }
}

// Block b moves boxes b, b + G, b + 2G, ... (G = gridDim.x).  Thread 0
// keeps the loads of the next stages in flight; every thread adds 1 to
// the current box as float4 (16-byte rows), masking z only in a box
// that reaches outside the sub-box's z range; thread 0 then stores it
// and refills the stage of the box before, once that box's store has
// read it (wait_group.read 1: only the newest store may still read).
__global__ void __launch_bounds__(kTileThreads, 2)
tile_copy(const __grid_constant__ CUtensorMap map, const TileBoxes p,
          int stage_floats) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  // TMA writes boxes to 128-byte aligned shared addresses.
  float* ring = reinterpret_cast<float*>(
      raw + ((128 - (smem_u32(raw) & 127)) & 127));
  const int quads = p.b0 * p.b1 * p.b2 * p.b3 / 4;
  const uint32_t bytes = static_cast<uint32_t>(quads) * 16;
  const int first = blockIdx.x, step = gridDim.x;
  const int mine = first < p.boxes ? (p.boxes - first + step - 1) / step : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_u32(&full[s])));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int c[4];
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.stages && k < mine; ++k) {
      box_corner(p, first + k * step, c);
      box_load(&map, smem_u32(ring + k * stage_floats), smem_u32(&full[k]),
               c, bytes);
    }
  }
  // A thread's quads sit kTileThreads apart: its z quad within the row
  // advances by dq (mod the row's Q quads) with no division.
  const int Q = p.b3 / 4, dq = kTileThreads % Q;
  const int q0 = threadIdx.x % Q;
  for (int k = 0; k < mine; ++k) {
    const int s = k % p.stages;
    box_corner(p, first + k * step, c);
    mbar_wait(smem_u32(&full[s]), (k / p.stages) & 1);
    float4* box = reinterpret_cast<float4*>(ring + s * stage_floats);
    if (c[3] >= p.lo3 && c[3] + p.b3 <= p.hi3) {
      for (int i = threadIdx.x; i < quads; i += kTileThreads) {
        float4 v = box[i];
        v.x += 1.0f;
        v.y += 1.0f;
        v.z += 1.0f;
        v.w += 1.0f;
        box[i] = v;
      }
    } else {
      // Only the sub-box's own elements; the others go back as they
      // came (no +0: it would turn -0 into +0).
      int q = q0;
      for (int i = threadIdx.x; i < quads; i += kTileThreads) {
        const int z = c[3] + 4 * q;
        float4 v = box[i];
        if (z >= p.lo3 && z < p.hi3) v.x += 1.0f;
        if (z + 1 >= p.lo3 && z + 1 < p.hi3) v.y += 1.0f;
        if (z + 2 >= p.lo3 && z + 2 < p.hi3) v.z += 1.0f;
        if (z + 3 >= p.lo3 && z + 3 < p.hi3) v.w += 1.0f;
        box[i] = v;
        q += dq;
        if (q >= Q) q -= Q;
      }
    }
    // The generic-proxy writes above, visible to the bulk copy below.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
          "[%0, {%1, %2, %3, %4}], [%5];" ::"l"(
              reinterpret_cast<uint64_t>(&map)),
          "r"(c[3]), "r"(c[2]), "r"(c[1]), "r"(c[0]),
          "r"(smem_u32(box))
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      const int next = k - 1 + p.stages;   // into the stage of box k − 1
      if (k >= 1 && next < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        const int sp = (k - 1) % p.stages;
        box_corner(p, first + next * step, c);
        box_load(&map, smem_u32(ring + sp * stage_floats),
                 smem_u32(&full[sp]), c, bytes);
      }
    }
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// ---------------------------------------------------------------------
// smem_limit: x[0] += 1 through staged rows at the top of N bytes of
// dynamic shared memory.
// ---------------------------------------------------------------------

constexpr int kStageThreads = 128;   // a warpgroup: one float4 of row 0 each
constexpr int kStageRows = 8;        // the probe's staged rows of x
constexpr int kStageBytes = kStageRows * 512 * 4;
// Returned by the C entry when the kernel was built with static shared
// memory (it would count toward the opt-in the probe measures).
constexpr int kStaticSmem = 2000;

// Thread 0: a 1-D bulk copy of ``bytes`` (16-byte aligned, a multiple of
// 16) from global ``src`` to shared ``dst``, completing on mbarrier
// ``mb``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t mb) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))), "r"(bytes),
      "r"(mb)
      : "memory");
}

// Thread 0: the bulk copy back, shared ``src`` to global ``dst``, in the
// open bulk group.
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          static_cast<uint64_t>(__cvta_generic_to_global(dst))),
      "r"(src), "r"(bytes)
      : "memory");
}

// The buffer holds ``pieces`` mbarriers at its start and the 8 staged
// rows at byte ``offset`` (128-aligned, the buffer's top 16 KB).  Piece
// p (1: all 16 KB; 8: row p) is thread p's: it inits mbarrier p, issues
// the piece's bulk load onto it and, after the add, its bulk store, so
// the pieces travel in parallel.  Every thread waits for piece 0 (it
// holds row 0), adds 1 to its float4 of row 0, fences the generic-proxy
// writes to the async proxy and meets the others; thread p then waits
// for its piece (rows 1-7 were written and are read by the async proxy
// alone: their mbarrier orders them), stores it and waits for the store
// before the block ends.
__global__ void __launch_bounds__(kStageThreads)
smem_stage(float* x, int offset, int pieces) {
  extern __shared__ __align__(16) unsigned char buf[];
  const int p = threadIdx.x;
  const uint32_t bars = smem_u32(buf);
  const uint32_t bytes = kStageBytes / pieces;
  const uint32_t bar = bars + 8 * p, rows = bars + offset + p * bytes;
  float* const piece = x + p * (bytes / 4);
  if (p < pieces) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (p < pieces) bulk_load(rows, piece, bytes, bar);
  mbar_wait(bars, 0);
  float4* row0 = reinterpret_cast<float4*>(buf + offset);
  float4 v = row0[threadIdx.x];
  v.x += 1.0f;
  v.y += 1.0f;
  v.z += 1.0f;
  v.w += 1.0f;
  row0[threadIdx.x] = v;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (p < pieces) {
    if (p > 0) mbar_wait(bar, 0);
    bulk_store(piece, rows, bytes);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// ---------------------------------------------------------------------
// smem_sum: persistent blocks stream TMA boxes of f[:chx, plane] and sum
// each over its stations.
// ---------------------------------------------------------------------

constexpr int kSumThreads = 128;   // a box holds ≤ 4 · kSumThreads outputs

// The box plan (ops/probes.py ``sum_plan``): box extents (z, y,
// stations), boxes along z, station chunks, output tiles (nz · ny), the
// ring's stages and the sum's extents.
struct SumBoxes {
  int bz, by, bc;
  int nz, nc, tiles, stages;
  int chx, ty, zp;
};

// Thread 0: the bulk tensor load of the 3-D box at (z, y, c) into
// ``dst``, completing ``bytes`` on the stage's mbarrier.
__device__ __forceinline__ void box_load3(const CUtensorMap* map,
                                          uint32_t dst, uint32_t mb, int z,
                                          int y, int c, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(z), "r"(y), "r"(c), "r"(mb)
      : "memory");
}

// Load k of a block: output tile first + (k / nc)·G (z fastest), station
// chunk k % nc; its corner in the map's coordinates.
__device__ __forceinline__ void sum_corner(const SumBoxes& p, int first,
                                           int step, int k, int& z, int& y,
                                           int& c) {
  const int t = first + (k / p.nc) * step;
  z = (t % p.nz) * p.bz;
  y = (t / p.nz) * p.by;
  c = (k % p.nc) * p.bc;
}

// Block b sums tiles b, b + G, ... (G = gridDim.x), each from its nc
// chunk boxes in station order.  Thread 0 keeps the next stages' loads
// in flight; thread i owns the float4 i of every box (row i / (bz/4)),
// adds it over the box's stations into its registers and, after the
// tile's last chunk, stores it.  A stage is refilled once every thread
// has read it (__syncthreads).
__global__ void __launch_bounds__(kSumThreads, 2)
smem_sum(float* __restrict__ out, const __grid_constant__ CUtensorMap map,
         const SumBoxes p, int stage_floats) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  float* ring = reinterpret_cast<float*>(
      raw + ((128 - (smem_u32(raw) & 127)) & 127));
  const uint32_t bytes = static_cast<uint32_t>(p.bz * p.by * p.bc) * 4;
  const int first = blockIdx.x, step = gridDim.x;
  const int mine =
      (first < p.tiles ? (p.tiles - first + step - 1) / step : 0) * p.nc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_u32(&full[s])));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int z, y, c;
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.stages && k < mine; ++k) {
      sum_corner(p, first, step, k, z, y, c);
      box_load3(&map, smem_u32(ring + k * stage_floats), smem_u32(&full[k]),
                z, y, c, bytes);
    }
  }
  const int Q = p.bz / 4, plane = p.by * Q;   // float4s: a row, a station
  const bool owner = threadIdx.x < plane;
  const int row = threadIdx.x / Q, q = threadIdx.x % Q;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < mine; ++k) {
    const int s = k % p.stages;
    sum_corner(p, first, step, k, z, y, c);
    mbar_wait(smem_u32(&full[s]), (k / p.stages) & 1);
    if (owner) {
      if (c == 0) acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4* box =
          reinterpret_cast<const float4*>(ring + s * stage_floats) +
          threadIdx.x;
      const int n = min(p.bc, p.chx - c);
      for (int i = 0; i < n; ++i) {
        const float4 v = box[i * plane];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      const int yy = y + row, zz = z + 4 * q;
      if (c + p.bc >= p.chx && yy < p.ty && zz < p.zp) {
        *reinterpret_cast<float4*>(out + static_cast<size_t>(yy) * p.zp +
                                   zz) = acc;
      }
    }
    __syncthreads();   // stage s read by every thread: refill it
    if (threadIdx.x == 0 && k + p.stages < mine) {
      sum_corner(p, first, step, k + p.stages, z, y, c);
      box_load3(&map, smem_u32(ring + s * stage_floats), smem_u32(&full[s]),
                z, y, c, bytes);
    }
  }
}

// ---------------------------------------------------------------------
// tile_roll: torch.roll of a (rows, cols) tile as a rolled gather.
// ---------------------------------------------------------------------

constexpr int kRollThreads = 256;   // each thread writes 4 outputs

// out[r, c] = x[(r − sr) mod rows, (c − sc) mod cols], shifts in
// [0, rows) and [0, cols); n = rows·cols < 2³¹ − 3.  Thread t writes the
// four consecutive outputs 4t .. 4t + 3 of the flat tile with one
// 16-byte store (a warp: 512 contiguous bytes) from four loads that
// are consecutive but at a row's one wrap point.
__global__ void __launch_bounds__(kRollThreads)
tile_roll(float* __restrict__ out, const float* __restrict__ x, int rows,
          int cols, int n, int sr, int sc) {
  const int i = (blockIdx.x * kRollThreads + threadIdx.x) * 4;
  if (i >= n) return;
  int r = i / cols, c = i - r * cols;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i + k < n) {
      const int rs = r >= sr ? r - sr : r - sr + rows;
      const int cs = c >= sc ? c - sc : c - sc + cols;
      v[k] = x[rs * cols + cs];
    }
    if (++c == cols) {
      c = 0;
      ++r;
    }
  }
  if (i + 4 <= n) {
    *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; i + k < n; ++k) out[i + k] = v[k];
  }
}

// ---------------------------------------------------------------------
// dyn_slice: out[t] = x[:, :, y0[t]:y0[t]+ty] (y0 clamped into range).
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(256)
dyn_slice(float* out, const float* x, const int* y0, int planes, int ny,
          int ty, int zp) {
  extern __shared__ __align__(16) float slab[];   // [ty][zp]
  const int p = blockIdx.x, t = blockIdx.y;
  const int y = min(max(y0[t], 0), ny - ty);
  const float* src = x + (static_cast<size_t>(p) * ny + y) * zp;
  const int chunks = ty * zp / 4;                 // 16-byte copies
  for (int c = threadIdx.x; c < chunks; c += 256) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(slab + 4 * c)),
                 "l"(src + 4 * c)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(t) * planes + p) * ty * zp);
  const float4* from = reinterpret_cast<const float4*>(slab);
  for (int c = threadIdx.x; c < chunks; c += 256) dst[c] = from[c];
}

// ---------------------------------------------------------------------
// station_solve: z = (L D Lᵀ)⁻¹ y per point, complex64 in registers.
// ---------------------------------------------------------------------

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

constexpr int kStationThreads = 128;

// V consecutive points of one plane: one 16-byte (V = 4) or 4-byte
// streaming load or store (read once, written once: evict first).
template <int V>
struct Points;

template <>
struct Points<4> {
  static __device__ __forceinline__ void load(float (&d)[4],
                                              const float* p) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&d)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(d[0], d[1], d[2], d[3]));
  }
};

template <>
struct Points<1> {
  static __device__ __forceinline__ void load(float (&d)[1],
                                              const float* p) {
    d[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&d)[1]) {
    __stcs(p, d[0]);
  }
};

// Thread g of the grid takes the groups g, g + G, ... of V points (G the
// grid's threads; V divides points): its 40 planes' loads first, then
// the substitution per point, then its 10 planes' stores.
template <int V>
__global__ void __launch_bounds__(kStationThreads)
station_solve(float* __restrict__ z, const float* __restrict__ x,
              int points) {
  const int64_t groups = points / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kStationThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kStationThreads +
                   threadIdx.x;
       g < groups; g += stride) {
    const int64_t n = g * V;
    float a[40][V];
#pragma unroll
    for (int p = 0; p < 40; ++p) {
      Points<V>::load(a[p], x + static_cast<int64_t>(p) * points + n);
    }
    float o[10][V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float2 L[10], y[5];
#pragma unroll
      for (int i = 0; i < 10; ++i) {   // (1,0) (2,0) (2,1) (3,0) ...
        L[i] = make_float2(a[2 * i][v], a[2 * i + 1][v]);
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        y[i] = make_float2(a[30 + 2 * i][v], a[31 + 2 * i][v]);
      }
      // Forward: y_i -= L_ik y_k; diagonal; backward: y_i -= L_ki y_k.
#pragma unroll
      for (int i = 1; i < 5; ++i) {
#pragma unroll
        for (int k = 0; k < i; ++k) {
          const float2 t = cmul(L[i * (i - 1) / 2 + k], y[k]);
          y[i] = make_float2(y[i].x - t.x, y[i].y - t.y);
        }
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        y[i] = cmul(y[i], make_float2(a[20 + 2 * i][v], a[21 + 2 * i][v]));
      }
#pragma unroll
      for (int i = 3; i >= 0; --i) {
#pragma unroll
        for (int k = i + 1; k < 5; ++k) {
          const float2 t = cmul(L[k * (k - 1) / 2 + i], y[k]);
          y[i] = make_float2(y[i].x - t.x, y[i].y - t.y);
        }
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        o[2 * i][v] = y[i].x;
        o[2 * i + 1][v] = y[i].y;
      }
    }
#pragma unroll
    for (int p = 0; p < 10; ++p) {
      Points<V>::store(z + static_cast<int64_t>(p) * points + n, o[p]);
    }
  }
}

}  // namespace

// x is a contiguous (d0, d1, d2, d3) fp32 array (d3 a multiple of 4); the
// sub-box starts at (o0..o3) with lengths (l0..l3) and moves in boxes of
// (b0..b3) elements (each ≤ 256), along z over [o3, o3 + l3) rounded out
// to multiples of 4, a span that b3 (a multiple of 4) divides: no box
// reaches past the map's z end.  ``blocks`` persistent blocks take the
// boxes in turn through a ring of ``stages`` box buffers (at least 2
// where a block takes more than one box).  Returns a cudaError_t, or
// 1000 + a CUresult when the tensor map cannot be encoded.
extern "C" int emg3d_probe_tile_copy(void* x, int d0, int d1, int d2,
                                     int d3, int o0, int o1, int o2, int o3,
                                     int l0, int l1, int l2, int l3, int b0,
                                     int b1, int b2, int b3, int stages,
                                     int blocks, void* stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int a3 = o3 & ~3, e3 = min(d3, (o3 + l3 + 3) & ~3);
  if (d3 % 4 != 0 || b3 % 4 != 0 || b0 < 1 || b1 < 1 || b2 < 1 || b3 < 4 ||
      b0 > 256 || b1 > 256 || b2 > 256 || b3 > 256 || o0 < 0 || o1 < 0 ||
      o2 < 0 || o3 < 0 || l0 < 1 || l1 < 1 || l2 < 1 || l3 < 1 ||
      o0 + l0 > d0 || o1 + l1 > d1 || o2 + l2 > d2 || o3 + l3 > d3 ||
      (e3 - a3) % b3 != 0 || stages < 1 || stages > kMaxStages ||
      blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n0 = (l0 + b0 - 1) / b0, n1 = (l1 + b1 - 1) / b1,
                n2 = (l2 + b2 - 1) / b2, n3 = (e3 - a3) / b3;
  const int64_t boxes = n0 * n1 * n2 * n3;
  if (boxes > (int64_t{1} << 31) - 1 || blocks > boxes ||
      (stages < 2 && boxes > blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(e3),
                              static_cast<cuuint64_t>(o2 + l2),
                              static_cast<cuuint64_t>(o1 + l1),
                              static_cast<cuuint64_t>(o0 + l0)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(d3) * 4,
      static_cast<cuuint64_t>(d3) * d2 * 4,
      static_cast<cuuint64_t>(d3) * d2 * d1 * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b3),
                             static_cast<cuuint32_t>(b2),
                             static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b0)};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  // Stages 128-byte aligned (ops/probes.py ``tile_plan`` mirrors it).
  const int stage_floats = (b0 * b1 * b2 * b3 + 31) / 32 * 32;
  const int smem = stages * stage_floats * 4 + 128;
  const cudaError_t e = cudaFuncSetAttribute(
      tile_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const TileBoxes p{o0, o1, o2, a3, o3, o3 + l3,
                    static_cast<int>(n1), static_cast<int>(n2),
                    static_cast<int>(n3), b0, b1, b2, b3,
                    static_cast<int>(boxes), stages};
  tile_copy<<<blocks, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, p, stage_floats);
  return static_cast<int>(cudaGetLastError());
}

// x[0] += 1 of a contiguous (rows, 512) fp32 array (rows >= 8, 16-byte
// aligned), in place, by smem_stage with ``nbytes`` of dynamic shared
// memory in ``pieces`` (1 or 8) bulk copies each way (ops/probes.py
// ``smem_plan`` mirrors the layout).  Sets the kernel's dynamic shared
// memory limit to ``nbytes`` (cudaFuncSetAttribute's error into
// *attr_err), clears the last error and launches with ``nbytes``
// whatever the attribute said: returns the launch's cudaGetLastError,
// cudaSuccess where the card admits the size (a refused launch leaves x
// as it was).  kStaticSmem if the kernel holds static shared memory.
extern "C" int emg3d_probe_smem_limit(void* x, int rows, int nbytes,
                                      int pieces, void* attr_err,
                                      void* stream) {
  static int static_bytes = -1;
  if (static_bytes < 0) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, smem_stage);
    if (e != cudaSuccess) return static_cast<int>(e);
    static_bytes = static_cast<int>(a.sharedSizeBytes);
  }
  if (static_bytes != 0) return kStaticSmem;
  const int offset = (nbytes - kStageBytes) & ~127;
  if (rows < kStageRows || (pieces != 1 && pieces != kStageRows) ||
      nbytes < kStageBytes || offset < 8 * pieces ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *static_cast<int*>(attr_err) = static_cast<int>(cudaFuncSetAttribute(
      smem_stage, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes));
  cudaGetLastError();
  smem_stage<<<1, kStageThreads, nbytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), offset, pieces);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of the current device may opt in to.
extern "C" int emg3d_probe_smem_optin(void* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceGetAttribute(
      static_cast<int*>(bytes), cudaDevAttrMaxSharedMemoryPerBlockOptin,
      dev));
}

// out (ty, zp) = Σ_{i<chx} f[i, plane] of a contiguous (≥chx, nf, ty, zp)
// array, zp a multiple of 4 and f 16-byte aligned, in boxes of (bz, by,
// bc) floats (bz a multiple of 4, each ≤ 256, by·bz ≤ 4·kSumThreads):
// ``blocks`` persistent blocks take the output tiles in turn, each tile's
// ceil(chx / bc) chunk boxes through a ring of ``stages`` box buffers (at
// least 2 where a block takes more than one box).  Returns a
// cudaError_t, or 1000 + a CUresult when the tensor map cannot be
// encoded.
extern "C" int emg3d_probe_smem_sum(void* out, const void* f, int chx,
                                    int nf, int ty, int zp, int plane,
                                    int bz, int by, int bc, int stages,
                                    int blocks, void* stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (zp % 4 != 0 || zp < 4 || ty < 1 || chx < 1 || plane < 0 ||
      plane >= nf || bz % 4 != 0 || bz < 4 || bz > 256 || by < 1 ||
      by > 256 || bc < 1 || bc > 256 || by * bz > 4 * kSumThreads ||
      stages < 1 || stages > kMaxStages || blocks < 1 ||
      reinterpret_cast<uintptr_t>(f) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nz = (zp + bz - 1) / bz, ny = (ty + by - 1) / by,
                nc = (chx + bc - 1) / bc;
  const int64_t tiles = nz * ny;
  // The most loads a block takes.
  const int64_t most = (tiles + blocks - 1) / blocks * nc;
  if (tiles * nc > (int64_t{1} << 31) - 1 || blocks > tiles ||
      (stages < 2 && most > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(zp),
                              static_cast<cuuint64_t>(ty),
                              static_cast<cuuint64_t>(chx)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(zp) * 4,
      static_cast<cuuint64_t>(zp) * ty * nf * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(bz),
                             static_cast<cuuint32_t>(by),
                             static_cast<cuuint32_t>(bc)};
  const cuuint32_t estr[3] = {1, 1, 1};
  const float* base = static_cast<const float*>(f) +
                      static_cast<int64_t>(plane) * ty * zp;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  // Stages 128-byte aligned (ops/probes.py ``sum_plan`` mirrors it).
  const int stage_floats = (bz * by * bc + 31) / 32 * 32;
  const int smem = stages * stage_floats * 4 + 128;
  const cudaError_t e = cudaFuncSetAttribute(
      smem_sum, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const SumBoxes p{bz, by, bc, static_cast<int>(nz), static_cast<int>(nc),
                   static_cast<int>(tiles), stages, chx, ty, zp};
  smem_sum<<<blocks, kSumThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), map, p, stage_floats);
  return static_cast<int>(cudaGetLastError());
}

// out = torch.roll(x, shift, axis) of a contiguous (rows, cols) tile of
// any shape with rows·cols < 2³¹ − 3: ``shift`` reduced on the host into
// [0, rows) (axis 0) or [0, cols) (axis 1); ``out`` 16-byte aligned.
extern "C" int emg3d_probe_tile_roll(void* out, const void* x, int rows,
                                     int cols, int shift, int axis,
                                     void* stream) {
  const int64_t n = static_cast<int64_t>(rows) * cols;
  const int len = axis == 0 ? rows : cols;
  if (rows < 1 || cols < 1 || (axis != 0 && axis != 1) ||
      n > (int64_t{1} << 31) - 4 || shift < 0 || shift >= len ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = 4 * kRollThreads;
  tile_roll<<<static_cast<int>((n + per_block - 1) / per_block),
              kRollThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(x), rows, cols,
      static_cast<int>(n), axis == 0 ? shift : 0, axis == 1 ? shift : 0);
  return static_cast<int>(cudaGetLastError());
}

// out (slices, planes, ty, zp) from a contiguous (planes, ny, zp) view of
// x, at the slices' first rows y0 (int32 on the card); zp·4 a multiple
// of 16.
extern "C" int emg3d_probe_dyn_slice(void* out, const void* x, const void* y0,
                                     int slices, int planes, int ny, int ty,
                                     int zp, void* stream) {
  if (zp % 4 != 0 || ty > ny || ty < 1 || slices < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = ty * zp * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dyn_slice, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dyn_slice<<<dim3(planes, slices), 256, smem,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(x),
      static_cast<const int*>(y0), planes, ny, ty, zp);
  return static_cast<int>(cudaGetLastError());
}

// z (10, points) from x (40, points): planes 2i/2i+1 the real and
// imaginary parts of L (i < 10), dinv (10..14) and y (15..19), by
// ``blocks`` blocks of kStationThreads threads, ``vec`` (4 or 1) points
// a thread at a time; vec 4 needs points % 4 == 0 and both tensors
// 16-byte aligned.
extern "C" int emg3d_probe_station_solve(void* z, const void* x, int points,
                                         int vec, int blocks, void* stream) {
  if (points < 1 || blocks < 1 || (vec != 1 && vec != 4) ||
      points % vec != 0 ||
      (vec == 4 && (reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(x) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    station_solve<4><<<blocks, kStationThreads, 0, s>>>(
        static_cast<float*>(z), static_cast<const float*>(x), points);
  } else {
    station_solve<1><<<blocks, kStationThreads, 0, s>>>(
        static_cast<float*>(z), static_cast<const float*>(x), points);
  }
  return static_cast<int>(cudaGetLastError());
}
