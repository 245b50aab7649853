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
//       semaphore becomes the Tensor Memory Accelerator with an
//       mbarrier: one thread issues cp.async.bulk.tensor for a box of
//       the array (a CUtensorMap built on the host), the block waits on
//       the barrier for its bytes, adds 1, fences the shared writes to
//       the async proxy and stores the box back with one more bulk
//       tensor copy.  The map's extents end at the sub-box's end, so
//       the hardware drops the part of a box beyond it.  Along z (the
//       contiguous dim) a box starts and the map ends on 16 bytes: boxes
//       at z offsets of 13 floats (the map ending off 16 bytes too)
//       raised an illegal instruction on the card, so the boxes span the
//       sub-box rounded out to 16 bytes and only the sub-box's own
//       elements get +1 (the others go back as they came; boxes of one
//       launch never overlap).  Offsets along the other dims need no
//       alignment.
//   smem_limit   <- hw_probe_ztile.py: probe_vmem (209).  Mosaic's
//       question was the scoped-VMEM limit; the card's is the dynamic
//       shared memory a block may opt in to (232 448 bytes on an H100).
//       A kernel fills N bytes of it and sums it back; the host sets
//       cudaFuncAttributeMaxDynamicSharedMemorySize to N first and
//       returns the launch's cudaGetLastError, so a size beyond the
//       limit reads as the card's refusal.
//   smem_sum     <- hw_bisect_zp256.py fbuf5d (49): a sum over a 5-D
//       shared buffer (2, chx, NF, ty, 4): chx stations of NF planes
//       of a (ty, 4) z-slab, copied in with cp.async.
//   tile_roll    <- hw_bisect_zp256.py rolllane/rollsub (65): roll a
//       (ty, Zp) tile along either axis with warp shuffles.
//   dyn_slice    <- hw_bisect_zp256.py dynslice, dynslice_al, _al12
//       (84, 108): a dim-2 slice of a 4-D array at offsets read on the
//       card (Pallas' scalar prefetch), through shared memory.
//   station_solve <- hw_bisect_zp256.py station (136): the 5×5 complex
//       LDLᵀ substitution of blocksolve.ldl_solve_factored on (ty, Zp)
//       tiles, one thread per point.
//
// Bounds: each probe moves each input byte once and writes each output
// once (tile_copy 8 B per element of the box, dyn_slice 8 B per element
// of the slice); none does enough arithmetic to be bound by it.  The
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
// tile_copy: TMA box in, +1, TMA box out.
// ---------------------------------------------------------------------

constexpr int kTileThreads = 256;

__global__ void __launch_bounds__(kTileThreads)
tile_copy(const __grid_constant__ CUtensorMap map, int o0, int o1, int o2,
          int a3, int lo3, int hi3, int n1, int n2, int n3, int b0, int b1,
          int b2, int b3) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t bar;
  // TMA writes boxes to 128-byte aligned shared addresses.
  float* tile = reinterpret_cast<float*>(
      raw + ((128 - (smem_u32(raw) & 127)) & 127));
  int t = blockIdx.x;
  const int t3 = t % n3;
  t /= n3;
  const int t2 = t % n2;
  t /= n2;
  const int t1 = t % n1;
  const int t0 = t / n1;
  const int c0 = o0 + t0 * b0, c1 = o1 + t1 * b1, c2 = o2 + t2 * b2,
            c3 = a3 + t3 * b3;
  const int count = b0 * b1 * b2 * b3;
  const uint32_t mb = smem_u32(&bar);
  const uint32_t dst = smem_u32(tile);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
        "r"(static_cast<uint32_t>(count * 4))
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(c3), "r"(c2), "r"(c1),
        "r"(c0), "r"(mb)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mb)
        : "memory");
  }
  for (int i = threadIdx.x; i < count; i += kTileThreads) {
    const int z = c3 + i % b3;
    if (z >= lo3 && z < hi3) tile[i] += 1.0f;
  }
  // The generic-proxy writes above, visible to the bulk copy below.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
        "[%0, {%1, %2, %3, %4}], [%5];" ::"l"(reinterpret_cast<uint64_t>(&map)),
        "r"(c3), "r"(c2), "r"(c1), "r"(c0), "r"(dst)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
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
// smem_limit: fill and sum N bytes of dynamic shared memory.
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(256) smem_fill(unsigned* out, int n) {
  extern __shared__ unsigned words[];
  for (int i = threadIdx.x; i < n; i += 256) words[i] = i * 2654435761u;
  __syncthreads();
  unsigned s = 0;
  for (int i = threadIdx.x; i < n; i += 256) s += words[n - 1 - i];
  atomicAdd(out, s);
}

// ---------------------------------------------------------------------
// smem_sum: a 5-D shared buffer (2, chx, nf, ty, 4) per block.
// ---------------------------------------------------------------------

constexpr int kSumZ = 4;          // z values per block (one 16-byte copy)

__global__ void __launch_bounds__(256)
smem_sum(float* out, const float* f, int chx, int nf, int ty, int zp,
         int plane) {
  extern __shared__ __align__(16) float buf[];   // [2][chx][nf][ty][kSumZ]
  const int slot = blockIdx.x & 1;
  const int z0 = blockIdx.x * kSumZ;
  const int rows = chx * nf * ty;                 // (i, p, y) rows
  float* base = buf + static_cast<size_t>(slot) * rows * kSumZ;
  for (int r = threadIdx.x; r < rows; r += 256) {
    const float* src = f + static_cast<size_t>(r) * zp + z0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(base + r * kSumZ)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
  __syncthreads();
  for (int q = threadIdx.x; q < ty * kSumZ; q += 256) {
    const int y = q / kSumZ, c = q % kSumZ;
    float acc = 0.0f;
    for (int i = 0; i < chx; ++i) {
      acc += buf[((((static_cast<size_t>(slot) * chx + i) * nf + plane) *
                   ty + y) * kSumZ) + c];
    }
    out[static_cast<size_t>(y) * zp + z0 + c] = acc;
  }
}

// ---------------------------------------------------------------------
// tile_roll: torch.roll of a (rows, cols) tile with warp shuffles.
// ---------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRollChunks = 16;   // cols ≤ 512 along the lane axis

// Axis 1: one warp per row; lane l holds column k·32 + l of chunk k.
__global__ void __launch_bounds__(32)
roll_cols(float* out, const float* x, int cols, int shift) {
  const int row = blockIdx.x, lane = threadIdx.x, K = cols / 32;
  float v[kRollChunks];
#pragma unroll
  for (int k = 0; k < kRollChunks; ++k) {
    if (k < K) v[k] = x[static_cast<size_t>(row) * cols + k * 32 + lane];
  }
  const int s = ((shift % cols) + cols) % cols, q = s / 32, r = s % 32;
  const int from = (lane - r) & 31;
  for (int k = 0; k < K; ++k) {
    const int ka = ((k - q) % K + K) % K, kb = ((k - q - 1) % K + K) % K;
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int j = 0; j < kRollChunks; ++j) {   // registers, not local memory
      if (j == ka) a = v[j];
      if (j == kb) b = v[j];
    }
    a = __shfl_sync(kFull, a, from);
    b = __shfl_sync(kFull, b, from);
    out[static_cast<size_t>(row) * cols + k * 32 + lane] =
        lane >= r ? a : b;
  }
}

// Axis 0 (rows dividing 32): a warp holds 32/rows columns of every row,
// lane = row·(32/rows) + column; the rolled value is one shuffle away.
__global__ void __launch_bounds__(256)
roll_rows(float* out, const float* x, int rows, int cols, int shift) {
  const int lane = threadIdx.x & 31, g = 32 / rows;
  const int group = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int row = lane / g, col = group * g + lane % g;
  const bool live = col < cols;
  const float v = live ? x[static_cast<size_t>(row) * cols + col] : 0.0f;
  const int s = ((shift % rows) + rows) % rows;
  const float w = __shfl_sync(kFull, v, ((row - s + rows) % rows) * g +
                                           lane % g);
  if (live) out[static_cast<size_t>(row) * cols + col] = w;
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

__global__ void __launch_bounds__(256)
station_solve(float* z, const float* x, int points) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= points) return;
  auto load = [&](int i) {
    return make_float2(x[static_cast<size_t>(2 * i) * points + n],
                       x[static_cast<size_t>(2 * i + 1) * points + n]);
  };
  float2 L[10], y[5];
#pragma unroll
  for (int i = 0; i < 10; ++i) L[i] = load(i);   // (1,0) (2,0) (2,1) (3,0) ...
#pragma unroll
  for (int i = 0; i < 5; ++i) y[i] = load(15 + i);
  // Forward: y_i -= L_ik y_k; diagonal; backward: y_i -= L_ki y_k.
#pragma unroll
  for (int i = 1; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) {
      const float2 p = cmul(L[i * (i - 1) / 2 + k], y[k]);
      y[i] = make_float2(y[i].x - p.x, y[i].y - p.y);
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) y[i] = cmul(y[i], load(10 + i));
#pragma unroll
  for (int i = 3; i >= 0; --i) {
#pragma unroll
    for (int k = i + 1; k < 5; ++k) {
      const float2 p = cmul(L[k * (k - 1) / 2 + i], y[k]);
      y[i] = make_float2(y[i].x - p.x, y[i].y - p.y);
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    z[static_cast<size_t>(2 * i) * points + n] = y[i].x;
    z[static_cast<size_t>(2 * i + 1) * points + n] = y[i].y;
  }
}

}  // namespace

// x is a contiguous (d0, d1, d2, d3) fp32 array (d3 a multiple of 4); the
// sub-box starts at (o0..o3) with lengths (l0..l3) and moves in boxes of
// (b0..b3) elements (b3 a multiple of 4, each ≤ 256), along z over
// [o3, o3 + l3) rounded out to multiples of 4.  Returns a cudaError_t,
// or 1000 + a CUresult when the tensor map cannot be encoded.
extern "C" int emg3d_probe_tile_copy(void* x, int d0, int d1, int d2,
                                     int d3, int o0, int o1, int o2, int o3,
                                     int l0, int l1, int l2, int l3, int b0,
                                     int b1, int b2, int b3, void* stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (d3 % 4 != 0 || b3 % 4 != 0 || b0 > 256 || b1 > 256 || b2 > 256 ||
      b3 > 256 || o0 < 0 || o1 < 0 || o2 < 0 || o3 < 0 || l0 < 1 ||
      l1 < 1 || l2 < 1 || l3 < 1 || o0 + l0 > d0 || o1 + l1 > d1 ||
      o2 + l2 > d2 || o3 + l3 > d3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int a3 = o3 & ~3, e3 = min(d3, (o3 + l3 + 3) & ~3);
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
  const int n0 = (l0 + b0 - 1) / b0, n1 = (l1 + b1 - 1) / b1,
            n2 = (l2 + b2 - 1) / b2, n3 = (e3 - a3 + b3 - 1) / b3;
  const int smem = b0 * b1 * b2 * b3 * 4 + 128;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tile_copy<<<n0 * n1 * n2 * n3, kTileThreads, smem,
              static_cast<cudaStream_t>(stream)>>>(
      map, o0, o1, o2, a3, o3, o3 + l3, n1, n2, n3, b0, b1, b2, b3);
  return static_cast<int>(cudaGetLastError());
}

// Sets the fill kernel's dynamic shared memory limit to ``nbytes``
// (cudaFuncSetAttribute's error into *attr_err) and launches it with
// ``nbytes``, whatever the attribute said: returns the launch's
// cudaGetLastError, cudaSuccess where the card admits the size.
extern "C" int emg3d_probe_smem_limit(void* out, int nbytes, void* attr_err,
                                      void* stream) {
  *static_cast<int*>(attr_err) = static_cast<int>(cudaFuncSetAttribute(
      smem_fill, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes));
  cudaGetLastError();
  smem_fill<<<1, 256, nbytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(out), nbytes / 4);
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
// array, zp a multiple of 4.
extern "C" int emg3d_probe_smem_sum(void* out, const void* f, int chx,
                                    int nf, int ty, int zp, int plane,
                                    void* stream) {
  if (zp % kSumZ != 0 || plane < 0 || plane >= nf || chx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = 2 * chx * nf * ty * kSumZ * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        smem_sum, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  smem_sum<<<zp / kSumZ, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(f), chx, nf, ty,
      zp, plane);
  return static_cast<int>(cudaGetLastError());
}

// out = torch.roll(x, shift, axis) of a contiguous (rows, cols) tile:
// axis 1 needs cols a multiple of 32 (≤ 512), axis 0 rows dividing 32.
extern "C" int emg3d_probe_tile_roll(void* out, const void* x, int rows,
                                     int cols, int shift, int axis,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    if (cols % 32 != 0 || cols > 32 * kRollChunks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    roll_cols<<<rows, 32, 0, s>>>(static_cast<float*>(out),
                                  static_cast<const float*>(x), cols, shift);
  } else {
    if (rows < 1 || 32 % rows != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int groups = (cols + 32 / rows - 1) / (32 / rows);
    roll_rows<<<(groups + 7) / 8, 256, 0, s>>>(
        static_cast<float*>(out), static_cast<const float*>(x), rows, cols,
        shift);
  }
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
// imaginary parts of L (i < 10), dinv (10..14) and y (15..19).
extern "C" int emg3d_probe_station_solve(void* z, const void* x, int points,
                                         void* stream) {
  if (points < 1) return static_cast<int>(cudaErrorInvalidValue);
  station_solve<<<(points + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(z), static_cast<const float*>(x), points);
  return static_cast<int>(cudaGetLastError());
}
