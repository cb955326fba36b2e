// VALID stride-1 3D convolution on int8 operands: NDHWC s8 activations x
// packed s8 weights -> int32 accumulators -> acc * (sx * sw[co]) (+ bias)
// (ReLU), stored as bf16 or fp32.  Beside it, the two passes that make the
// s8 activations: the tensor's absolute maximum, and the quantization itself.
//
// Replaces no Pallas kernel: the JAX package's int8 path (its
// ops/quant.py:qconv, lines 58-65) hands an s8 x s8 -> s32
// conv_general_dilated to XLA.  PyTorch has no int8 convolution on CUDA, and
// emulating the s8 products in a float type would make the int8 path slower
// than the bf16 one it exists to beat, so the port's is this kernel
// (ops/quant.py:qconv_cuda).
//
// What bounds it: at the 300- and 1500-channel levels a 3x3x3 conv does
// ~54*Cin operations per input byte, far above the H100's ~590 int8
// op/byte ridge (1979 TOPS over 3.35 TB/s), so the conv is bound by
// operations, which only wgmma reaches at the full rate; the 1x1 residuals,
// the narrow first levels and both quantization passes are bound by bytes.
//
// Quantization (bs_s8_amax, bs_s8_quantize), as ops/quant.py:quantize
// computes it: sx = max(amax|x|, 1e-30) / 127 in fp32, q = rint(x / sx) by
// IEEE division (ties to even), clipped to +-127.  The quantization writes
// the s8 tensor contiguous with its channels padded to the pitch Cp (a
// multiple of 16), zeros past Ci, so that every voxel starts on a 16-byte
// line.  Both passes run at memory bandwidth: a thread takes 16 channels of
// one voxel at a time (two to four 16-byte loads where the view's strides
// allow, else 8-byte or single loads; one 16-byte s8 store), a warp walks
// a segment of one row (n, z, y) of the view, so the voxel index is split
// once per segment and never divided per voxel, and the amax grid is a few
// blocks per SM with one atomicMax per block on the float's bits
// (non-negative floats order as their bits do).  The U-Net quantizes each
// conv-pass input once: its first conv and its 1x1 residual read the same
// s8 tensor, the residual a centre crop of it (a strided view: its origin
// stays on a 16-byte line because Cp % 16 == 0).
//
// The conv (qconv3d_kernel), K1's design (conv3d.cu) in s8: an implicit
// GEMM whose rows M are output voxels, columns output channels, and whose
// reduction K runs over (tap, 128-channel chunk), one 128-byte row of s8
// under the 128-byte swizzle (16-byte chunk index XOR row % 8).  A CTA is
// three warpgroups.  One produces: per (tap, chunk) one thread starts a TMA
// load in im2col mode through a UINT8 tensor map over the s8 tensor (BM
// consecutive output voxels walked through the (W', H', D', N) box, the
// tap's offset added, channels past the pitch and voxels past the tensor
// filled with zeros) and one bulk copy (cp.async.bulk) of the B tile,
// which ops/quant.py:pack_qweights prepacked into exactly that swizzled
// layout.  Two consume: each owns MT x 64 rows and runs
// wgmma.mma_async m64nBNk32 s8 on shared-memory descriptors, s32
// accumulators in registers, only for the k32 steps that hold real
// channels.  Stages form a ring guarded by mbarriers (full: the
// producer's expected bytes, and its threads' copies where they gather;
// empty: the consumer warps), so nothing in the K loop is block-wide: 4-6
// stages deep on the wide tiles, 2-3 on the narrow ones (BN 16 and 64),
// which run two blocks an SM (blocks_per_sm).
// Narrow inputs (a pitch up to 64: Ci 1, 12 and 60) take a path of their
// own: through the tensor map each 128-byte row held one tap's 16 or 64
// useful bytes, and those convs ran 10-40x their bounds on the H100 (the
// loads cost about as much a voxel as the full rows of the wide levels;
// PERF.md, PR 14); instead 8 (pitch 16)
// or 2 (pitch 64) taps share a K row, k = tap * 16 (or 64) + c, and the
// producer warpgroup gathers each row's 16-byte pieces with cp.async
// (L1-cached: the taps' windows overlap) from per-row bases, as K1's
// gather does; the weights are packed for the same K walk.  BN is fitted
// to Co on the host (16, 64, 160, 256; ops/quant.py:tile_plan).  The
// epilogue rescales with
// explicitly rounded fp32 operations, exactly as the plain version:
// __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw[co])), __fadd_rn of the
// fp32 bias, the ReLU, one rounding to the output type; it stages the tile
// in shared memory (the ring, once both consumers are done with it) and
// stores 16-byte lines: along each voxel's channels where the output's
// voxel pitch is a multiple of 16 bytes, or as one contiguous run of the
// tile's voxels where one tile holds every channel of a dense output (the
// narrow levels' 9, 12 and 60 channels), masked at the ragged M and Co
// edges.
//
// Plain C interface, loaded with ctypes (bootstrapper_torch/ops/quant.py).

#include <cuda.h>  // CUtensorMap and its encoder's signature; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma_s8_sm90.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// quantization
// ---------------------------------------------------------------------------

// Geometry of a strided NDHWC view (channel stride 1), strides in elements.
struct View5 {
  const void* p;
  long long sN, sD, sH, sW;
  int N, D, H, W, C;
};

constexpr int QTHREADS = 256;           // 8 warps a block
constexpr int QUNROLL = 4;              // items a lane takes per segment
constexpr int QSEG = 32 * QUNROLL;      // items a warp takes per segment
constexpr int QBLOCKS_PER_SM = 8;
constexpr int NUM_SMS = 132;            // H100 SXM

__device__ __forceinline__ float bf16_bits(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// The 16 channels c0..c0+15 of one voxel at p (p = the voxel's channel c0)
// as floats, zero from `valid` on.  VB: bytes a load (16, 8, or the
// element's size), which the view's alignment allows.
template <typename T, int VB>
__device__ __forceinline__ void load16(const T* __restrict__ p, int valid, float (&v)[16]) {
  constexpr int ES = static_cast<int>(sizeof(T));
  constexpr int E = VB / ES;  // elements a load
  static_assert(E >= 1 && 16 % E == 0, "a load holds whole elements");
#pragma unroll
  for (int piece = 0; piece < 16 / E; ++piece) {
    const int c0 = piece * E;
    if (c0 + E <= valid) {
      if constexpr (VB == 16) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + c0));
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        if constexpr (ES == 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[c0 + 2 * i] = bf16_bits(w[i] & 0xFFFFu);
            v[c0 + 2 * i + 1] = bf16_bits(w[i] >> 16);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[c0 + i] = __uint_as_float(w[i]);
        }
      } else if constexpr (VB == 8) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + c0));
        const uint32_t w[2] = {u.x, u.y};
        if constexpr (ES == 2) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            v[c0 + 2 * i] = bf16_bits(w[i] & 0xFFFFu);
            v[c0 + 2 * i + 1] = bf16_bits(w[i] >> 16);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i) v[c0 + i] = __uint_as_float(w[i]);
        }
      } else {
        if constexpr (ES == 2) {
          v[c0] = bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p + c0)));
        } else {
          v[c0] = __ldg(reinterpret_cast<const float*>(p + c0));
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = c0 + e;
        float f = 0.f;
        if (c < valid) {
          if constexpr (ES == 2) {
            f = bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p + c)));
          } else {
            f = __ldg(reinterpret_cast<const float*>(p + c));
          }
        }
        v[c] = f;
      }
    }
  }
}

// The walk both passes share.  Items are (voxel of a row, 16-channel
// group); a warp takes a segment of QSEG consecutive items of one row
// (n, z, y), splitting the segment's index into the row once; a lane then
// takes every 32nd item of the segment, the group count G dividing the
// row-local item in 32 bits.  fn(item_ptr, valid, voxel index, group).
template <typename T, typename Fn>
__device__ __forceinline__ void walk(const View5& t, Fn&& fn) {
  const T* __restrict__ x = static_cast<const T*>(t.p);
  const unsigned G = static_cast<unsigned>((t.C + 15) / 16);
  const unsigned row_items = static_cast<unsigned>(t.W) * G;
  const long long nseg = (row_items + QSEG - 1) / QSEG;
  const long long units = static_cast<long long>(t.N) * t.D * t.H * nseg;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (QTHREADS / 32);
  for (long long u = blockIdx.x * (QTHREADS / 32) + (threadIdx.x >> 5); u < units; u += warps) {
    const long long row = u / nseg;
    const unsigned seg = static_cast<unsigned>(u - row * nseg);
    const int y = static_cast<int>(row % t.H);
    const long long r2 = row / t.H;
    const int z = static_cast<int>(r2 % t.D);
    const int n = static_cast<int>(r2 / t.D);
    const T* rowp = x + n * t.sN + z * t.sD + y * t.sH;
    const long long vox0 = row * t.W;  // linear voxel index of the row's first
#pragma unroll
    for (int k = 0; k < QUNROLL; ++k) {
      const unsigned item = seg * QSEG + k * 32 + lane;
      if (item < row_items) {
        const unsigned w = item / G;
        const int g = static_cast<int>(item - w * G);
        const int c0 = 16 * g;
        const int valid = t.C - c0 < 16 ? t.C - c0 : 16;
        fn(rowp + w * t.sW + c0, valid, vox0 + w, g);
      }
    }
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(QTHREADS) s8_amax_kernel(const View5 t, unsigned int* amax_bits) {
  float m = 0.f;
  walk<T>(t, [&](const T* p, int valid, long long, int) {
    float v[16];
    load16<T, VB>(p, valid, v);
#pragma unroll
    for (int c = 0; c < 16; ++c) m = fmaxf(m, fabsf(v[c]));
  });
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[QTHREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = part[0];
    for (int i = 1; i < QTHREADS / 32; ++i) b = fmaxf(b, part[i]);
    atomicMax(amax_bits, __float_as_uint(b));
  }
}

// xq[v][c] = clip(rint(x / sx), -127, 127) for c < C, 0 for C <= c < Cp;
// block 0's thread 0 also stores sx.
template <typename T, int VB>
__global__ void __launch_bounds__(QTHREADS) s8_quantize_kernel(const View5 t, int Cp,
                                                               const unsigned int* amax_bits,
                                                               float* sx_out,
                                                               int8_t* __restrict__ xq) {
  const float sx = __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-30f), 127.0f);
  const float rsx = __frcp_rn(sx);
  if (blockIdx.x == 0 && threadIdx.x == 0) *sx_out = sx;
  walk<T>(t, [&](const T* p, int valid, long long vox, int g) {
    float v[16];
    load16<T, VB>(p, valid, v);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      int q = 0;
      if (c < valid) {
        // x * (1/sx) is within 2^-16 of x / sx (|x / sx| <= 127), and the
        // IEEE quotient within 2^-18: both round to the same integer unless
        // the product lies within 2^-15 of a half-integer, where the
        // division decides
        const float y = __fmul_rn(v[c], rsx);
        float r = rintf(y);
        if (fabsf(fabsf(y - truncf(y)) - 0.5f) <= 0x1p-15f) r = rintf(__fdiv_rn(v[c], sx));
        q = static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
      }
      w[c / 4] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * (c % 4));
    }
    *reinterpret_cast<uint4*>(xq + vox * Cp + 16 * g) = make_uint4(w[0], w[1], w[2], w[3]);
  });
}

// ---------------------------------------------------------------------------
// the conv: wgmma s8 from swizzled shared memory behind an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int BK = 128;           // channels per chunk = one 128-byte row
constexpr int ROW_BYTES = 128;
constexpr int NCONSUMER_WARPS = 8;  // two warpgroups
constexpr int NPRODUCERS = 128;     // one warpgroup
constexpr int NTHREADS = 384;
constexpr int MAX_STAGES = 6;

// Blocks a tile width runs per SM.  The narrow tiles (the 9-, 12- and
// 60-channel levels) hold few accumulators and walk short K loops, so two
// blocks share an SM and one's start-up and epilogue hide behind the
// other's loads; registers and shared memory are split in two for them,
// and their warpgroups keep equal registers (setmaxnreg moves registers
// only within a block's own pool, which half an SM's allocation leaves
// too small to be worth it).
__host__ __device__ constexpr int blocks_per_sm(int bn) { return bn <= 64 ? 2 : 1; }

struct Params {
  const int8_t* x;    // the s8 view (gathered where tpr > 0)
  const uint8_t* wp;  // packed weights, see ops/quant.py:pack_qweights
  const float* sx;    // one value
  const float* sw;    // (Co)
  const float* bias;  // (Co) or null
  void* out;
  long long sN, sD, sH, sW, M, ldo;  // strides in bytes; ldo: elements between output voxels
  int Ci, Cp, Co, co8, kd, kh, kw, Do, Ho, Wo;
  int relu, stages, n_tiles_n;
  int tpr;      // taps packed into a 128-byte K row (gather path), 0: one tap's chunk (TMA)
  int out_f32;  // 1: fp32 out, 0: bf16
  int store;    // 0: single values, 1: 16-byte lines along channels, 2: one run
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy global -> shared; its bytes complete on the mbarrier.
__device__ __forceinline__ void bulk_g2s(uint32_t smem, const void* gmem, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

// One TMA load in im2col mode: BM voxels x 128 channels from channel c of
// the voxel (w, h, d, n) + tap offset on, walking the map's box; its bytes
// complete on the mbarrier.
__device__ __forceinline__ void tma_im2col(uint32_t smem, const CUtensorMap* map, uint32_t bar,
                                           int c, int w, int h, int d, int n, int dx, int dy,
                                           int dz) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2], {%8, %9, %10};\n" ::"r"(smem),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(d), "r"(n),
      "h"(static_cast<unsigned short>(dx)), "h"(static_cast<unsigned short>(dy)),
      "h"(static_cast<unsigned short>(dz))
      : "memory");
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros.
// Cached in L1: a tile's taps read overlapping windows.
__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// This thread's arrival on the barrier, made by the hardware once all the
// cp.async copies the thread has started so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Orders the generic-proxy writes to shared memory (cp.async) that this
// thread has observed before its later async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Linear output voxel -> byte offset of its window origin in x, or -1 past
// the end.
__device__ __forceinline__ long long row_base(long long m, const Params& p) {
  if (m >= p.M) return -1;
  if (p.M <= 0xFFFFFFFFLL) {  // 32-bit divisions where the voxels allow
    unsigned t = static_cast<unsigned>(m);
    const unsigned xo = t % p.Wo;
    t /= p.Wo;
    const unsigned yo = t % p.Ho;
    t /= p.Ho;
    return static_cast<long long>(t / p.Do) * p.sN + (t % p.Do) * p.sD + yo * p.sH + xo * p.sW;
  }
  long long t = m;
  const long long xo = t % p.Wo;
  t /= p.Wo;
  const long long yo = t % p.Ho;
  t /= p.Ho;
  const long long zo = t % p.Do;
  const long long n = t / p.Do;
  return n * p.sN + zo * p.sD + yo * p.sH + xo * p.sW;
}

// Gather one A chunk of the tap-packed layout: row r's 16-byte piece pc
// holds channels ch..ch+15 of tap `tap` of output voxel r (zeros past the
// taps, past the pitch and past M).  The 128 producer threads each own one
// piece and walk the rows 16 apart, so a warp's copies read whole runs of
// a voxel row.
template <int BM>
__device__ __forceinline__ void gather_a(const Params& p, const long long* rowbase, uint32_t a_s,
                                         int t, int tap, int taps) {
  const int pc = t & 7;
  const int r0 = t >> 3;
  const int per_tap = (ROW_BYTES / p.tpr) / 16;  // pieces a tap
  const int tp = tap + pc / per_tap;
  const int ch = (pc % per_tap) * 16;
  const bool ok = tp < taps && ch < p.Cp;
  long long toff = 0;
  if (ok) {
    const int dx = tp % p.kw;
    const int t2 = tp / p.kw;
    toff = (t2 / p.kh) * p.sD + (t2 % p.kh) * p.sH + dx * p.sW + ch;
  }
  const uint32_t dst0 = a_s + static_cast<uint32_t>(r0) * ROW_BYTES +
                        ((static_cast<uint32_t>(pc) ^ static_cast<uint32_t>(r0 & 7)) << 4);
  constexpr int ITERS = BM / 16;
  constexpr int U = 4;
#pragma unroll 1
  for (int i0 = 0; i0 < ITERS; i0 += U) {
    long long base[U];
#pragma unroll
    for (int u = 0; u < U; ++u) base[u] = rowbase[r0 + 16 * (i0 + u)];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool v = ok && base[u] >= 0;
      cp_async16(dst0 + static_cast<uint32_t>(16 * (i0 + u)) * ROW_BYTES,
                 v ? static_cast<const void*>(p.x + base[u] + toff) : static_cast<const void*>(p.x),
                 v ? 16 : 0);
    }
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Staging pitch in bytes of a BN-wide row of `es`-byte values: 4 mod 32
// words, so that the accumulator layout's stores spread over the banks.
__host__ __device__ constexpr int stage_pitch(int bn, int es) {
  return (bn * es / 4 + (36 - (bn * es / 4) % 32) % 32) * 4;
}

// BN: tile width; MT: 64-row wgmma tiles per consumer warpgroup.
template <int BN, int MT>
__global__ void __launch_bounds__(NTHREADS, blocks_per_sm(BN))
    qconv3d_kernel(const Params p, const __grid_constant__ CUtensorMap tmap) {
  constexpr int BM = 128 * MT;
  constexpr int A_BYTES = BM * ROW_BYTES;
  constexpr int B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  constexpr int ROWS = MT * 64;  // rows per consumer warpgroup

  extern __shared__ uint8_t smem_raw[];
  // the swizzle works on address bits, so tiles sit on 1024-byte lines
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  uint8_t* smem_gen = smem_raw + (smem0 - raw0);
  long long* rowbase = reinterpret_cast<long long*>(smem_gen + p.stages * STAGE_BYTES);
  const uint32_t full0 = smem0 + p.stages * STAGE_BYTES + BM * 8;
  const uint32_t empty0 = full0 + MAX_STAGES * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the N tiles of one M tile are neighbours: they share the activations in L2
  const int nt_i = static_cast<int>(blockIdx.x % p.n_tiles_n);
  const long long m0 = (blockIdx.x / p.n_tiles_n) * static_cast<long long>(BM);
  const int n0 = nt_i * BN;

  if (p.tpr)
    for (int r = tid; r < BM; r += NTHREADS) rowbase[r] = row_base(m0 + r, p);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, p.tpr ? NPRODUCERS + 1 : 1);
      mbar_init(empty0 + 8 * s, NCONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K: per tap its chunks of 128 channels (TMA), or tpr taps a chunk
  // (gather); the last chunk of each run holds last_ks real k32 steps
  const int taps = p.kd * p.kh * p.kw;
  const int kreal = p.tpr ? taps * (ROW_BYTES / p.tpr) : p.Ci;
  const int nchunks = (kreal + BK - 1) / BK;
  const int last_ks = (kreal - (nchunks - 1) * BK + 31) / 32;
  const int KT = p.tpr ? nchunks : taps * nchunks;

  if (warp >= NCONSUMER_WARPS) {
    // ===================== producer warpgroup =====================
    if constexpr (blocks_per_sm(BN) == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - NCONSUMER_WARPS * 32;
    const int b_rows = min(BN, p.co8 - n0);
    const uint32_t b_bytes = static_cast<uint32_t>(b_rows) * ROW_BYTES;
    const size_t w_step = static_cast<size_t>(p.co8) * ROW_BYTES;
    const uint8_t* wsrc = p.wp + static_cast<size_t>(n0) * ROW_BYTES;
    int s = 0;
    uint32_t parity = 1;  // the ring starts empty
    if (p.tpr) {
      // gather: every producer thread copies its pieces of each chunk
      for (int kc = 0; kc < KT; ++kc) {
        mbar_wait(empty0 + 8 * s, parity);
        const uint32_t a_s = smem0 + s * STAGE_BYTES;
        const uint32_t full = full0 + 8 * s;
        if (t == 0) {
          mbar_arrive_expect_tx(full, b_bytes);
          bulk_g2s(a_s + A_BYTES, wsrc, b_bytes, full);
        }
        gather_a<BM>(p, rowbase, a_s, t, kc * p.tpr, taps);
        cp_async_arrive(full);
        wsrc += w_step;
        if (++s == p.stages) {
          s = 0;
          parity ^= 1u;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      return;
    }
    if (t != 0) return;  // with the tensor map, one thread starts every load
    // the tile's first output voxel; the map walks on from there
    long long rest = m0;
    const int w0 = static_cast<int>(rest % p.Wo);
    rest /= p.Wo;
    const int h0 = static_cast<int>(rest % p.Ho);
    rest /= p.Ho;
    const int d0 = static_cast<int>(rest % p.Do);
    const int nb = static_cast<int>(rest / p.Do);
    int dz = 0, dy = 0, dx = 0;
    for (int tap = 0; tap < taps; ++tap) {
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(empty0 + 8 * s, parity);
        const uint32_t a_s = smem0 + s * STAGE_BYTES;
        const uint32_t full = full0 + 8 * s;
        mbar_arrive_expect_tx(full, A_BYTES + b_bytes);
        tma_im2col(a_s, &tmap, full, c * BK, w0, h0, d0, nb, dx, dy, dz);
        bulk_g2s(a_s + A_BYTES, wsrc, b_bytes, full);
        wsrc += w_step;
        if (++s == p.stages) {
          s = 0;
          parity ^= 1u;
        }
      }
      if (++dx == p.kw) {
        dx = 0;
        if (++dy == p.kh) {
          dy = 0;
          ++dz;
        }
      }
    }
    return;
  }

  // ===================== consumer warpgroups =====================
  // the producer's registers to the consumers: 128 * (168 - 56) = 256 *
  // (224 - 168), within the block's pool
  if constexpr (blocks_per_sm(BN) == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = warp >> 2;
  int acc[MT][BN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0;

  // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart
  constexpr uint64_t DESC_HI = (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
                               (uint64_t(1) << 62);
  const uint32_t a_off = static_cast<uint32_t>(wg * ROWS * ROW_BYTES);

  int s = 0, s_prev = -1, c = 0;
  uint32_t parity = 0;
  for (int it = 0; it < KT; ++it) {
    mbar_wait(full0 + 8 * s, parity);
    fence_proxy_async();
    const uint32_t a_s = smem0 + s * STAGE_BYTES;
    const uint64_t da = DESC_HI | (((a_s + a_off) & 0x3FFFFu) >> 4);
    const uint64_t db = DESC_HI | (((a_s + A_BYTES) & 0x3FFFFu) >> 4);
    const int ks = (c == nchunks - 1) ? last_ks : 4;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ks) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          wgmma_s8::mma_m64k32<BN>(acc[i],
                                   da + static_cast<uint64_t>(i * (64 * ROW_BYTES >> 4) + 2 * k),
                                   db + static_cast<uint64_t>(2 * k));
      }
    }
    wgmma_commit();
    if (s_prev >= 0) {
      // all but the newest group are done: release the stage before
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty0 + 8 * s_prev);
    }
    s_prev = s;
    if (++c == nchunks) c = 0;
    if (++s == p.stages) {
      s = 0;
      parity ^= 1u;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) asm volatile("" : "+r"(acc[i][j])::"memory");

  // epilogue: acc * (sx * sw) + bias, ReLU, each step rounded as the plain
  // version rounds it, then one rounding to the output type, staged in the
  // ring (free once both consumer warpgroups are past their last stage)
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int es = p.out_f32 ? 4 : 2;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wl = warp & 3;
  const float sx = *p.sx;
  const bool run = p.store == 2;  // the warpgroup's rows as one contiguous run
  const int pitch = run ? p.Co * es : (p.out_f32 ? stage_pitch(BN, 4) : stage_pitch(BN, 2));
  uint8_t* stg = smem_gen + static_cast<size_t>(wg) * ROWS * pitch;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * q + e;
      const int co = n0 + col;
      if (run && co >= p.Co) continue;
      float scale = 0.f, b = 0.f;
      if (co < p.Co) {
        scale = __fmul_rn(sx, p.sw[co]);
        if (p.bias != nullptr) b = p.bias[co];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = i * 64 + wl * 16 + g + 8 * h;
          float val = __fmul_rn(__int2float_rn(acc[i][4 * j + 2 * h + e]), scale);
          if (p.bias != nullptr) val = __fadd_rn(val, b);
          if (p.relu) val = fmaxf(val, 0.f);
          uint8_t* dst = stg + row * pitch + col * es;
          if (p.out_f32) {
            *reinterpret_cast<float*>(dst) = val;
          } else {
            *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(val);
          }
        }
      }
    }
  }
  if (wg == 0) {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
  }
  const int t = tid & 127;
  const long long mw = m0 + wg * ROWS;  // the warpgroup's first output voxel
  if (mw >= p.M) return;
  const int rows = static_cast<int>(p.M - mw < ROWS ? p.M - mw : ROWS);
  uint8_t* out = static_cast<uint8_t*>(p.out);
  if (run) {
    // the rows' Co channels are one contiguous run in the output
    const long long bytes = static_cast<long long>(rows) * p.Co * es;
    uint8_t* dst = out + mw * p.Co * es;
    const long long nvec = bytes / 16;
    for (long long v = t; v < nvec; v += 128)
      *reinterpret_cast<uint4*>(dst + 16 * v) = *reinterpret_cast<const uint4*>(stg + 16 * v);
    for (long long b = nvec * 16 + t; b < bytes; b += 128) dst[b] = stg[b];
  } else if (p.store == 1) {
    // 16-byte lines along each voxel's channels; a line that starts before
    // Co may run into the output's voxel pitch, never past it
    const int cpr = BN * es / 16;
    const int per = 16 / es;
    for (int i = t; i < rows * cpr; i += 128) {
      const int row = i / cpr;
      const int ch = i - row * cpr;
      const int co = n0 + ch * per;
      if (co < p.Co)
        *reinterpret_cast<uint4*>(out + ((mw + row) * p.ldo + co) * es) =
            *reinterpret_cast<const uint4*>(stg + row * pitch + ch * 16);
    }
  } else {
    for (int i = t; i < rows * BN; i += 128) {
      const int row = i / BN;
      const int col = i - row * BN;
      const int co = n0 + col;
      if (co >= p.Co) continue;
      uint8_t* dst = out + ((mw + row) * p.ldo + co) * es;
      const uint8_t* src = stg + row * pitch + col * es;
      if (p.out_f32) {
        *reinterpret_cast<float*>(dst) = *reinterpret_cast<const float*>(src);
      } else {
        *reinterpret_cast<__nv_bfloat16*>(dst) = *reinterpret_cast<const __nv_bfloat16*>(src);
      }
    }
  }
}

__host__ __device__ constexpr int smem_bytes(int bn, int mt, int stages) {
  return stages * (128 * mt + bn) * ROW_BYTES + 128 * mt * 8 + 2 * MAX_STAGES * 8 + 1024;
}

// Shared memory the epilogue stages the tile in, at most the ring's.
__host__ __device__ constexpr int staging_bytes(int bn, int mt, int co, int out_f32, int store) {
  return 128 * mt * (store == 2 ? co * (out_f32 ? 4 : 2) : stage_pitch(bn, out_f32 ? 4 : 2));
}

template <int BN, int MT>
cudaError_t launch(const Params& p, const CUtensorMap& tmap, cudaStream_t stream) {
  constexpr int BM = 128 * MT;
  if (staging_bytes(BN, MT, p.Co, p.out_f32, p.store) > p.stages * (BM + BN) * ROW_BYTES)
    return cudaErrorInvalidValue;
  const long long tiles_m = (p.M + BM - 1) / BM;
  const long long grid = tiles_m * p.n_tiles_n;
  if (grid <= 0 || grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  qconv3d_kernel<BN, MT><<<static_cast<unsigned>(grid), NTHREADS, smem_bytes(BN, MT, p.stages),
                           stream>>>(p, tmap);
  return cudaGetLastError();
}

// cuTensorMapEncodeIm2col, found through the runtime at set-up
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeIm2col encode_im2col = nullptr;
int cuda_version = 0;  // of the installed libcuda

// The im2col map of the s8 tensor for a (kd, kh, kw) VALID window:
// dimensions (Cp, W, H, D, N), strides in bytes, the box of window origins
// shrunk by k - 1 at the upper corner, 128 channels x bm voxels a load,
// 128-byte swizzle, zeros past the tensor (channels past Cp, voxels past
// the last).
cudaError_t make_im2col_map(CUtensorMap* map, const void* x, long long N, int D, int H, int W,
                            int Cp, long long sN, long long sD, long long sH, long long sW, int kd,
                            int kh, int kw, int bm) {
  if (encode_im2col == nullptr) return cudaErrorNotReady;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(sW), static_cast<cuuint64_t>(sH),
                                 static_cast<cuuint64_t>(sD), static_cast<cuuint64_t>(sN)};
  const int lower[3] = {0, 0, 0};
  const int upper[3] = {-(kw - 1), -(kh - 1), -(kd - 1)};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode_im2col(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x), dims, strides, lower, upper,
      BK, static_cast<cuuint32_t>(bm), steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // libcuda up to 13.1 encodes im2col maps of tensors under 128 KB with a
  // bit set that makes the load fault; CUTLASS clears it the same way
  const long long span =
      1 + (N - 1) * sN + (D - 1) * sD + (H - 1) * sH + (W - 1) * sW + (Cp - 1);
  if (cuda_version <= 13010 && span < 131072) reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  return cudaSuccess;
}

// every kernel instantiation, for bs_qconv3d_init and bs_qconv3d_kernel_info
struct KernelEntry {
  const void* fn;
  int kind;  // 0 = conv, 1 = amax, 2 = quantize
  int bn, bm;  // conv tile
  int bf16, vb;  // passes: input type and load width
};

const KernelEntry* kernel_table(int* n) {
  static const KernelEntry table[] = {
      {reinterpret_cast<const void*>(&qconv3d_kernel<16, 2>), 0, 16, 256, 0, 0},
      {reinterpret_cast<const void*>(&qconv3d_kernel<64, 1>), 0, 64, 128, 0, 0},
      {reinterpret_cast<const void*>(&qconv3d_kernel<160, 2>), 0, 160, 256, 0, 0},
      {reinterpret_cast<const void*>(&qconv3d_kernel<256, 1>), 0, 256, 128, 0, 0},
      {reinterpret_cast<const void*>(&s8_amax_kernel<__nv_bfloat16, 16>), 1, 0, 0, 1, 16},
      {reinterpret_cast<const void*>(&s8_amax_kernel<__nv_bfloat16, 8>), 1, 0, 0, 1, 8},
      {reinterpret_cast<const void*>(&s8_amax_kernel<__nv_bfloat16, 2>), 1, 0, 0, 1, 2},
      {reinterpret_cast<const void*>(&s8_amax_kernel<float, 16>), 1, 0, 0, 0, 16},
      {reinterpret_cast<const void*>(&s8_amax_kernel<float, 8>), 1, 0, 0, 0, 8},
      {reinterpret_cast<const void*>(&s8_amax_kernel<float, 4>), 1, 0, 0, 0, 4},
      {reinterpret_cast<const void*>(&s8_quantize_kernel<__nv_bfloat16, 16>), 2, 0, 0, 1, 16},
      {reinterpret_cast<const void*>(&s8_quantize_kernel<__nv_bfloat16, 8>), 2, 0, 0, 1, 8},
      {reinterpret_cast<const void*>(&s8_quantize_kernel<__nv_bfloat16, 2>), 2, 0, 0, 1, 2},
      {reinterpret_cast<const void*>(&s8_quantize_kernel<float, 16>), 2, 0, 0, 0, 16},
      {reinterpret_cast<const void*>(&s8_quantize_kernel<float, 8>), 2, 0, 0, 0, 8},
      {reinterpret_cast<const void*>(&s8_quantize_kernel<float, 4>), 2, 0, 0, 0, 4},
  };
  *n = static_cast<int>(sizeof(table) / sizeof(table[0]));
  return table;
}

View5 make_view(const void* x, int N, int D, int H, int W, int C, long long sN, long long sD,
                long long sH, long long sW) {
  View5 t;
  t.p = x;
  t.N = N; t.D = D; t.H = H; t.W = W; t.C = C;
  t.sN = sN; t.sD = sD; t.sH = sH; t.sW = sW;
  return t;
}

// Blocks for a pass: QBLOCKS_PER_SM on each SM, fewer where the view has
// fewer segments than warps.
unsigned pass_grid(const View5& t) {
  const long long G = (t.C + 15) / 16;
  const long long nseg = (static_cast<long long>(t.W) * G + QSEG - 1) / QSEG;
  const long long units = static_cast<long long>(t.N) * t.D * t.H * nseg;
  const long long blocks = (units + QTHREADS / 32 - 1) / (QTHREADS / 32);
  const long long most = static_cast<long long>(NUM_SMS) * QBLOCKS_PER_SM;
  return static_cast<unsigned>(blocks < 1 ? 1 : (blocks < most ? blocks : most));
}

// The view's shape and load width: positive sizes, a width the kernels
// are instantiated for.
bool pass_ok(const View5& t, int bf16, int vb) {
  if (t.N <= 0 || t.D <= 0 || t.H <= 0 || t.W <= 0 || t.C <= 0) return false;
  if (static_cast<long long>(t.W) * ((t.C + 15) / 16) >= (1LL << 31)) return false;
  return bf16 ? (vb == 16 || vb == 8 || vb == 2) : (vb == 16 || vb == 8 || vb == 4);
}

}  // namespace

// Once per device, before the first conv launch: lets the conv kernels use
// the device's whole opt-in shared memory, and finds libcuda's tensor-map
// encoder.  Returns a cudaError_t.
extern "C" int bs_qconv3d_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  err = cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &fn, cudaEnableDefault, &found);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (found != cudaDriverEntryPointSuccess || fn == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  encode_im2col = reinterpret_cast<EncodeIm2col>(fn);
  err = cudaDriverGetVersion(&cuda_version);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = 0;
  const KernelEntry* table = kernel_table(&n);
  for (int i = 0; i < n; ++i) {
    if (table[i].kind != 0) continue;
    err = cudaFuncSetAttribute(table[i].fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// amax_bits (one uint32, zeroed by the caller) <- max(its value, the bits
// of max |x|) over a strided NDHWC view (channel stride 1, strides in
// elements); bf16 = 1 for bf16 x, 0 for fp32; vb: bytes a load (16 or 8
// where the view's start and strides allow, else the element's size).
// Returns the cudaError_t of the launch.
extern "C" int bs_s8_amax(const void* x, int bf16, int vb, int N, int D, int H, int W, int C,
                          long long sN, long long sD, long long sH, long long sW,
                          void* amax_bits, void* stream) {
  const View5 t = make_view(x, N, D, H, W, C, sN, sD, sH, sW);
  if (!pass_ok(t, bf16, vb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* bits = static_cast<unsigned int*>(amax_bits);
  const unsigned grid = pass_grid(t);
  if (bf16) {
    if (vb == 16) s8_amax_kernel<__nv_bfloat16, 16><<<grid, QTHREADS, 0, st>>>(t, bits);
    else if (vb == 8) s8_amax_kernel<__nv_bfloat16, 8><<<grid, QTHREADS, 0, st>>>(t, bits);
    else s8_amax_kernel<__nv_bfloat16, 2><<<grid, QTHREADS, 0, st>>>(t, bits);
  } else {
    if (vb == 16) s8_amax_kernel<float, 16><<<grid, QTHREADS, 0, st>>>(t, bits);
    else if (vb == 8) s8_amax_kernel<float, 8><<<grid, QTHREADS, 0, st>>>(t, bits);
    else s8_amax_kernel<float, 4><<<grid, QTHREADS, 0, st>>>(t, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq (N, D, H, W, Cp) s8 contiguous, 16-byte aligned <- x quantized with sx
// from amax_bits (bs_s8_amax's result, of x or of a tensor x is a crop of);
// sx_out gets sx.  Cp is C rounded up to 16.  Returns the cudaError_t of
// the launch.
extern "C" int bs_s8_quantize(const void* x, int bf16, int vb, int N, int D, int H, int W, int C,
                              long long sN, long long sD, long long sH, long long sW, int Cp,
                              const void* amax_bits, void* sx_out, void* xq, void* stream) {
  const View5 t = make_view(x, N, D, H, W, C, sN, sD, sH, sW);
  if (!pass_ok(t, bf16, vb) || Cp != (C + 15) / 16 * 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int* bits = static_cast<const unsigned int*>(amax_bits);
  float* sx = static_cast<float*>(sx_out);
  int8_t* q = static_cast<int8_t*>(xq);
  const unsigned grid = pass_grid(t);
  if (bf16) {
    if (vb == 16) s8_quantize_kernel<__nv_bfloat16, 16><<<grid, QTHREADS, 0, st>>>(t, Cp, bits, sx, q);
    else if (vb == 8) s8_quantize_kernel<__nv_bfloat16, 8><<<grid, QTHREADS, 0, st>>>(t, Cp, bits, sx, q);
    else s8_quantize_kernel<__nv_bfloat16, 2><<<grid, QTHREADS, 0, st>>>(t, Cp, bits, sx, q);
  } else {
    if (vb == 16) s8_quantize_kernel<float, 16><<<grid, QTHREADS, 0, st>>>(t, Cp, bits, sx, q);
    else if (vb == 8) s8_quantize_kernel<float, 8><<<grid, QTHREADS, 0, st>>>(t, Cp, bits, sx, q);
    else s8_quantize_kernel<float, 4><<<grid, QTHREADS, 0, st>>>(t, Cp, bits, sx, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a conv launch needs, or -1 for an unknown BN.
extern "C" int bs_qconv3d_smem_bytes(int bn, int stages) {
  switch (bn) {
    case 16: return smem_bytes(16, 2, stages);
    case 64: return smem_bytes(64, 1, stages);
    case 160: return smem_bytes(160, 2, stages);
    case 256: return smem_bytes(256, 1, stages);
    default: return -1;
  }
}

// The s8 conv.  xq: an s8 view (N, D, H, W) of voxels Cp bytes wide (the
// pitch bs_s8_quantize wrote, zeros past Ci), strides in bytes, each a
// multiple of 16, and xq 16-byte aligned; Ci <= Cp real channels; a window
// of at most 16 a side.  tpr: 0 loads each tap's 128-channel chunks
// through an im2col tensor map; 2, 4 or 8 (with Cp <= 128 / tpr) packs tpr
// taps of 128 / tpr bytes into each 128-byte K row, gathered with
// cp.async.  wp: ops/quant.py:pack_qweights's layout for the same K walk
// ([128-byte K chunk][co8][128] s8 under the 128-byte swizzle), co8 its Co
// padded to 8.  sx: one fp32; sw: Co fp32; bias: Co fp32 or null.
// out: NDHWC, fp32 (out_f32 = 1) or bf16, ldo >= Co elements between
// voxels, 16-byte aligned.  bn: the tile width (16, 64, 160, 256); 2 <=
// stages <= 6 the ring's depth.  store: 1 = 16-byte lines (needs ldo * the
// output's size a multiple of 16), 2 = one run per warpgroup (needs one
// tile to hold all Co and ldo == Co), 0 = single values.  Returns the
// cudaError_t of the launch.
extern "C" int bs_qconv3d(const void* xq, long long N, int D, int H, int W, int Cp, int Ci,
                          long long sN, long long sD, long long sH, long long sW, int tpr,
                          const void* wp,
                          const void* sx, const void* sw, const void* bias, void* out, int out_f32,
                          int kd, int kh, int kw, int Co, int co8, long long ldo, int relu, int bn,
                          int stages, int store, void* stream) {
  const int es = out_f32 ? 4 : 2;
  if (Cp % 16 != 0 || Ci <= 0 || Ci > Cp || sW < Cp || sW % 16 != 0 || sH % 16 != 0 ||
      sD % 16 != 0 || sN % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 || kd > 16 ||
      kh > 16 || kw > 16 || D < kd || H < kh || W < kw || Co <= 0 || co8 < Co || co8 % 8 != 0 ||
      ldo < Co || stages < 2 || stages > MAX_STAGES || store < 0 || store > 2 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || (store == 1 && (ldo * es) % 16 != 0) ||
      (store == 2 && (ldo != Co || Co > bn)) ||
      (tpr != 0 && tpr != 2 && tpr != 4 && tpr != 8) || (tpr && Cp > ROW_BYTES / tpr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(xq);
  p.sN = sN; p.sD = sD; p.sH = sH; p.sW = sW;
  p.Cp = Cp; p.tpr = tpr;
  p.wp = static_cast<const uint8_t*>(wp);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.Ci = Ci; p.Co = Co; p.co8 = co8; p.kd = kd; p.kh = kh; p.kw = kw;
  p.Do = D - kd + 1; p.Ho = H - kh + 1; p.Wo = W - kw + 1;
  p.M = N * p.Do * p.Ho * p.Wo;
  p.ldo = ldo; p.relu = relu; p.stages = stages;
  p.n_tiles_n = (Co + bn - 1) / bn;
  p.out_f32 = out_f32 ? 1 : 0;
  p.store = store;
  alignas(64) CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (!tpr) {
    const cudaError_t err = make_im2col_map(&tmap, xq, N, D, H, W, Cp, sN, sD, sH, sW, kd, kh, kw,
                                            bn == 256 || bn == 64 ? 128 : 256);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return static_cast<int>(launch<16, 2>(p, tmap, st));
    case 64: return static_cast<int>(launch<64, 1>(p, tmap, st));
    case 160: return static_cast<int>(launch<160, 2>(p, tmap, st));
    case 256: return static_cast<int>(launch<256, 1>(p, tmap, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel instantiation `index`: info = {kind (0 conv, 1 amax, 2 quantize),
// BN, BM, bf16 input, load bytes, registers per thread, static shared
// bytes, max dynamic shared bytes, local (spill) bytes}.  Returns a
// cudaError_t, or -1 past the last instantiation.
extern "C" int bs_qconv3d_kernel_info(int index, int* info) {
  int n = 0;
  const KernelEntry* table = kernel_table(&n);
  if (index < 0 || index >= n) return -1;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, table[index].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = table[index].kind;
  info[1] = table[index].bn;
  info[2] = table[index].bm;
  info[3] = table[index].bf16;
  info[4] = table[index].vb;
  info[5] = attr.numRegs;
  info[6] = static_cast<int>(attr.sharedSizeBytes);
  info[7] = attr.maxDynamicSharedSizeBytes;
  info[8] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaSuccess);
}
