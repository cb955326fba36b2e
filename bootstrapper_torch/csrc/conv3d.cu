// VALID stride-1 3D convolution, NDHWC input x DHWIO weights -> NDHWC
// output, with the bias and an optional ReLU fused into the epilogue and
// fp32 accumulation.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas_conv.py:pallas_conv3d (kernel _conv3d_kernel), which runs
// one [rows, Cin] x [Cin, Cout] MXU matmul per tap over a DMA'd window.
//
// Design: an implicit GEMM.  Rows M are output voxels (N*D'*H'*W'),
// columns are output channels, and the reduction K runs over
// (tap, input channel).  Each CTA owns a BM x BN tile of (voxels, Cout)
// and walks K in chunks of channels of one tap: the A chunk is a run of
// contiguous channels of BM input voxels (the tap's shifted window, read
// straight from the NDHWC tensor through per-row base offsets, so strided
// views such as centre crops need no copy and ragged edges waste nothing).
//
// bf16 (conv3d_kernel_bf16_wgmma): Hopper's warpgroup MMA.  A CTA is three
// warpgroups.  One produces: per (tap, 64-channel chunk) it brings the A
// tile into K-major rows of 128 bytes under the 128-byte swizzle (16-byte
// chunk index XOR row % 8), and the B tile, which the host prepacked into
// exactly that layout (ops/conv3d.py:pack_weights), with one bulk copy
// (cp.async.bulk).  Where every voxel of the input starts on a 16-byte
// line, the A tile is one TMA load in im2col mode: the tensor map walks
// BM consecutive output voxels through the (W', H', D', N) box and adds
// the tap's offset, so one thread starts the whole gather and the load
// unit is out of it.  Otherwise the producer threads gather it with
// cp.async (16, 8 or 4 bytes a copy, or scalar loads).  Two consume: each
// owns MT x 64 rows and runs wgmma.mma_async m64nBNk16 on shared-memory
// descriptors, fp32 accumulators in registers, only for
// the k16 steps that hold real channels.  Stages form a ring guarded by
// mbarriers (full: one arrival per producer thread, triggered by the
// hardware when that thread's copies have landed, plus the bulk copy's
// bytes; empty: the consumer warps), so nothing in the K loop is
// block-wide and the producers run ahead as far as the ring is deep.
// BN is fitted to the net's channel counts on the host (64, 152, 256).
// The epilogue adds the fp32 bias, applies the ReLU, rounds once and
// stores packed bf16 pairs, masked at the ragged M and Cout edges.
//
// fp32 (conv3d_kernel_f32): exact fp32 by FMAs on a 128 x 64 tile with a
// double-buffered cp.async pipeline; the reference-grade route (wgmma has
// no exact fp32).
//
// What bounds it: at the U-Net's 300- and 1500-channel levels a 3x3x3
// conv does ~2*27*Cin FLOPs per input byte, far above the H100's ~295
// bf16 FLOP/byte ridge, so it is bound by operations; the 1x1 residual
// convs are bound by bytes.  PERF.md keeps each shape's time beside its
// bound.
//
// Plain C interface, loaded with ctypes (bootstrapper_torch/ops/conv3d.py).

#include <cuda.h>  // CUtensorMap and its encoder's signature; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy BYTES from global to shared; bytes past src_bytes are zero-filled
// (src_bytes == 0 reads nothing and writes zeros).  No memory clobber: the
// copies stay in order among the other volatile asm statements (commit,
// wait, barrier arrivals), and ordinary loads may move across them.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t smem, const void* gmem,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
                 "l"(gmem), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem),
                 "l"(gmem), "n"(BYTES), "r"(src_bytes));
  }
}

// Linear output voxel -> element offset of its window origin in x, or -1
// past the end.
__device__ __forceinline__ long long row_base(long long m, long long M, int Do,
                                              int Ho, int Wo, long long sN,
                                              long long sD, long long sH,
                                              long long sW) {
  if (m >= M) return -1;
  long long t = m;
  const long long xo = t % Wo;
  t /= Wo;
  const long long yo = t % Ho;
  t /= Ho;
  const long long zo = t % Do;
  const long long n = t / Do;
  return n * sN + zo * sD + yo * sH + xo * sW;
}

// ---------------------------------------------------------------------------
// bf16: wgmma from swizzled shared memory behind an mbarrier ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 64;           // channels per chunk = one 128-byte row
constexpr int ROW_BYTES = 128;
constexpr int NCONSUMER_WARPS = 8;  // two warpgroups
constexpr int NPRODUCERS = 128;     // one warpgroup
constexpr int NTHREADS = 384;
constexpr int MAX_STAGES = 8;

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* wp;  // packed weights, see pack_weights
  const float* bias;
  __nv_bfloat16* out;
  long long sN, sD, sH, sW, M, ldo;  // ldo: elements between output voxels
  int Ci, Co, co8, kd, kh, kw, Do, Ho, Wo;
  int relu, stages, n_tiles_n, av;
  int tma;  // 1: the A tile comes through the im2col tensor map
  int store;  // 0: single values, 1: bf16 pairs, 2: 16 bytes through smem
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
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
__device__ __forceinline__ void bulk_g2s(uint32_t smem, const void* gmem,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

// One TMA load in im2col mode: BM voxels x 64 channels from channel c of
// the voxel (w, h, d, n) + tap offset on, walking the map's box; its bytes
// complete on the mbarrier.
__device__ __forceinline__ void tma_im2col(uint32_t smem, const CUtensorMap* map,
                                           uint32_t bar, int c, int w, int h, int d,
                                           int n, int dx, int dy, int dz) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2], {%8, %9, %10};\n" ::"r"(smem),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(d),
      "r"(n), "h"(static_cast<unsigned short>(dx)), "h"(static_cast<unsigned short>(dy)),
      "h"(static_cast<unsigned short>(dz))
      : "memory");
}

// Orders generic-proxy writes to shared memory (cp.async, st.shared) that
// this thread has observed before its later async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// This thread's arrival on the barrier, made by the hardware once all
// the cp.async copies the thread has started so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Gather one A tile: BM rows of up to 64 channels into 128-byte swizzled
// rows at shared address a_s.  The 128 producer threads each own one
// AV-byte piece of the row and walk the rows AV apart, so that a warp's
// copy reads whole 128-byte runs of channels (fewer, longer runs cost the
// load unit less than more, shorter ones).  The row bases come from shared
// memory a batch ahead of the copies that use them.  Pieces past the
// k16 steps that get multiplied are not loaded; channels past Ci and rows
// past M are zero-filled.
template <int AV, int BM>
__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ x,
                                       const long long* rowbase, uint32_t a_s,
                                       int t, long long toff, int ci_left,
                                       int kmax) {
  constexpr int EA = AV / 2;            // elements per piece
  constexpr int PPR = ROW_BYTES / AV;   // pieces per row
  constexpr int RS = NPRODUCERS / PPR;  // rows per pass
  constexpr int ITERS = BM / RS;
  constexpr int U = ITERS < 8 ? ITERS : 8;
  static_assert(ITERS % U == 0, "rows per thread must come in batches of U");
  const int pc = t % PPR;
  const int kk = pc * EA;
  if (kk >= kmax) return;
  int valid = ci_left - kk;
  valid = valid < 0 ? 0 : (valid > EA ? EA : valid);
  const uint32_t colb = static_cast<uint32_t>(pc * AV);
  const uint32_t chunk16 = colb >> 4;
  const uint32_t within = colb & 15u;
  const __nv_bfloat16* src0 = x + toff + kk;
  const int r0 = t / PPR;
  for (int i0 = 0; i0 < ITERS; i0 += U) {
    long long base[U];
#pragma unroll
    for (int u = 0; u < U; ++u) base[u] = rowbase[r0 + (i0 + u) * RS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t r = static_cast<uint32_t>(r0 + (i0 + u) * RS);
      const uint32_t dst =
          a_s + r * ROW_BYTES + (((chunk16 ^ (r & 7u)) << 4) | within);
      const bool ok = base[u] >= 0 && valid > 0;
      if constexpr (AV >= 4) {
        cp_async<AV>(dst, ok ? static_cast<const void*>(src0 + base[u])
                             : static_cast<const void*>(x),
                     ok ? valid * 2 : 0);
      } else {
        unsigned short v = 0;
        if (ok) v = *reinterpret_cast<const unsigned short*>(src0 + base[u]);
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
      }
    }
  }
}

// BN: tile width; MT: 64-row wgmma tiles per consumer warpgroup.
template <int BN, int MT>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3d_kernel_bf16_wgmma(const Params p,
                             const __grid_constant__ CUtensorMap tmap) {
  constexpr int BM = 128 * MT;
  constexpr int A_BYTES = BM * ROW_BYTES;
  constexpr int B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;

  extern __shared__ uint8_t smem_raw[];
  // the swizzle works on address bits, so tiles sit on 1024-byte lines
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t smem0 = (raw0 + 1023u) & ~1023u;
  long long* rowbase = reinterpret_cast<long long*>(
      smem_raw + (smem0 - raw0) + p.stages * STAGE_BYTES);
  const uint32_t full0 = smem0 + p.stages * STAGE_BYTES + BM * 8;
  const uint32_t empty0 = full0 + MAX_STAGES * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the N tiles of one M tile are neighbours: they share the gathered
  // activations in L2
  const int nt_i = static_cast<int>(blockIdx.x % p.n_tiles_n);
  const long long mt_i = blockIdx.x / p.n_tiles_n;
  const long long m0 = mt_i * BM;
  const int n0 = nt_i * BN;

  for (int r = tid; r < BM; r += NTHREADS)
    rowbase[r] =
        row_base(m0 + r, p.M, p.Do, p.Ho, p.Wo, p.sN, p.sD, p.sH, p.sW);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, p.tma ? 1 : NPRODUCERS + 1);
      mbar_init(empty0 + 8 * s, NCONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nchunks = (p.Ci + BK - 1) / BK;
  const int last_ks = (p.Ci - (nchunks - 1) * BK + 15) / 16;
  const int taps = p.kd * p.kh * p.kw;
  const int KT = taps * nchunks;

  if (warp >= NCONSUMER_WARPS) {
    // ===================== producer warpgroup =====================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - NCONSUMER_WARPS * 32;
    const int b_rows = min(BN, p.co8 - n0);
    const uint32_t b_bytes = static_cast<uint32_t>(b_rows) * ROW_BYTES;
    const size_t w_step = static_cast<size_t>(p.co8) * ROW_BYTES;
    const uint8_t* wsrc = p.wp + static_cast<size_t>(n0) * ROW_BYTES;

    // with the tensor map, one thread starts every load
    if (p.tma && t != 0) return;
    // the tile's first output voxel; the map walks on from there
    long long rest = m0;
    const int w0 = static_cast<int>(rest % p.Wo);
    rest /= p.Wo;
    const int h0 = static_cast<int>(rest % p.Ho);
    rest /= p.Ho;
    const int d0 = static_cast<int>(rest % p.Do);
    const int nb = static_cast<int>(rest / p.Do);

    int s = 0;
    uint32_t parity = 1;  // the ring starts empty
    int dz = 0, dy = 0, dx = 0;
    for (int tap = 0; tap < taps; ++tap) {
      const long long tap_off = dz * p.sD + dy * p.sH + dx * p.sW;
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(empty0 + 8 * s, parity);
        const uint32_t a_s = smem0 + s * STAGE_BYTES;
        const uint32_t full = full0 + 8 * s;
        const int ci0 = c * BK;
        if (t == 0) {
          mbar_arrive_expect_tx(full, b_bytes + (p.tma ? A_BYTES : 0));
          if (p.tma) tma_im2col(a_s, &tmap, full, ci0, w0, h0, d0, nb, dx, dy, dz);
          bulk_g2s(a_s + A_BYTES, wsrc, b_bytes, full);
        }
        if (!p.tma) {
          const int kmax = (c == nchunks - 1 ? last_ks : 4) * 16;
          const long long toff = tap_off + ci0;
          switch (p.av) {
            case 16:
              load_a<16, BM>(p.x, rowbase, a_s, t, toff, p.Ci - ci0, kmax);
              cp_async_arrive(full);
              break;
            case 8:
              load_a<8, BM>(p.x, rowbase, a_s, t, toff, p.Ci - ci0, kmax);
              cp_async_arrive(full);
              break;
            case 4:
              load_a<4, BM>(p.x, rowbase, a_s, t, toff, p.Ci - ci0, kmax);
              cp_async_arrive(full);
              break;
            default:  // plain loads and stores: done when made
              load_a<2, BM>(p.x, rowbase, a_s, t, toff, p.Ci - ci0, kmax);
              mbar_arrive(full);
              break;
          }
        }
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
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ===================== consumer warpgroups =====================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = warp >> 2;
    float acc[MT][BN / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;

    // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart
    constexpr uint64_t DESC_HI = (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
                                 (uint64_t(1) << 62);
    const uint32_t a_off = static_cast<uint32_t>(wg * MT * 64 * ROW_BYTES);

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
            wgmma::mma_m64k16<BN>(acc[i],
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
      for (int j = 0; j < BN / 2; ++j) asm volatile("" : "+f"(acc[i][j])::"memory");

    // epilogue: fp32 bias + optional ReLU, one rounding
    const int g = lane >> 2;
    const int q = lane & 3;
    const int wl = warp & 3;
    if (p.store == 2) {
      // through shared memory, so that the stores to global are 16 bytes
      // a thread and contiguous along each voxel's channels.  The ring is
      // reused once both consumer warpgroups have read their last stage.
      constexpr int PITCH = (BN / 2 + (36 - BN / 2 % 32) % 32) * 4;  // words = 4 mod 32
      constexpr int ROWS = MT * 64;     // per warpgroup
      constexpr int CPR = BN / 8;       // 16-byte chunks per row
      static_assert(2 * ROWS * PITCH <= 2 * STAGE_BYTES, "staging fits the ring");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const uint32_t stg = smem0 + static_cast<uint32_t>(wg * ROWS * PITCH);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * q;
        float b0 = 0.f, b1 = 0.f;
        if (p.bias != nullptr) {
          if (co < p.Co) b0 = p.bias[co];
          if (co + 1 < p.Co) b1 = p.bias[co + 1];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[i][4 * j + 2 * h] + b0;
            float v1 = acc[i][4 * j + 2 * h + 1] + b1;
            if (p.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            const uint32_t row = static_cast<uint32_t>(i * 64 + wl * 16 + g + 8 * h);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             stg + row * PITCH + static_cast<uint32_t>(8 * j + 2 * q) * 2),
                         "r"(*reinterpret_cast<const uint32_t*>(&v))
                         : "memory");
          }
        }
      }
      if (wg == 0) {
        asm volatile("bar.sync 2, 128;\n" ::: "memory");
      } else {
        asm volatile("bar.sync 3, 128;\n" ::: "memory");
      }
      const int t = tid & 127;
      for (int c = t; c < ROWS * CPR; c += 128) {
        const int row = c / CPR;
        const int ch = c - row * CPR;
        const long long m = m0 + wg * ROWS + row;
        const int co = n0 + ch * 8;
        if (m < p.M && co < p.Co) {
          uint32_t v0, v1, v2, v3;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                       : "r"(stg + static_cast<uint32_t>(row * PITCH + ch * 16)));
          *reinterpret_cast<uint4*>(p.out + m * p.ldo + co) = make_uint4(v0, v1, v2, v3);
        }
      }
    } else {
      // straight from the accumulators: bf16 pairs, or single values
      const bool pairs = p.store == 1;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wg * MT + i) * 64 + wl * 16 + g + 8 * h;
          const long long m = m0 + row;
          if (m < p.M) {
            __nv_bfloat16* orow = p.out + m * p.ldo;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int co = n0 + 8 * j + 2 * q;
              if (co < p.Co) {
                float v0 = acc[i][4 * j + 2 * h];
                float v1 = acc[i][4 * j + 2 * h + 1];
                const bool has1 = co + 1 < p.Co;
                if (p.bias != nullptr) {
                  v0 += p.bias[co];
                  if (has1) v1 += p.bias[co + 1];
                }
                if (p.relu) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
                if (pairs) {
                  *reinterpret_cast<__nv_bfloat162*>(orow + co) =
                      __floats2bfloat162_rn(v0, v1);
                } else {
                  orow[co] = __float2bfloat16(v0);
                  if (has1) orow[co + 1] = __float2bfloat16(v1);
                }
              }
            }
          }
        }
      }
    }
  }
}

template <int BN, int MT>
constexpr int smem_bytes(int stages) {
  return stages * (128 * MT + BN) * ROW_BYTES + 128 * MT * 8 +
         2 * MAX_STAGES * 8 + 1024;
}

template <int BN, int MT>
cudaError_t launch(const Params& p, const CUtensorMap& tmap, cudaStream_t stream) {
  constexpr int BM = 128 * MT;
  const long long tiles_m = (p.M + BM - 1) / BM;
  const long long grid = tiles_m * p.n_tiles_n;
  if (grid <= 0 || grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  conv3d_kernel_bf16_wgmma<BN, MT>
      <<<static_cast<unsigned>(grid), NTHREADS, smem_bytes<BN, MT>(p.stages),
         stream>>>(p, tmap);
  return cudaGetLastError();
}

// cuTensorMapEncodeIm2col, found through the runtime at set-up
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*,
                                 const int*, cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeIm2col encode_im2col = nullptr;
int cuda_version = 0;  // of the installed libcuda

// The im2col map of x for a (kd, kh, kw) VALID window: dimensions
// (C, W, H, D, N), the box of window origins shrunk by k - 1 at the upper
// corner, 64 channels x bm voxels a load, 128-byte swizzle, zeros past the
// tensor (channels past Ci, voxels past the last).
cudaError_t make_im2col_map(CUtensorMap* map, const void* x, long long N, int D, int H,
                            int W, int Ci, long long sN, long long sD, long long sH,
                            long long sW, int kd, int kh, int kw, int bm) {
  if (encode_im2col == nullptr) return cudaErrorNotReady;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(Ci), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[4] = {
      static_cast<cuuint64_t>(sW) * 2, static_cast<cuuint64_t>(sH) * 2,
      static_cast<cuuint64_t>(sD) * 2, static_cast<cuuint64_t>(sN) * 2};
  const int lower[3] = {0, 0, 0};
  const int upper[3] = {-(kw - 1), -(kh - 1), -(kd - 1)};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode_im2col(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides,
      lower, upper, BK, static_cast<cuuint32_t>(bm), steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // libcuda up to 13.1 encodes im2col maps of tensors under 128 KB with a
  // bit set that makes the load fault; CUTLASS clears it the same way
  const long long span = 1 + (N - 1) * sN + (D - 1) * sD + (H - 1) * sH +
                         (W - 1) * sW + (Ci - 1);
  if (cuda_version <= 13010 && span * 2 < 131072)
    reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  return cudaSuccess;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: exact FMAs, 128 x 64 tile, double-buffered cp.async
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 128;       // output voxels per CTA
constexpr int BN = 64;        // output channels per CTA
constexpr int BK = 16;        // channels per chunk
constexpr int NTHREADS = 256; // 8 warps: 4 along M x 2 along N, 32x32 each

// AV: bytes per A copy (16, 8 or 4).
template <int AV>
__global__ void __launch_bounds__(NTHREADS)
    conv3d_kernel_f32(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int Ci, int Co, int Co_pad, int kh, int kw, int taps,
                      long long sN, long long sD, long long sH, long long sW,
                      int Do, int Ho, int Wo, long long M, long long ldo,
                      int relu) {
  constexpr int PAD = 4;          // keeps rows 16-byte aligned
  constexpr int LDA = BK + PAD;   // 80-byte rows: conflict-free reads
  constexpr int LDB = BN + PAD;
  constexpr int EA = AV / 4;
  constexpr int EB = 4;

  __shared__ __align__(16) float As[2][BM][LDA];
  __shared__ __align__(16) float Bs[2][BK][LDB];
  __shared__ long long rowbase[BM];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  for (int r = tid; r < BM; r += NTHREADS)
    rowbase[r] = row_base(m0 + r, M, Do, Ho, Wo, sN, sD, sH, sW);
  __syncthreads();

  const int nci = (Ci + BK - 1) / BK;
  const int KT = taps * nci;

  auto load_stage = [&](int kt, int s) {
    const int tap = kt / nci;
    const int ci0 = (kt - tap * nci) * BK;
    const int dz = tap / (kh * kw);
    const int rem = tap - dz * kh * kw;
    const int dy = rem / kw;
    const int dx = rem - dy * kw;
    const long long toff = dz * sD + dy * sH + dx * sW + ci0;
    constexpr int CPR = BK / EA;
    for (int c = tid; c < BM * CPR; c += NTHREADS) {
      const int r = c / CPR;
      const int kk = (c - r * CPR) * EA;
      const long long base = rowbase[r];
      int valid = base >= 0 ? Ci - ci0 - kk : 0;
      valid = valid < 0 ? 0 : (valid > EA ? EA : valid);
      const float* src = valid > 0 ? x + base + toff + kk : x;
      cp_async<AV>(smem_u32(&As[s][r][kk]), src, valid * 4);
    }
    constexpr int CPRB = BN / EB;
    for (int c = tid; c < BK * CPRB; c += NTHREADS) {
      const int r = c / CPRB;
      const int nn = (c - r * CPRB) * EB;
      const int ci = ci0 + r;
      const int co = n0 + nn;
      const bool ok = ci < Ci && co < Co_pad;
      const float* src =
          ok ? w + (static_cast<long long>(tap) * Ci + ci) * Co_pad + co : w;
      cp_async<16>(smem_u32(&Bs[s][r][nn]), src, ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      load_stage(kt + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[2][2];
      float bv[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        av[mt][0] = As[s][wm + mt * 16 + g][k];
        av[mt][1] = As[s][wm + mt * 16 + g + 8][k];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bv[nt][0] = Bs[s][k][wn + nt * 8 + 2 * t4];
        bv[nt][1] = Bs[s][k][wn + nt * 8 + 2 * t4 + 1];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[mt][nt][0] = fmaf(av[mt][0], bv[nt][0], acc[mt][nt][0]);
          acc[mt][nt][1] = fmaf(av[mt][0], bv[nt][1], acc[mt][nt][1]);
          acc[mt][nt][2] = fmaf(av[mt][1], bv[nt][0], acc[mt][nt][2]);
          acc[mt][nt][3] = fmaf(av[mt][1], bv[nt][1], acc[mt][nt][3]);
        }
    }
    __syncthreads();
  }

  // epilogue: bias + optional ReLU
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long m = m0 + wm + mt * 16 + g + (i >> 1) * 8;
        const int co = n0 + wn + nt * 8 + 2 * t4 + (i & 1);
        if (m < M && co < Co) {
          float v = acc[mt][nt][i];
          if (bias != nullptr) v += bias[co];
          if (relu) v = fmaxf(v, 0.f);
          out[m * ldo + co] = v;
        }
      }
}

template <int AV>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   long long N, int D, int H, int W, int Ci, long long sN,
                   long long sD, long long sH, long long sW, int kd, int kh,
                   int kw, int Co, int Co_pad, long long ldo, int relu,
                   cudaStream_t stream) {
  const int Do = D - kd + 1, Ho = H - kh + 1, Wo = W - kw + 1;
  const long long M = N * Do * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((Co + BN - 1) / BN));
  conv3d_kernel_f32<AV><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(out), Ci, Co, Co_pad, kh, kw, kd * kh * kw, sN, sD,
      sH, sW, Do, Ho, Wo, M, ldo, relu);
  return cudaGetLastError();
}

}  // namespace f32

// every kernel instantiation, for bs_conv3d_init and bs_conv3d_kernel_info
struct KernelEntry {
  const void* fn;
  int dtype;  // 0 = bf16 (wgmma), 1 = fp32
  int bn, bm, av;
};

const KernelEntry* kernel_table(int* n) {
  static const KernelEntry table[] = {
      {reinterpret_cast<const void*>(&tc::conv3d_kernel_bf16_wgmma<64, 2>), 0, 64, 256, 0},
      {reinterpret_cast<const void*>(&tc::conv3d_kernel_bf16_wgmma<152, 2>), 0, 152, 256, 0},
      {reinterpret_cast<const void*>(&tc::conv3d_kernel_bf16_wgmma<256, 1>), 0, 256, 128, 0},
      {reinterpret_cast<const void*>(&f32::conv3d_kernel_f32<16>), 1, f32::BN, f32::BM, 16},
      {reinterpret_cast<const void*>(&f32::conv3d_kernel_f32<8>), 1, f32::BN, f32::BM, 8},
      {reinterpret_cast<const void*>(&f32::conv3d_kernel_f32<4>), 1, f32::BN, f32::BM, 4},
  };
  *n = static_cast<int>(sizeof(table) / sizeof(table[0]));
  return table;
}

}  // namespace

// Once per device, before the first bf16 launch: lets the wgmma kernels
// use the device's whole opt-in shared memory, and finds libcuda's
// tensor-map encoder.  Returns a cudaError_t.
extern "C" int bs_conv3d_init() {
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
  tc::encode_im2col = reinterpret_cast<tc::EncodeIm2col>(fn);
  err = cudaDriverGetVersion(&tc::cuda_version);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = 0;
  const KernelEntry* table = kernel_table(&n);
  for (int i = 0; i < n; ++i) {
    if (table[i].dtype != 0) continue;
    err = cudaFuncSetAttribute(table[i].fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// Kernel instantiation `index`: info = {dtype, BN, BM, AV, registers per
// thread, static shared bytes, max dynamic shared bytes, local (spill)
// bytes}.  Returns a cudaError_t, or -1 past the last instantiation.
extern "C" int bs_conv3d_kernel_info(int index, int* info) {
  int n = 0;
  const KernelEntry* table = kernel_table(&n);
  if (index < 0 || index >= n) return -1;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, table[index].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = table[index].dtype;
  info[1] = table[index].bn;
  info[2] = table[index].bm;
  info[3] = table[index].av;
  info[4] = attr.numRegs;
  info[5] = static_cast<int>(attr.sharedSizeBytes);
  info[6] = attr.maxDynamicSharedSizeBytes;
  info[7] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaSuccess);
}

// Dynamic shared memory a bf16 launch needs, or -1 for an unknown BN.
extern "C" int bs_conv3d_bf16_smem_bytes(int bn, int stages) {
  switch (bn) {
    case 64: return tc::smem_bytes<64, 2>(stages);
    case 152: return tc::smem_bytes<152, 2>(stages);
    case 256: return tc::smem_bytes<256, 1>(stages);
    default: return -1;
  }
}

// bf16 route.  Strides are in elements; the channel stride must be 1 and
// every row start av-byte aligned (av 16, 8, 4, or 2 for scalar loads).
// wp: weights packed by ops/conv3d.py:pack_weights (128-byte-swizzled
// [tap][64-channel chunk][Cout padded to 8][64] bf16); co8 is that padded
// Cout.  bn selects the tile width (64, 152, 256); 2 <= stages <= 8 is the
// ring's depth; tma = 1 loads the A tile through an im2col tensor map
// (needs av = 16 and a window of at most 16 a side), tma = 0 gathers it
// with cp.async.  bias is fp32 or null.  out is NDHWC bf16 with ldo >= Co
// elements between voxels.  store: 2 = 16-byte stores staged through shared
// memory (needs ldo % 8 == 0 and a 16-byte aligned out), 1 = bf16 pairs
// (ldo even), 0 = single values.  Returns the cudaError_t of the launch.
extern "C" int bs_conv3d_bf16(const void* x, const void* wp, const float* bias,
                              void* out, long long N, int D, int H, int W,
                              int Ci, long long sN, long long sD, long long sH,
                              long long sW, int kd, int kh, int kw, int Co,
                              int co8, long long ldo, int relu, int av, int bn,
                              int stages, int store, int tma,
                              void* stream) {
  if (tma && (av != 16 || kd > 16 || kh > 16 || kw > 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (stages < 2 || stages > tc::MAX_STAGES || co8 < Co || co8 % 8 != 0 ||
      ldo < Co || store < 0 || store > 2 || (store == 1 && ldo % 2 != 0) ||
      (store == 2 && (ldo % 8 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wp = static_cast<const uint8_t*>(wp);
  p.bias = bias;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sN = sN; p.sD = sD; p.sH = sH; p.sW = sW; p.ldo = ldo;
  p.Ci = Ci; p.Co = Co; p.co8 = co8; p.kd = kd; p.kh = kh; p.kw = kw;
  p.Do = D - kd + 1; p.Ho = H - kh + 1; p.Wo = W - kw + 1;
  p.M = N * p.Do * p.Ho * p.Wo;
  p.relu = relu; p.stages = stages;
  p.n_tiles_n = (Co + bn - 1) / bn;
  p.av = av; p.store = store; p.tma = tma ? 1 : 0;
  alignas(64) CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (tma) {
    const cudaError_t err = tc::make_im2col_map(&tmap, x, N, D, H, W, Ci, sN, sD, sH, sW,
                                                kd, kh, kw, bn == 256 ? 128 : 256);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return tc::launch<64, 2>(p, tmap, st);
    case 152: return tc::launch<152, 2>(p, tmap, st);
    case 256: return tc::launch<256, 1>(p, tmap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32 route.  w is DHWIO with Cout zero-padded to Co_pad (a multiple of
// 8), contiguous; av is 16, 8 or 4; out has ldo elements between voxels.
// Otherwise as above.
extern "C" int bs_conv3d_f32(const void* x, const void* w, const float* bias,
                             void* out, int av, long long N, int D, int H,
                             int W, int Ci, long long sN, long long sD,
                             long long sH, long long sW, int kd, int kh,
                             int kw, int Co, int Co_pad, long long ldo,
                             int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BS_CONV_ARGS \
  x, w, bias, out, N, D, H, W, Ci, sN, sD, sH, sW, kd, kh, kw, Co, Co_pad, \
      ldo, relu, st
  switch (av) {
    case 16: return f32::launch<16>(BS_CONV_ARGS);
    case 8: return f32::launch<8>(BS_CONV_ARGS);
    case 4: return f32::launch<4>(BS_CONV_ARGS);
    default: break;
  }
#undef BS_CONV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
