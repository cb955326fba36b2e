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
// and walks K in chunks of BK channels of one tap: the A chunk is BK
// contiguous channels of BM input voxels (the tap's shifted window, read
// straight from the NDHWC tensor through per-row base offsets, so strided
// views such as centre crops need no copy), the B chunk is BK x BN of the
// DHWIO weights.  Both are staged in shared memory with cp.async, double
// buffered so the next chunk loads while the current one multiplies.
// bf16 runs on the tensor cores through mma.sync m16n8k16 with fp32
// accumulators; fp32 runs the same tiling with scalar FMAs (exact fp32).
//
// What bounds it: at the U-Net's 300- and 1500-channel levels the conv
// does ~2*27*Cin FLOPs per input byte, far above the H100's ~295 bf16
// FLOP/byte ridge, so it is bound by operations.  This first design
// reaches only a part of the tensor-core peak (no wgmma, no TMA, B
// fragments assembled from 16-bit shared-memory loads); PERF.md keeps its
// time beside the bound.
//
// Plain C interface, loaded with ctypes (bootstrapper_torch/ops/conv3d.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output voxels per CTA
constexpr int BN = 64;        // output channels per CTA
constexpr int NTHREADS = 256; // 8 warps: 4 along M x 2 along N, 32x32 each

template <typename T> struct KChunk;
template <> struct KChunk<__nv_bfloat16> { static constexpr int BK = 32; };
template <> struct KChunk<float> { static constexpr int BK = 16; };

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy BYTES from global to shared; bytes past src_bytes are zero-filled
// (src_bytes == 0 reads nothing and writes zeros).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16& lo,
                                              const __nv_bfloat16& hi) {
  uint32_t l = *reinterpret_cast<const uint16_t*>(&lo);
  uint32_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

__device__ __forceinline__ void zero_elem(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}
__device__ __forceinline__ void zero_elem(float* p) { *p = 0.f; }

// AV: bytes per A copy (16, 8 or 4 through cp.async; 2 = scalar bf16
// loads, for channel counts or strides that are not 4-byte multiples).
template <typename T, int AV>
__global__ void __launch_bounds__(NTHREADS)
    conv3d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out,
                  int Ci, int Co, int Co_pad, int kh, int kw, int taps,
                  long long sN, long long sD, long long sH, long long sW,
                  int Do, int Ho, int Wo, long long M, int relu) {
  constexpr int BK = KChunk<T>::BK;
  constexpr int PAD = 16 / sizeof(T);  // keeps rows 16-byte aligned
  constexpr int LDA = BK + PAD;        // 80-byte rows: conflict-free frags
  constexpr int LDB = BN + PAD;
  constexpr int EA = AV / sizeof(T) > 0 ? AV / sizeof(T) : 1;
  constexpr int EB = 16 / sizeof(T);

  __shared__ __align__(16) T As[2][BM][LDA];
  __shared__ __align__(16) T Bs[2][BK][LDB];
  __shared__ long long rowbase[BM];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  for (int r = tid; r < BM; r += NTHREADS) {
    const long long m = m0 + r;
    long long base = -1;
    if (m < M) {
      long long t = m;
      const long long xo = t % Wo;
      t /= Wo;
      const long long yo = t % Ho;
      t /= Ho;
      const long long zo = t % Do;
      const long long n = t / Do;
      base = n * sN + zo * sD + yo * sH + xo * sW;
    }
    rowbase[r] = base;
  }
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
      T* dst = &As[s][r][kk];
      const T* src = valid > 0 ? x + base + toff + kk : x;
      if constexpr (AV >= 4) {
        cp_async<AV>(dst, src, valid * static_cast<int>(sizeof(T)));
      } else {
        if (valid > 0) *dst = *src;
        else zero_elem(dst);
      }
    }
    constexpr int CPRB = BN / EB;
    for (int c = tid; c < BK * CPRB; c += NTHREADS) {
      const int r = c / CPRB;
      const int nn = (c - r * CPRB) * EB;
      const int ci = ci0 + r;
      const int co = n0 + nn;
      const bool ok = ci < Ci && co < Co_pad;
      const T* src =
          ok ? w + (static_cast<long long>(tap) * Ci + ci) * Co_pad + co : w;
      cp_async<16>(&Bs[s][r][nn], src, ok ? 16 : 0);
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

    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 16) {
        uint32_t a[2][4];
        uint32_t b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* p0 = &As[s][wm + mt * 16 + g][k0 + 2 * t4];
          const T* p1 = &As[s][wm + mt * 16 + g + 8][k0 + 2 * t4];
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p0);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p1);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn + nt * 8 + g;
          const int k = k0 + 2 * t4;
          b[nt][0] = pack_bf16(Bs[s][k][c], Bs[s][k + 1][c]);
          b[nt][1] = pack_bf16(Bs[s][k + 8][c], Bs[s][k + 9][c]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    } else {
      // fp32: the same accumulator layout as the mma path, by FMAs
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float av[2][2];
        float bv[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          av[mt][0] = static_cast<float>(As[s][wm + mt * 16 + g][k]);
          av[mt][1] = static_cast<float>(As[s][wm + mt * 16 + g + 8][k]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bv[nt][0] = static_cast<float>(Bs[s][k][wn + nt * 8 + 2 * t4]);
          bv[nt][1] = static_cast<float>(Bs[s][k][wn + nt * 8 + 2 * t4 + 1]);
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
    }
    __syncthreads();
  }

  // epilogue: fp32 bias + optional ReLU, one rounding to the output type
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
          store_out(out + m * Co + co, v);
        }
      }
}

template <typename T, int AV>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   long long N, int D, int H, int W, int Ci, long long sN,
                   long long sD, long long sH, long long sW, int kd, int kh,
                   int kw, int Co, int Co_pad, int relu, cudaStream_t stream) {
  const int Do = D - kd + 1, Ho = H - kh + 1, Wo = W - kw + 1;
  const long long M = N * Do * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((Co + BN - 1) / BN));
  conv3d_kernel<T, AV><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), Ci, Co, Co_pad, kh, kw, kd * kh * kw, sN, sD, sH,
      sW, Do, Ho, Wo, M, relu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  Strides are in elements; the channel stride
// must be 1.  w is DHWIO with Cout zero-padded to Co_pad (a multiple of
// 8), contiguous.  bias is fp32 or null.  out is contiguous NDHWC.
// Returns the cudaError_t of the launch.
extern "C" int bs_conv3d_ndhwc(const void* x, const void* w, const float* bias,
                               void* out, int dtype, int av, long long N,
                               int D, int H, int W, int Ci, long long sN,
                               long long sD, long long sH, long long sW,
                               int kd, int kh, int kw, int Co, int Co_pad,
                               int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BS_CONV_ARGS \
  x, w, bias, out, N, D, H, W, Ci, sN, sD, sH, sW, kd, kh, kw, Co, Co_pad, \
      relu, st
  if (dtype == 0) {
    switch (av) {
      case 16: return launch<__nv_bfloat16, 16>(BS_CONV_ARGS);
      case 8: return launch<__nv_bfloat16, 8>(BS_CONV_ARGS);
      case 4: return launch<__nv_bfloat16, 4>(BS_CONV_ARGS);
      case 2: return launch<__nv_bfloat16, 2>(BS_CONV_ARGS);
      default: break;
    }
  } else if (dtype == 1) {
    switch (av) {
      case 16: return launch<float, 16>(BS_CONV_ARGS);
      case 8: return launch<float, 8>(BS_CONV_ARGS);
      case 4: return launch<float, 4>(BS_CONV_ARGS);
      default: break;
    }
  }
#undef BS_CONV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
