// VALID stride-1 3D convolution on int8 operands: NDHWC s8 activations x
// packed s8 weights -> int32 accumulators -> acc * (sx * sw[co]) (+ bias)
// (ReLU), stored as bf16 or fp32.  Beside it, the two passes that make the
// s8 activations: the tensor's absolute maximum, and the quantization itself.
//
// Replaces no Pallas kernel: the JAX package's int8 path
// (its ops/quant.py:qconv, lines 58-65) hands an s8 x s8 -> s32
// conv_general_dilated to XLA.  PyTorch has no int8 convolution on CUDA, and
// emulating the s8 products in a float type would make the int8 path slower
// than the bf16 one it exists to beat, so the port's is this kernel
// (ops/quant.py:qconv_cuda).
//
// Quantization (bs_s8_amax, bs_s8_quantize), as ops/quant.py:quantize
// computes it: sx = max(amax|x|, 1e-30) / 127 in fp32, q = rint(x / sx) by
// IEEE division (ties to even), clipped to +-127.  The amax is one pass
// with a warp and block reduction and one atomicMax per block on the
// float's bits (non-negative floats order as their bits do); the
// quantization writes the s8 tensor contiguous with its channels padded
// to the conv's pitch Cp (a multiple of the copy width), zeros past Ci.
// Both walk voxels with a warp, or 4 lanes, per voxel.
//
// The conv (qconv3d_kernel): an implicit GEMM.  Rows M are output voxels,
// columns output channels, and K runs over (tap, channel) with each tap's
// channels padded to Cp, the whole padded to BK: k = tap * Cp + c, the
// layout ops/quant.py:pack_qweights gives the weights ([Co][Kp] s8, K
// contiguous).  A CTA owns a 128 x 64 tile and walks K in 64-byte chunks
// through a 3-stage cp.async ring: the A chunk is gathered row by row from
// the shifted windows (VEC-byte copies, 16 where Cp is a multiple of 16,
// else 4; a copy never crosses a tap), the B chunk is 16-byte copies of
// the packed rows.  Eight warps, 4 x 2, each own 32 x 32 of the tile and
// run mma.sync.aligned.m16n8k32 s8 (two k32 steps a chunk), fragments read
// as 32-bit words from shared rows padded to 80 bytes, which puts the
// eight rows of a fragment on distinct banks.  The epilogue rescales in
// fp32 with explicitly rounded products (no contraction), so that it
// equals the plain version bit for bit, adds the fp32 bias, applies the
// ReLU and stores single values, masked at the ragged M and Co edges.
//
// What bounds it: at the 300- and 1500-channel levels a 3x3x3 conv does
// ~54*Cin operations per input byte, far above the H100's ~590 int8
// op/byte ridge (1979 TOPS over 3.35 TB/s), so it is bound by operations;
// the 1x1 residuals and the narrow first levels by bytes.  mma.sync reaches
// only part of the int8 peak, which needs wgmma (PERF.md keeps each
// shape's time beside its bound; the wgmma form is later work).
//
// Plain C interface, loaded with ctypes (bootstrapper_torch/ops/quant.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output voxels per CTA tile
constexpr int BN = 64;       // output channels per CTA tile
constexpr int BK = 64;       // bytes of K per chunk
constexpr int ROW = BK + 16; // shared row pitch: conflict-free fragments
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;

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

// BYTES from global to shared; src_bytes == 0 reads nothing, writes zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t smem, const void* gmem, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem), "l"(gmem),
                 "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// ---------------------------------------------------------------------------
// quantization
// ---------------------------------------------------------------------------

// Geometry of a strided NDHWC tensor (channel stride 1).
struct Tensor5 {
  const void* p;
  long long sN, sD, sH, sW;
  int N, D, H, W, C;
};

__device__ __forceinline__ long long voxel_offset(const Tensor5& t, long long v) {
  long long r = v;
  const long long x = r % t.W;
  r /= t.W;
  const long long y = r % t.H;
  r /= t.H;
  const long long z = r % t.D;
  const long long n = r / t.D;
  return n * t.sN + z * t.sD + y * t.sH + x * t.sW;
}

// Blocks of 32 x 8 threads; a warp row takes 32 / LPV voxels at a time,
// LPV lanes walking each voxel's channels (LPV 4 for narrow tensors, so
// that a 1- or 4-channel voxel does not leave 28 lanes idle).
template <int LPV>
__device__ __forceinline__ long long first_voxel() {
  return (static_cast<long long>(blockIdx.x) * 8 + threadIdx.y) * (32 / LPV) + threadIdx.x / LPV;
}

template <int LPV>
__device__ __forceinline__ long long voxel_step() {
  return static_cast<long long>(gridDim.x) * 8 * (32 / LPV);
}

template <typename T, int LPV>
__global__ void __launch_bounds__(256) s8_amax_kernel(Tensor5 t, unsigned int* amax_bits) {
  const T* x = static_cast<const T*>(t.p);
  const long long voxels = static_cast<long long>(t.N) * t.D * t.H * t.W;
  float m = 0.f;
  for (long long v = first_voxel<LPV>(); v < voxels; v += voxel_step<LPV>()) {
    const T* row = x + voxel_offset(t, v);
    for (int c = threadIdx.x % LPV; c < t.C; c += LPV) m = fmaxf(m, fabsf(to_float(row[c])));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  if (threadIdx.x == 0) part[threadIdx.y] = m;
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x == 0) {
    float b = part[0];
    for (int i = 1; i < 8; ++i) b = fmaxf(b, part[i]);
    atomicMax(amax_bits, __float_as_uint(b));
  }
}

// xq[v][c] = clip(rint(x / sx), -127, 127) for c < C, 0 for C <= c < Cp;
// the block (0, 0) thread (0, 0) also stores sx.
template <typename T, int LPV>
__global__ void __launch_bounds__(256) s8_quantize_kernel(Tensor5 t, int Cp,
                                                          const unsigned int* amax_bits,
                                                          float* sx_out, int8_t* xq) {
  const T* x = static_cast<const T*>(t.p);
  const float sx = __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-30f), 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) *sx_out = sx;
  const long long voxels = static_cast<long long>(t.N) * t.D * t.H * t.W;
  for (long long v = first_voxel<LPV>(); v < voxels; v += voxel_step<LPV>()) {
    const T* row = x + voxel_offset(t, v);
    int8_t* out = xq + v * Cp;
    for (int c = threadIdx.x % LPV; c < Cp; c += LPV) {
      int q = 0;
      if (c < t.C) {
        const float r = rintf(__fdiv_rn(to_float(row[c]), sx));
        q = static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
      }
      out[c] = static_cast<int8_t>(q);
    }
  }
}

// ---------------------------------------------------------------------------
// the conv
// ---------------------------------------------------------------------------

struct Params {
  const int8_t* x;   // (N, D, H, W, Cp) contiguous
  const int8_t* wp;  // (Co, Kp): k = tap * Cp + c
  const float* sx;   // one value
  const float* sw;   // (Co)
  const float* bias; // (Co) or null
  void* out;         // NDHWC, ldo elements between voxels
  long long sN, sD, sH, sW, M, ldo;
  int Cp, Co, kh, kw, Do, Ho, Wo, Kreal, Kp, relu, n_tiles_n;
};

template <int VEC, typename OUT>
__global__ void __launch_bounds__(NTHREADS) qconv3d_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[STAGES][BM * ROW];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * ROW];

  const int tid = threadIdx.x;
  const long long bid = blockIdx.x;  // Co tiles fastest: they share A rows
  const int n0 = static_cast<int>(bid % p.n_tiles_n) * BN;
  const long long m0 = (bid / p.n_tiles_n) * BM;

  // A loader: VPR copies of VEC bytes per 64-byte row, RPP rows per pass
  constexpr int VPR = BK / VEC;
  constexpr int RPP = NTHREADS / VPR;
  constexpr int PASSES = BM / RPP;
  const int v = tid % VPR;
  const int r0 = tid / VPR;
  long long base[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const long long m = m0 + r0 + i * RPP;
    if (m < p.M) {
      long long t = m;
      const long long xo = t % p.Wo;
      t /= p.Wo;
      const long long yo = t % p.Ho;
      t /= p.Ho;
      const long long zo = t % p.Do;
      const long long n = t / p.Do;
      base[i] = n * p.sN + zo * p.sD + yo * p.sH + xo * p.sW;
    } else {
      base[i] = -1;
    }
  }
  const int per_tap = p.Cp / VEC;
  const int nk = p.Kp / BK;

  auto load = [&](int stage, int kc) {
    const int kv = kc * VPR + v;  // this thread's VEC-byte group along K
    long long off = -1;
    if (kv * VEC < p.Kreal) {
      const int tap = kv / per_tap;
      const int c = (kv - tap * per_tap) * VEC;
      const int dx = tap % p.kw;
      const int t2 = tap / p.kw;
      const int dy = t2 % p.kh;
      const int dz = t2 / p.kh;
      off = dz * p.sD + dy * p.sH + dx * p.sW + c;
    }
    const uint32_t a_s = smem_u32(&As[stage][0]);
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const bool ok = off >= 0 && base[i] >= 0;
      const int8_t* src = ok ? p.x + base[i] + off : p.x;
      cp_async<VEC>(a_s + (r0 + i * RPP) * ROW + v * VEC, src, ok ? VEC : 0);
    }
    constexpr int QPR = BK / 16;  // 16-byte copies per B row
#pragma unroll
    for (int j = tid; j < BN * QPR; j += NTHREADS) {
      const int n = j / QPR;
      const int q = j % QPR;
      const bool ok = n0 + n < p.Co;
      const int8_t* src =
          ok ? p.wp + static_cast<long long>(n0 + n) * p.Kp + static_cast<long long>(kc) * BK + q * 16
             : p.wp;
      cp_async<16>(smem_u32(&Bs[stage][n * ROW + q * 16]), src, ok ? 16 : 0);
    }
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp % 4;  // 32-row slice of the tile
  const int wn = warp / 4;  // 32-column slice
  const int g = lane >> 2;
  const int t4 = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk kc landed for all; chunk kc-1's stage is free
    const int pre = kc + STAGES - 1;
    if (pre < nk) load(pre % STAGES, pre);
    cp_async_commit();
    const int8_t* a = As[kc % STAGES];
    const int8_t* b = Bs[kc % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* ar = a + (wm * 32 + mi * 16 + g) * ROW + ks + 4 * t4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(ar);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * ROW);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * ROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* br = b + (wn * 32 + ni * 8 + g) * ROW + ks + 4 * t4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(br);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(br + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  const float sx = *p.sx;
  OUT* out = static_cast<OUT*>(p.out);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + wn * 32 + ni * 8 + 2 * t4 + e;
      if (co >= p.Co) continue;
      const float scale = __fmul_rn(sx, p.sw[co]);
      const float bias = p.bias ? p.bias[co] : 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm * 32 + mi * 16 + g + 8 * h;
          if (m >= p.M) continue;
          float val = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), scale);
          if (p.bias) val = __fadd_rn(val, bias);
          if (p.relu) val = fmaxf(val, 0.f);
          if constexpr (sizeof(OUT) == 2) {
            out[m * p.ldo + co] = __float2bfloat16_rn(val);
          } else {
            out[m * p.ldo + co] = val;
          }
        }
      }
    }
  }
}

struct KernelEntry {
  const void* fn;
  int vec, out_bf16;
};

const KernelEntry* kernel_table(int* n) {
  static const KernelEntry table[] = {
      {reinterpret_cast<const void*>(&qconv3d_kernel<16, __nv_bfloat16>), 16, 1},
      {reinterpret_cast<const void*>(&qconv3d_kernel<4, __nv_bfloat16>), 4, 1},
      {reinterpret_cast<const void*>(&qconv3d_kernel<16, float>), 16, 0},
      {reinterpret_cast<const void*>(&qconv3d_kernel<4, float>), 4, 0},
  };
  *n = static_cast<int>(sizeof(table) / sizeof(table[0]));
  return table;
}

Tensor5 make_tensor(const void* x, int N, int D, int H, int W, int C, long long sN, long long sD,
                    long long sH, long long sW) {
  Tensor5 t;
  t.p = x;
  t.N = N; t.D = D; t.H = H; t.W = W; t.C = C;
  t.sN = sN; t.sD = sD; t.sH = sH; t.sW = sW;
  return t;
}

// Blocks for `voxels` at 8 * (32 / LPV) voxels a block pass, at most 64 a SM.
unsigned grid_for(long long voxels, int lpv) {
  const long long per_block = 8LL * (32 / lpv);
  const long long blocks = (voxels + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < 132 * 64 ? (blocks > 0 ? blocks : 1) : 132 * 64);
}

// LPV: 4 lanes a voxel up to 16 channels, else a warp.
int lanes_per_voxel(int channels) { return channels <= 16 ? 4 : 32; }

}  // namespace

// amax_bits (one uint32, zeroed by the caller) <- max(its value, the bits
// of max |x|) over a strided NDHWC tensor (channel stride 1); bf16 = 1
// for bf16 x, 0 for fp32.  Returns the cudaError_t of the launch.
extern "C" int bs_s8_amax(const void* x, int bf16, int N, int D, int H, int W, int C,
                          long long sN, long long sD, long long sH, long long sW,
                          void* amax_bits, void* stream) {
  const Tensor5 t = make_tensor(x, N, D, H, W, C, sN, sD, sH, sW);
  const long long voxels = static_cast<long long>(N) * D * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  unsigned int* bits = static_cast<unsigned int*>(amax_bits);
  const int lpv = lanes_per_voxel(C);
  const unsigned grid = grid_for(voxels, lpv);
  if (bf16) {
    if (lpv == 4) s8_amax_kernel<__nv_bfloat16, 4><<<grid, block, 0, st>>>(t, bits);
    else s8_amax_kernel<__nv_bfloat16, 32><<<grid, block, 0, st>>>(t, bits);
  } else {
    if (lpv == 4) s8_amax_kernel<float, 4><<<grid, block, 0, st>>>(t, bits);
    else s8_amax_kernel<float, 32><<<grid, block, 0, st>>>(t, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq (N, D, H, W, Cp) s8 contiguous <- x quantized with sx from amax_bits
// (bs_s8_amax's result, of x or of a tensor x is a crop of); sx_out gets
// sx.  Cp >= C.  Returns the cudaError_t of the launch.
extern "C" int bs_s8_quantize(const void* x, int bf16, int N, int D, int H, int W, int C,
                              long long sN, long long sD, long long sH, long long sW, int Cp,
                              const void* amax_bits, void* sx_out, void* xq, void* stream) {
  if (Cp < C) return static_cast<int>(cudaErrorInvalidValue);
  const Tensor5 t = make_tensor(x, N, D, H, W, C, sN, sD, sH, sW);
  const long long voxels = static_cast<long long>(N) * D * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const unsigned int* bits = static_cast<const unsigned int*>(amax_bits);
  float* sx = static_cast<float*>(sx_out);
  int8_t* q = static_cast<int8_t*>(xq);
  const int lpv = lanes_per_voxel(Cp);
  const unsigned grid = grid_for(voxels, lpv);
  if (bf16) {
    if (lpv == 4) s8_quantize_kernel<__nv_bfloat16, 4><<<grid, block, 0, st>>>(t, Cp, bits, sx, q);
    else s8_quantize_kernel<__nv_bfloat16, 32><<<grid, block, 0, st>>>(t, Cp, bits, sx, q);
  } else {
    if (lpv == 4) s8_quantize_kernel<float, 4><<<grid, block, 0, st>>>(t, Cp, bits, sx, q);
    else s8_quantize_kernel<float, 32><<<grid, block, 0, st>>>(t, Cp, bits, sx, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// The s8 conv.  xq: (N, D, H, W, Cp) s8 contiguous, Cp a multiple of vec
// (16 or 4); wp: (Co, Kp) s8 packed by ops/quant.py:pack_qweights, Kp a
// multiple of 64 and >= kd*kh*kw*Cp; sx: one fp32; sw: Co fp32; bias: Co
// fp32 or null; out: NDHWC bf16 (out_bf16 = 1) or fp32 with ldo >= Co
// elements between voxels.  Returns the cudaError_t of the launch.
extern "C" int bs_qconv3d(const void* xq, const void* wp, const void* sx, const void* sw,
                          const void* bias, void* out, int out_bf16, int N, int D, int H, int W,
                          int Cp, int vec, int kd, int kh, int kw, int Co, int Kp, long long ldo,
                          int relu, void* stream) {
  const int Kreal = kd * kh * kw * Cp;
  if ((vec != 16 && vec != 4) || Cp % vec != 0 || Kp % BK != 0 || Kp < Kreal || ldo < Co ||
      D < kd || H < kh || W < kw || Co <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(xq);
  p.wp = static_cast<const int8_t*>(wp);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.sW = Cp;
  p.sH = static_cast<long long>(W) * Cp;
  p.sD = p.sH * H;
  p.sN = p.sD * D;
  p.Cp = Cp; p.Co = Co; p.kh = kh; p.kw = kw;
  p.Do = D - kd + 1; p.Ho = H - kh + 1; p.Wo = W - kw + 1;
  p.M = static_cast<long long>(N) * p.Do * p.Ho * p.Wo;
  p.ldo = ldo; p.Kreal = Kreal; p.Kp = Kp; p.relu = relu;
  p.n_tiles_n = (Co + BN - 1) / BN;
  const long long blocks = (p.M + BM - 1) / BM * p.n_tiles_n;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (out_bf16) {
    if (vec == 16) qconv3d_kernel<16, __nv_bfloat16><<<grid, NTHREADS, 0, st>>>(p);
    else qconv3d_kernel<4, __nv_bfloat16><<<grid, NTHREADS, 0, st>>>(p);
  } else {
    if (vec == 16) qconv3d_kernel<16, float><<<grid, NTHREADS, 0, st>>>(p);
    else qconv3d_kernel<4, float><<<grid, NTHREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Conv kernel instantiation `index`: info = {copy width, bf16 out,
// registers per thread, static shared bytes, local (spill) bytes}.
// Returns a cudaError_t, or -1 past the last instantiation.
extern "C" int bs_qconv3d_kernel_info(int index, int* info) {
  int n = 0;
  const KernelEntry* table = kernel_table(&n);
  if (index < 0 || index >= n) return -1;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, table[index].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = table[index].vec;
  info[1] = table[index].out_bf16;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.sharedSizeBytes);
  info[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaSuccess);
}
