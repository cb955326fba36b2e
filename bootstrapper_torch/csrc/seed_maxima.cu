// Per-section watershed seed maxima: for every z-section,
//   out = (dist >= windowmax(dist)) & (mask != 0)   as uint8,
// where the window spans [-size/2, size-1-size/2] along y and along x
// and cells outside the section count as -inf.  This equals
// scipy.ndimage.maximum_filter(dist, size) == dist per section, even
// (asymmetric) sizes included.
//
// Replaces the JAX package's Pallas TPU kernels
// ops/pallas_kernels.py:seed_maxima_3d and :seed_maxima (kernel
// _seed_kernel); a single section is the Z = 1 case.
//
// Design: one CTA per (section, 32x32 output tile).  The tile and its
// asymmetric halo are loaded once into shared memory (-inf outside the
// section), the window max is taken separably (along y into a second
// shared buffer, then along x), and the >= test and the mask test are
// fused into the uint8 store.  Max and >= are exact, so the result is
// bit-identical to the plain version.
//
// What bounds it: ~2*size comparisons per voxel against 6 bytes moved
// (fp32 distance in, uint8 mask in, uint8 seed out), so it is bound by
// bytes; the halo re-read is (1 + (size-1)/32)^2 of the tile and hits L2.
//
// Plain C interface, loaded with ctypes (bootstrapper_torch/ops/seeds.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TY = 32;
constexpr int TX = 32;
constexpr int NTHREADS = 256;
constexpr int MAX_GRID_Z = 65535;

__global__ void __launch_bounds__(NTHREADS)
    seed_maxima_kernel(const float* __restrict__ dist,
                       const uint8_t* __restrict__ mask,
                       uint8_t* __restrict__ out, int z0, int H, int W,
                       int left, int right) {
  extern __shared__ float smem[];
  const int size = left + right + 1;
  const int RY = TY + size - 1;
  const int RX = TX + size - 1;
  float* tile = smem;             // [RY][RX]: tile + halo
  float* ymax = smem + RY * RX;   // [TY][RX]: max along y
  const long long plane = static_cast<long long>(H) * W;
  const long long zoff = (z0 + static_cast<long long>(blockIdx.z)) * plane;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;

  for (int i = threadIdx.x; i < RY * RX; i += NTHREADS) {
    const int ry = i / RX;
    const int rx = i - ry * RX;
    const int gy = y0 - left + ry;
    const int gx = x0 - left + rx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? dist[zoff + static_cast<long long>(gy) * W + gx]
                  : -INFINITY;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TY * RX; i += NTHREADS) {
    const int ty = i / RX;
    const int rx = i - ty * RX;
    float m = tile[ty * RX + rx];
    for (int k = 1; k < size; ++k) m = fmaxf(m, tile[(ty + k) * RX + rx]);
    ymax[i] = m;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TY * TX; i += NTHREADS) {
    const int ty = i / TX;
    const int tx = i - ty * TX;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    if (gy < H && gx < W) {
      const float* row = ymax + ty * RX + tx;
      float m = row[0];
      for (int k = 1; k < size; ++k) m = fmaxf(m, row[k]);
      const float v = tile[(ty + left) * RX + tx + left];
      const long long o = zoff + static_cast<long long>(gy) * W + gx;
      out[o] = (v >= m && mask[o] != 0) ? 1 : 0;
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs for a window of `size`.
extern "C" long long bs_seed_maxima_smem_bytes(int size) {
  const long long rx = TX + size - 1;
  return (static_cast<long long>(TY + size - 1) * rx + TY * rx) *
         static_cast<long long>(sizeof(float));
}

// Once per device, before the first launch: lets the kernel use the
// device's whole opt-in shared memory, so that no launch sets it.
// Returns a cudaError_t.
extern "C" int bs_seed_maxima_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      seed_maxima_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
}

// dist: (Z, H, W) fp32, mask: (Z, H, W) uint8, out: (Z, H, W) uint8, all
// contiguous.  Returns the cudaError_t of the launches (a window too large
// for shared memory fails the launch).
extern "C" int bs_seed_maxima(const float* dist, const uint8_t* mask,
                              uint8_t* out, int Z, int H, int W, int size,
                              void* stream) {
  if (size < 1 || Z < 0 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int left = size / 2;
  const int right = size - 1 - left;
  const long long smem = bs_seed_maxima_smem_bytes(size);
  cudaError_t err = cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int z0 = 0; z0 < Z; z0 += MAX_GRID_Z) {
    const int nz = Z - z0 < MAX_GRID_Z ? Z - z0 : MAX_GRID_Z;
    const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, nz);
    seed_maxima_kernel<<<grid, NTHREADS, smem, st>>>(dist, mask, out, z0, H,
                                                     W, left, right);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
