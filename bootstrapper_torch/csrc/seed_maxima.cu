// Per-section watershed seed maxima: for every z-section,
//   out = (dist >= windowmax(dist)) & (mask != 0)   as uint8,
// where the window spans [-size/2, size-1-size/2] along y and along x
// and cells outside the section count as -inf.  This equals
// scipy.ndimage.maximum_filter(dist, size) == dist per section, even
// (asymmetric) sizes included.  Max and >= are exact, so the result is
// bit-identical to the plain version.  (NaN distances are not part of the
// contract: fmaxf skips them, a max pool propagates them.)
//
// Replaces the JAX package's Pallas TPU kernels
// ops/pallas_kernels.py:seed_maxima_3d and :seed_maxima (kernel
// _seed_kernel); a single section is the Z = 1 case.
//
// Design: a warp owns a strip of 128 output columns (4 per lane) of one
// section and walks down a block of rows.  Every warp is on its own:
// there is no block-wide barrier.
//   - Each input row of the strip (plus the x halo, from a 4-column
//     boundary) is copied once, by cp.async, into a small ring of rows in
//     shared memory, PF rows ahead of the row being worked on, so the
//     loads of the next rows run under the maxima of the present one.
//     The mask bytes of the output row travel in the same ring slot.
//     Columns outside the section are written as -inf once, into every
//     slot, before the first copy; a row outside the section is written
//     as -inf in place of its copy.
//   - x pass: a lane reads the 16 or 20 floats around its 4 columns as
//     float4s and takes the 4 window maxima with shared partial maxima
//     (size + 6 fmaxf for 4 outputs).
//   - y pass, in registers: a van Herk / Gil-Werman running max over
//     blocks of `size` rows.  A lane keeps the row maxima of the present
//     block (one array of size x 4 registers, turned into suffix maxima in
//     place when the block is full) and a running prefix maximum; the
//     window ending at the newest row is max(suffix, prefix): ~3 fmaxf per
//     output whatever the size, and no shared-memory traffic.
//   - The centre value comes back from the ring; the seeds are written as
//     4-byte words.
//   - All addresses and ring slots are running pointers: recomputed per
//     row they cost several times the instructions of the maxima (31
//     fmaxf a row at size 10), and the kernel is then bound by issue.
// The window size is a template parameter (register arrays need a
// compile-time length): sizes 1..16 are instantiated.  Larger windows take
// the general body: the same strips, rows and ring, with the row maxima of
// the last `size` rows kept in shared memory and O(size) maxima per output.
// Which body runs is decided from `size` before the launch.
//
// Alignment: W need not be a multiple of 4, so rows of a stack start on
// 16-, 8- or 4-byte boundaries.  The copy width of the distances (16, 8 or
// 4 bytes) is chosen per launch from W and the base pointer.  Mask and
// seeds always move as aligned 4-byte words, whatever byte a row starts on
// (see issue_mask): 2-byte accesses cost a third of the kernel's time.
// Nothing is padded or copied on the host.
//
// What bounds it: 6 bytes of HBM traffic per voxel (fp32 in, uint8 mask
// in, uint8 seed out) against ~8 fmaxf and ~6 shared-memory floats, so
// the kernel is bound by bytes: on an H100 a (125,1250,1250) stack takes
// 1.4x the time its bytes need, whatever the window (3, 10 or 16).  The
// design it replaces (a 32x32 tile with a 41x41 halo, 22.8 shared-memory
// loads per voxel, byte-wide stores) was bound by shared-memory issue, at
// 5.2x.  Re-read: the y halo, (size-1)/rows of a block (7% at 128 rows),
// which misses L2, and the x halo, 12/128, which hits it.
//
// Plain C interface, loaded with ctypes (bootstrapper_torch/ops/seeds.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 128;        // output columns of a warp, 4 per lane
constexpr int NWARPS = 4;         // warps (strips) of a CTA
constexpr int PF = 4;             // rows a warp keeps in flight
constexpr int MAX_REG_SIZE = 16;  // largest window of the register body
constexpr int HALO = 8;           // columns kept left of a strip (register body)
constexpr int MWORDS = 36;        // mask words of a ring row (33 used)
constexpr int ROWF = HALO + STRIP + 8;   // distances of a ring row (register body)
constexpr int PITCH = ROWF + MWORDS;     // floats of a ring row (register body)
constexpr int MAX_GRID_Y = 65535;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Mask and seeds are bytes, and a strip's 128 bytes of a row start at any
// address.  Both move as aligned 4-byte words all the same: `a` bytes into
// a word, lane l's 4 bytes are the upper 4 - a bytes of word l and the
// lower a bytes of word l + 1 (a funnel shift).  A mask word may reach up to
// 3 bytes before the stack's first byte or past its last one: it is read,
// never written, and lies in the same aligned word of the allocation.

// Below, `p` is the address of the strip's first byte of a row and `d` the
// section's columns from the lane's first column on (W - x0 - 4 * lane; a
// lane past the row's end has d <= 0).

// Copy the 32 (a = 0) or 33 words that hold the strip's mask bytes of one
// row into a ring slot.  Words that start past the row's end are left out:
// they hold no column of the section.
__device__ __forceinline__ void issue_mask(uint32_t* slot, const uint8_t* p, int d,
                                           int lane) {
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  const uint8_t* word = p - a + 4 * lane;
  if (d + a > 0) cp_async<4>(slot + lane, word);
  if (lane == 0 && a != 0 && d + a > STRIP) cp_async<4>(slot + 32, word + STRIP);
}

// the 4 mask bytes of a lane's columns, from the slot issue_mask filled
__device__ __forceinline__ uint32_t mask_bytes(const uint32_t* slot, const uint8_t* p,
                                               int lane) {
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  return __funnelshift_r(slot[lane], slot[lane + 1], 8 * a);
}

// Seed bytes of a lane's 4 columns, (centre >= window max) & mask, written
// as aligned words: word l takes its lower a bytes from lane l - 1.  Bytes
// are written singly only where a word holds another strip's columns (lane
// 0's word and the strip's last a bytes) or the row's end.
__device__ __forceinline__ void store_seeds(uint8_t* p, int d, int lane, const float4 c,
                                            const float* m, uint32_t mask) {
  uint32_t s = 0;
  s |= (c.x >= m[0] && (mask & 0x000000ffu)) ? 0x00000001u : 0u;
  s |= (c.y >= m[1] && (mask & 0x0000ff00u)) ? 0x00000100u : 0u;
  s |= (c.z >= m[2] && (mask & 0x00ff0000u)) ? 0x00010000u : 0u;
  s |= (c.w >= m[3] && (mask & 0xff000000u)) ? 0x01000000u : 0u;
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  const uint32_t prev = __shfl_up_sync(0xffffffffu, s, 1);
  const uint32_t word = __funnelshift_rc(prev, s, 32 - 8 * a);
  uint8_t* pw = p + 4 * lane - a;
  // bytes [lo, hi) of the word are columns of this strip inside the section
  const int lo = lane == 0 ? a : 0, hi = d + a;
  if (lo == 0 && hi >= 4) {
    *reinterpret_cast<uint32_t*>(pw) = word;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k >= lo && k < hi) pw[k] = static_cast<uint8_t>(word >> (8 * k));
  }
  if (lane == 31 && a != 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k < a && k < hi - 4) pw[4 + k] = static_cast<uint8_t>(s >> (8 * (4 - a + k)));
  }
}

struct Task {
  int x0, y0, rows_out;
  long long zoff;
};

// The strip and row block of this warp; false where the grid's last CTA
// has warps to spare.
__device__ __forceinline__ bool warp_task(Task& t, int z0, int H, int W, int rows,
                                          int n_strips, int n_blocks) {
  const int task = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (task >= n_strips * n_blocks) return false;
  t.x0 = (task % n_strips) * STRIP;
  t.y0 = (task / n_strips) * rows;
  t.rows_out = min(rows, H - t.y0);
  t.zoff = (z0 + static_cast<long long>(blockIdx.y)) * H * W;
  return true;
}

// -- windows of 1..16, the y pass in registers ------------------------------

template <int S, int VEC>
__global__ void __launch_bounds__(NWARPS * 32)
    seed_strip_kernel(const float* __restrict__ dist,
                      const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
                      int z0, int H, int W, int rows, int n_strips, int n_blocks) {
  constexpr int LEFT = S / 2;
  constexpr int RIGHT = S - 1 - LEFT;
  constexpr int L0 = HALO - LEFT;      // ring index of a lane's first window cell
  constexpr int D = PF + RIGHT + 2;    // ring rows: in flight, back to the centre, one spare
  constexpr int G_LO = L0 / VEC;       // copy groups that hold a needed column
  constexpr int G_HI = (HALO + STRIP - 1 + RIGHT) / VEC + 1;
  constexpr int NG = (G_HI - G_LO + 31) / 32;  // copy groups of a lane
  constexpr int Q_LO = L0 / 4;         // float4s of a lane's windows
  constexpr int Q_HI = (HALO + 3 + RIGHT) / 4;
  extern __shared__ __align__(16) float smem[];

  Task t;
  if (!warp_task(t, z0, H, W, rows, n_strips, n_blocks)) return;
  const int lane = threadIdx.x & 31;
  float* const ring = smem + (threadIdx.x >> 5) * (D * PITCH);
  float* const ring_end = ring + D * PITCH;
  auto next = [&](float* slot) { return slot + PITCH == ring_end ? ring : slot + PITCH; };
  const int d = W - t.x0 - 4 * lane;
  const int nrows = t.rows_out + S - 1;  // input rows y0-LEFT .. y0+rows_out-1+RIGHT

  // A lane's copy groups: group k lies goff + 32*VEC*k floats into a slot
  // and holds the columns from gcol + 32*VEC*k on.  Columns outside the
  // section are -inf in every slot, written here once: no copy goes there.
  const int goff = (G_LO + lane) * VEC;
  const int gcol = t.x0 - HALO + goff;
  bool inside[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int col = gcol + 32 * VEC * k;
    const bool needed = G_LO + lane + 32 * k < G_HI;
    inside[k] = needed && col >= 0 && col < W;
    if (needed && !inside[k])
      for (int slot = 0; slot < D; ++slot)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          ring[slot * PITCH + goff + 32 * VEC * k + e] = -INFINITY;
  }

  // Running state of the copies: the section row, its distances at the
  // lane's first group, the mask of the output row whose window it ends.
  int gy = t.y0 - LEFT;
  const float* src = dist + t.zoff + static_cast<long long>(gy) * W + gcol;
  const uint8_t* msrc =
      mask + t.zoff + static_cast<long long>(t.y0 - (S - 1)) * W + t.x0;
  float* p_load = ring;
  auto issue = [&](int r) {  // input row r, and one commit group whatever r
    if (r < nrows) {
      if (gy >= 0 && gy < H) {
#pragma unroll
        for (int k = 0; k < NG; ++k)
          if (inside[k])
            cp_async<4 * VEC>(p_load + goff + 32 * VEC * k, src + 32 * VEC * k);
      } else {  // a row above or below the section
#pragma unroll
        for (int k = 0; k < NG; ++k)
          if (inside[k])
#pragma unroll
            for (int e = 0; e < VEC; ++e) p_load[goff + 32 * VEC * k + e] = -INFINITY;
      }
      if (r >= S - 1)
        issue_mask(reinterpret_cast<uint32_t*>(p_load + ROWF), msrc, d, lane);
    }
    cp_async_commit();
    ++gy, src += W, msrc += W, p_load = next(p_load);
  };

#pragma unroll
  for (int p = 0; p < PF; ++p) issue(p);

  float a[S][4];  // row maxima of the present block, then their suffix maxima
  float pre[4];   // prefix maximum of the present block
  float* p_new = ring;                               // the newest row
  float* p_ctr = ring + ((D - RIGHT) % D) * PITCH;   // the output row's centre
  const long long o0 = t.zoff + static_cast<long long>(t.y0) * W + t.x0;
  const uint8_t* mrow = mask + o0;  // the output row, at the strip's first byte
  uint8_t* orow = out + o0;

  for (int r0 = 0; r0 < nrows; r0 += S) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int r = r0 + i;
      if (r < nrows) {
        issue(r + PF);
        cp_async_wait<PF>();
        __syncwarp();

        // x pass: window maxima of the newest row at the lane's 4 columns
        const float* win = p_new + 4 * lane;
        float v[4 * (Q_HI + 1)];
#pragma unroll
        for (int q = Q_LO; q <= Q_HI; ++q) {
          const float4 f = *reinterpret_cast<const float4*>(win + 4 * q);
          v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
        }
        float h[4];
        if constexpr (S >= 4) {
          float core = v[L0 + 3];
#pragma unroll
          for (int k = L0 + 4; k <= L0 + S - 1; ++k) core = fmaxf(core, v[k]);
          const float p2 = v[L0 + 2];
          const float p1 = fmaxf(v[L0 + 1], p2);
          const float p0 = fmaxf(v[L0], p1);
          const float s1 = v[L0 + S];
          const float s2 = fmaxf(s1, v[L0 + S + 1]);
          const float s3 = fmaxf(s2, v[L0 + S + 2]);
          h[0] = fmaxf(core, p0);
          h[1] = fmaxf(fmaxf(core, p1), s1);
          h[2] = fmaxf(fmaxf(core, p2), s2);
          h[3] = fmaxf(core, s3);
        } else {
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            h[o] = v[L0 + o];
#pragma unroll
            for (int k = 1; k < S; ++k) h[o] = fmaxf(h[o], v[L0 + o + k]);
          }
        }

        // y pass: the window of S rows that ends at the newest row
        float m[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          pre[o] = i == 0 ? h[o] : fmaxf(pre[o], h[o]);
          m[o] = i == S - 1 ? pre[o] : fmaxf(a[(i + 1) % S][o], pre[o]);
          a[i][o] = h[o];
        }
        if (i == S - 1) {
#pragma unroll
          for (int j = S - 2; j >= 1; --j)
#pragma unroll
            for (int o = 0; o < 4; ++o) a[j][o] = fmaxf(a[j][o], a[j + 1][o]);
        }

        if (r >= S - 1) {
          const float4 c = *reinterpret_cast<const float4*>(p_ctr + HALO + 4 * lane);
          const uint32_t mb = mask_bytes(
              reinterpret_cast<const uint32_t*>(p_new + ROWF), mrow, lane);
          store_seeds(orow, d, lane, c, m, mb);
          mrow += W, orow += W;
        }
        p_new = next(p_new), p_ctr = next(p_ctr);
      }
    }
  }
}

// -- any larger window: the row maxima in shared memory ----------------------

// Copy one input row, `groups` groups of VEC floats, into a ring slot, with
// -inf for what lies outside the section; slot[0] is column gx0, `row` is
// null for a row outside.  W % VEC == 0 and gx0 % VEC == 0, so a group
// lies wholly inside or outside.
template <int VEC>
__device__ __forceinline__ void issue_row(float* slot, const float* row, int gx0,
                                          int groups, int W, int lane) {
  for (int g = lane; g < groups; g += 32) {
    const int gx = gx0 + g * VEC;
    float* s = slot + g * VEC;
    if (row != nullptr && gx >= 0 && gx < W) {
      cp_async<4 * VEC>(s, row + gx);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] = -INFINITY;
    }
  }
}

// floats of one warp's shared memory in the general body
__host__ __device__ inline long long general_warp_floats(int left, int right) {
  const int hl = (left + 3) / 4 * 4, hr = (right + 3) / 4 * 4;
  return static_cast<long long>(PF + right + 2) * (hl + STRIP + hr + MWORDS) +
         static_cast<long long>(left + right + 1) * STRIP;
}

template <int VEC>
__global__ void __launch_bounds__(NWARPS * 32)
    seed_general_kernel(const float* __restrict__ dist,
                        const uint8_t* __restrict__ mask,
                        uint8_t* __restrict__ out, int z0, int H, int W, int rows,
                        int n_strips, int n_blocks, int left, int right) {
  extern __shared__ __align__(16) float smem[];
  const int S = left + right + 1;
  const int hl = (left + 3) / 4 * 4, hr = (right + 3) / 4 * 4;
  const int rowf = hl + STRIP + hr;
  const int pitch = rowf + MWORDS;
  const int D = PF + right + 2;

  Task t;
  if (!warp_task(t, z0, H, W, rows, n_strips, n_blocks)) return;
  const int lane = threadIdx.x & 31;
  float* ring = smem + (threadIdx.x >> 5) * general_warp_floats(left, right);
  float* hring = ring + D * pitch;  // [S][STRIP]: x maxima of the last S rows
  const int gx0 = t.x0 - hl;
  const int nrows = t.rows_out + S - 1;
  const float* dplane = dist + t.zoff;

  const uint8_t* mplane = mask + t.zoff;
  const int d = W - t.x0 - 4 * lane;

  auto issue = [&](int r, int slot) {
    const int gy = t.y0 - left + r;
    const float* row =
        (gy >= 0 && gy < H) ? dplane + static_cast<long long>(gy) * W : nullptr;
    issue_row<VEC>(ring + slot * pitch, row, gx0, rowf / VEC, W, lane);
    if (r >= S - 1)
      issue_mask(reinterpret_cast<uint32_t*>(ring + slot * pitch + rowf),
                 mplane + static_cast<long long>(t.y0 + r - (S - 1)) * W + t.x0, d,
                 lane);
  };

  for (int p = 0; p < PF; ++p) {
    if (p < nrows) issue(p, p);
    cp_async_commit();
  }
  int s_new = 0, s_load = PF, s_ctr = D - right, s_h = 0;
  for (int r = 0; r < nrows; ++r) {
    if (r + PF < nrows) issue(r + PF, s_load);
    cp_async_commit();
    cp_async_wait<PF>();
    __syncwarp();

    const float* src = ring + s_new * pitch + 4 * lane + hl - left;
    float h[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int k = 0; k < S + 3; ++k) {
      const float val = src[k];
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (k >= o && k - o < S) h[o] = fmaxf(h[o], val);
    }
    // a lane reads back only its own columns of hring: no barrier needed
    *reinterpret_cast<float4*>(hring + s_h * STRIP + 4 * lane) =
        make_float4(h[0], h[1], h[2], h[3]);

    if (r >= S - 1) {
      float m[4] = {h[0], h[1], h[2], h[3]};
      for (int k = 0; k < S; ++k) {
        const float4 f =
            *reinterpret_cast<const float4*>(hring + k * STRIP + 4 * lane);
        m[0] = fmaxf(m[0], f.x), m[1] = fmaxf(m[1], f.y);
        m[2] = fmaxf(m[2], f.z), m[3] = fmaxf(m[3], f.w);
      }
      const long long orow =
          t.zoff + static_cast<long long>(t.y0 + r - (S - 1)) * W + t.x0;
      const float4 c = *reinterpret_cast<const float4*>(ring + s_ctr * pitch + hl +
                                                        4 * lane);
      const uint32_t mb = mask_bytes(
          reinterpret_cast<const uint32_t*>(ring + s_new * pitch + rowf), mask + orow,
          lane);
      store_seeds(out + orow, d, lane, c, m, mb);
    }
    s_new = s_new + 1 == D ? 0 : s_new + 1;
    s_load = s_load + 1 == D ? 0 : s_load + 1;
    s_ctr = s_ctr + 1 == D ? 0 : s_ctr + 1;
    s_h = s_h + 1 == S ? 0 : s_h + 1;
  }
}

using StripKernel = void (*)(const float*, const uint8_t*, uint8_t*, int, int, int,
                             int, int, int);
using GeneralKernel = void (*)(const float*, const uint8_t*, uint8_t*, int, int, int,
                               int, int, int, int, int);

#define STRIP_ROW(S) \
  { seed_strip_kernel<S, 1>, seed_strip_kernel<S, 2>, seed_strip_kernel<S, 4> }
const StripKernel STRIP_KERNELS[MAX_REG_SIZE][3] = {
    STRIP_ROW(1),  STRIP_ROW(2),  STRIP_ROW(3),  STRIP_ROW(4),
    STRIP_ROW(5),  STRIP_ROW(6),  STRIP_ROW(7),  STRIP_ROW(8),
    STRIP_ROW(9),  STRIP_ROW(10), STRIP_ROW(11), STRIP_ROW(12),
    STRIP_ROW(13), STRIP_ROW(14), STRIP_ROW(15), STRIP_ROW(16)};
const GeneralKernel GENERAL_KERNELS[3] = {
    seed_general_kernel<1>, seed_general_kernel<2>, seed_general_kernel<4>};

}  // namespace

// Once per device, before the first launch: lets the general body use the
// device's whole opt-in shared memory, so that no launch sets it.
// Returns a cudaError_t.
extern "C" int bs_seed_maxima_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int v = 0; v < 3 && err == cudaSuccess; ++v)
    err = cudaFuncSetAttribute(GENERAL_KERNELS[v],
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return static_cast<int>(err);
}

// dist: (Z, H, W) fp32, mask: (Z, H, W) uint8, out: (Z, H, W) uint8, all
// contiguous.  plan (3 ints, written): the floats per copy of distances
// (4, 2 or 1), the body (0: registers, 1: general) and the output rows of
// a warp.  Returns the
// cudaError_t of the launches; cudaErrorInvalidValue for a window whose
// general body does not fit shared memory.
extern "C" int bs_seed_maxima(const float* dist, const uint8_t* mask, uint8_t* out,
                              int Z, int H, int W, int size, void* stream,
                              int* plan) {
  if (size < 1 || Z < 0 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int left = size / 2;
  const int right = size - 1 - left;

  int vec = 4;
  while (vec > 1 && (W % vec || reinterpret_cast<uintptr_t>(dist) % (4 * vec)))
    vec >>= 1;
  const int vi = vec == 4 ? 2 : vec == 2 ? 1 : 0;

  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  // Rows of a warp: long blocks re-read the least y halo, short ones give
  // a small stack enough warps to fill the card (12 per SM).
  const int n_strips = (W + STRIP - 1) / STRIP;
  const int nz = Z < MAX_GRID_Y ? Z : MAX_GRID_Y;
  int rows = 128;
  while (rows > 4 &&
         static_cast<long long>(nz) * n_strips * ((H + rows - 1) / rows) < 12LL * sms)
    rows >>= 1;
  const int n_blocks = (H + rows - 1) / rows;

  const bool general = size > MAX_REG_SIZE;
  int nwarps = NWARPS;
  long long smem = 0;
  if (general) {
    const long long per_warp =
        general_warp_floats(left, right) * static_cast<long long>(sizeof(float));
    if (per_warp > optin) return static_cast<int>(cudaErrorInvalidValue);
    if (per_warp * nwarps > optin) nwarps = static_cast<int>(optin / per_warp);
    smem = per_warp * nwarps;
  } else {
    smem = static_cast<long long>(NWARPS) * (PF + right + 2) * PITCH * sizeof(float);
  }
  plan[0] = vec, plan[1] = general ? 1 : 0, plan[2] = rows;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tasks = n_strips * n_blocks;
  for (int z0 = 0; z0 < Z; z0 += MAX_GRID_Y) {
    const dim3 grid((tasks + nwarps - 1) / nwarps,
                    Z - z0 < MAX_GRID_Y ? Z - z0 : MAX_GRID_Y);
    if (general)
      GENERAL_KERNELS[vi]<<<grid, nwarps * 32, smem, st>>>(
          dist, mask, out, z0, H, W, rows, n_strips, n_blocks, left, right);
    else
      STRIP_KERNELS[size - 1][vi]<<<grid, nwarps * 32, smem, st>>>(
          dist, mask, out, z0, H, W, rows, n_strips, n_blocks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
