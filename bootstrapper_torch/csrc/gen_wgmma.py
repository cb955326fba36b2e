#!/usr/bin/env python3
"""Write ``wgmma_sm90.cuh`` and ``wgmma_s8_sm90.cuh``: one inline-PTX
wrapper per tile width N for

    wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16   (conv3d.cu)
    wgmma.mma_async.sync.aligned.m64nNk32.s32.s8.s8       (qconv3d.cu)

with both operands read from shared memory through descriptors.  The
instruction names every accumulator register (N/2 per thread), so the
operand lists are generated, not written by hand:

    python3 bootstrapper_torch/csrc/gen_wgmma.py

The headers are committed; rerun this after changing ``WIDTHS`` or
``S8_WIDTHS`` (they must match ``TILE_WIDTHS`` in ``ops/conv3d.py`` and in
``ops/quant.py`` and the instantiations in the two ``.cu`` files).  For
s8, N is 8, 16, 24 or a multiple of 16 from 32 to 256 (PTX ISA).
"""

import os

WIDTHS = (64, 152, 256)
S8_WIDTHS = (16, 64, 160, 256)

HEAD = """\
// Generated by gen_wgmma.py; do not edit by hand.
//
// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A and B from shared
// memory descriptors (K-major, no transpose), D += A * B.  Each of the
// 128 threads of a warpgroup holds N/2 accumulators: d[4*j + {0,1}] are
// row lane/4 (+16 * warp), columns 8*j + 2*(lane%4) + {0,1}; d[4*j + {2,3}]
// the same columns of row lane/4 + 8.

#pragma once
#include <stdint.h>

namespace wgmma {

template <int N>
__device__ __forceinline__ void mma_m64k16(float (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b);
"""


def one(n: int) -> str:
    regs = n // 2
    lines = []
    for i in range(0, regs, 8):
        lines.append(", ".join(f"%{j}" for j in range(i, min(i + 8, regs))))
    reg_list = ',"\n      " '.join(lines)
    outs = []
    for i in range(0, regs, 4):
        outs.append(", ".join(f'"+f"(d[{j}])' for j in range(i, min(i + 4, regs))))
    out_list = ",\n        ".join(outs)
    return f"""
template <>
__device__ __forceinline__ void mma_m64k16<{n}>(float (&d)[{regs}],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{regs + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{reg_list}}}, "
      "%{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n"
      "}}\\n"
      : {out_list}
      : "l"(desc_a), "l"(desc_b), "r"(1));
}}
"""


S8_HEAD = """\
// Generated by gen_wgmma.py; do not edit by hand.
//
// wgmma.mma_async m64nNk32, s8 x s8 -> s32, A and B from shared memory
// descriptors (both K-major: 8-bit types take no transpose), D += A * B.
// Each of the 128 threads of a warpgroup holds N/2 accumulators, laid out
// as the bf16 wrappers' (wgmma_sm90.cuh): d[4*j + {0,1}] are row lane/4
// (+16 * warp), columns 8*j + 2*(lane%4) + {0,1}; d[4*j + {2,3}] the same
// columns of row lane/4 + 8.

#pragma once
#include <stdint.h>

namespace wgmma_s8 {

template <int N>
__device__ __forceinline__ void mma_m64k32(int (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b);
"""


def one_s8(n: int) -> str:
    regs = n // 2
    lines = []
    for i in range(0, regs, 8):
        lines.append(", ".join(f"%{j}" for j in range(i, min(i + 8, regs))))
    reg_list = ',"\n      " '.join(lines)
    outs = []
    for i in range(0, regs, 4):
        outs.append(", ".join(f'"+r"(d[{j}])' for j in range(i, min(i + 4, regs))))
    out_list = ",\n        ".join(outs)
    return f"""
template <>
__device__ __forceinline__ void mma_m64k32<{n}>(int (&d)[{regs}],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{regs + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
      "{{{reg_list}}}, "
      "%{regs}, %{regs + 1}, p;\\n"
      "}}\\n"
      : {out_list}
      : "l"(desc_a), "l"(desc_b), "r"(1));
}}
"""


def render() -> str:
    return HEAD + "".join(one(n) for n in WIDTHS) + "\n}  // namespace wgmma\n"


def render_s8() -> str:
    return S8_HEAD + "".join(one_s8(n) for n in S8_WIDTHS) + "\n}  // namespace wgmma_s8\n"


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    for name, text in (("wgmma_sm90.cuh", render()), ("wgmma_s8_sm90.cuh", render_s8())):
        with open(os.path.join(here, name), "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
