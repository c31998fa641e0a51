"""Write csrc/wgmma_sm90.cuh: inline-PTX wrappers, for each output width
the layer bodies use, of `wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16`
with A from shared memory (`Wgmma<N>`) and with A from registers
(`WgmmaRS<N>`, the K1 pass of csrc/lmconv_pass.cuh).  The instruction names
every accumulator register, so each width is its own text.

  python3 -m pixelsynth_tpu_torch.tools.gen_wgmma
"""

from __future__ import annotations

import os

WIDTHS = (16, 32, 48, 64, 80, 96, 128, 160)   # F and 2F for F = 16 .. 80

HEAD = """\
// Warpgroup matrix multiply (wgmma) for Hopper (sm_90a), bf16 operands from
// shared memory, f32 sums in registers.  Written by
// pixelsynth_tpu_torch/tools/gen_wgmma.py: edit that, not this file.
//
// Wgmma<N>::mma(d, a, b): d (64 x N, spread over the warpgroup's 128
// threads, N / 2 registers each) += A (64 x 16) @ B (16 x N), A and B
// given as shared-memory matrix descriptors, both K-major.
// WgmmaRS<N>::mma(d, a, b): the same with A from registers: a[0..3] hold
// this thread's bf16 pairs of the warp's 16 rows (16 (t % 128 / 32) on) as
// ldmatrix.x4 leaves them: (row g, k 2q..2q+1), (row g + 8, the same k),
// (row g, k 8 + 2q..), (row g + 8, k 8 + 2q..), g = lane / 4, q = lane % 4.
// A's registers must not change until the product is waited for.  Thread t of
// the warpgroup holds, for j < N / 8 and lane = t % 32:
//   d[4j + 0], d[4j + 1]: row 16 (t / 32) + lane / 4,     columns 8j + 2 (lane % 4) + {0, 1}
//   d[4j + 2], d[4j + 3]: row 16 (t / 32) + lane / 4 + 8, the same columns.

#pragma once

#include <stdint.h>

namespace lmk {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(PENDING) : "memory");
}

template <int N>
struct Wgmma;
template <int N>
struct WgmmaRS;
"""


def one(n: int) -> str:
    regs = n // 2
    names = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return f"""
template <>
struct Wgmma<{n}> {{
  __device__ __forceinline__ static void mma(float (&d)[{regs}], uint64_t a,
                                             uint64_t b) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{names}}}, "
        "%{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n"
        "}}\\n"
        : {outs}
        : "l"(a), "l"(b), "r"(1));
  }}
}};
"""


def one_rs(n: int) -> str:
    regs = n // 2
    names = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    a = ", ".join(f"%{regs + i}" for i in range(4))
    return f"""
template <>
struct WgmmaRS<{n}> {{
  __device__ __forceinline__ static void mma(float (&d)[{regs}],
                                             const uint32_t (&a)[4], uint64_t b) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{regs + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{names}}}, "
        "{{{a}}}, %{regs + 4}, p, 1, 1, 0;\\n"
        "}}\\n"
        : {outs}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }}
}};
"""


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "csrc", "wgmma_sm90.cuh")
    with open(path, "w") as f:
        f.write(HEAD + "".join(one(n) for n in WIDTHS)
                + "".join(one_rs(n) for n in WIDTHS) + "\n}  // namespace lmk\n")
    print(path)


if __name__ == "__main__":
    main()
