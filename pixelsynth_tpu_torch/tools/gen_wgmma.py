"""Write csrc/wgmma_sm90.cuh: one inline-PTX wrapper for each output width
of `wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16` the layer body
uses (the instruction names every accumulator register, so each width is
its own text).

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
// given as shared-memory matrix descriptors, both K-major.  Thread t of
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


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "csrc", "wgmma_sm90.cuh")
    with open(path, "w") as f:
        f.write(HEAD + "".join(one(n) for n in WIDTHS) + "\n}  // namespace lmk\n")
    print(path)


if __name__ == "__main__":
    main()
