// The training banks' tiling, CUDA C++ for Hopper (sm_90a):
// tile_banks::tile_banks_kernel and its launch, which
// csrc/mel_kernel.cu::eat_tile_banks exposes.
//
// K1's mel operand (the banks^T operand of the JAX kernel,
// efficientat_tpu/ops/mel_pallas.py:304, which the Pallas kernel reads as
// it is) is banks^T split into three bf16 parts and pre-tiled for the
// bulk-copy ring of csrc/mel_wgmma.cuh. Serving banks are fixed and tiled
// once on the host (ops/mel_kernel.py::tiled_serving_banks); a training
// call's banks are jittered and made on the device each call, and this
// kernel tiles them there in one launch for all of K1's mel groups, where
// the plain version (ops/mel_kernel.py::_tiled_groups) runs a zero fill, a
// transpose, three splits, a permute, a stack and a copy a group.
//
// Each group of at most 256 mels (ops/mel_kernel.py::mel_groups) is one
// tensor of (16 chunks, 3 halves' parts, 2 k16 products, 16 mel groups, 2
// k halves, 8 mels, 8 bins), halves = 1 at up to 128 mels, else 2; element
// [c, 3 a + p, s, mg, h, r, e] is part p of banks^T[bin 32c + 16s + 8h + e,
// mel 128a + 8mg + r of the group], zero past its mels. Part 0 is bf16(x),
// part p the bf16 of what parts 0 .. p - 1 leave (round to nearest even,
// each difference exact in fp32): bit for bit the plain version's. The
// groups lie one after another in `out`; every group but the last holds
// 256 mels.
//
// What bounds it: the bytes, the banks read once (263 KB at 128 mels) and
// 393 KB of bf16 written a half, 0.2 us at 3.35 TB/s at 128 mels; at that
// size a launch's own cost dominates. The design: one thread an output
// element (writes coalesced, the banks' reads gathered through L1), no
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile_banks {

constexpr int N_FREQ = 513;            // the banks' bins (the Nyquist one unread)
constexpr int HALF = 128;              // mels a half
constexpr int GROUP = 2 * HALF;        // mels a launch of K1
constexpr int SPLIT = 3;               // bf16 parts
constexpr int PLANE = 2 * 16 * 2 * 8 * 8;      // elements of one (chunk, part) tile
constexpr int HALF_ELEMS = 16 * SPLIT * PLANE;  // a half's three parts: 512 x 128 x 3
constexpr int THREADS = 256;

// the elements of the tiled groups of an n_mels bank
inline long long elements(int n_mels) {
  const int full = n_mels / GROUP, rest = n_mels % GROUP;
  return (long long)HALF_ELEMS * (2 * full + (rest == 0 ? 0 : rest <= HALF ? 1 : 2));
}

__global__ void __launch_bounds__(THREADS)
tile_banks_kernel(const float* __restrict__ banks, int n_mels,
                  __nv_bfloat16* __restrict__ out, long long total) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i / (2 * HALF_ELEMS));
  const int local = (int)(i % (2 * HALF_ELEMS));
  const int m0 = g * GROUP, n = min(GROUP, n_mels - m0);
  const int halves = n <= HALF ? 1 : 2;
  const int e = local % 8, r = local / 8 % 8, h = local / 64 % 2, mg = local / 128 % 16;
  const int s = local / 2048 % 2, q = local / PLANE % (SPLIT * halves);
  const int c = local / (PLANE * SPLIT * halves);
  const int a = q / SPLIT, p = q % SPLIT;
  const int bin = 32 * c + 16 * s + 8 * h + e, mel = HALF * a + 8 * mg + r;
  float v = mel < n ? __ldg(banks + (size_t)(m0 + mel) * N_FREQ + bin) : 0.f;
  __nv_bfloat16 part = __float2bfloat16_rn(v);
  for (int j = 0; j < p; ++j) {
    v = v - __bfloat162float(part);
    part = __float2bfloat16_rn(v);
  }
  out[i] = part;
}

// banks (n_mels, 513) f32; out the tiled groups, `total` = elements(n_mels)
// bf16. Both contiguous on the device.
inline cudaError_t launch(const float* banks, int n_mels, void* out, long long total,
                          cudaStream_t stream) {
  if (n_mels < 1 || total != elements(n_mels)) return cudaErrorInvalidValue;
  const long long blocks = (total + THREADS - 1) / THREADS;
  tile_banks_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      banks, n_mels, static_cast<__nv_bfloat16*>(out), total);
  return cudaGetLastError();
}

}  // namespace tile_banks
