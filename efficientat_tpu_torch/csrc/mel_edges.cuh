// The reflect-pad edge frames of K1's output, CUDA C++ for Hopper (sm_90a):
// mel_edges::mel_edges_kernel<NE> and its launch, which
// csrc/mel_kernel.cu::eat_mel_edges exposes.
//
// Replaces the edge patch of the JAX wrapper,
// efficientat_tpu/ops/mel_pallas.py::_edge_frames_logmel (:206) and its
// dynamic_update_slice into the kernel's output (:331-341). K1 multiplies
// frames of the raw wave by the pre-emphasis-folded basis, which sees a
// zero pad past the clip's ends (and, reading the caller's wave in place,
// a window clamped into it); the reference pads the pre-emphasised wave by
// reflection. The frames whose window reaches the pad, frames 0 ..
// ceil(512 / hop) - 1 and those with hop f + 512 > S - 1 (at most 4 a clip
// at hop 320 or 640), are recomputed here from fp32 operands without the
// bf16 split, as JAX's Precision.HIGHEST einsums compute them:
//   xe[t] = x[t + 1] - 0.97 x[t] at the reflected index of the whole wave
//   (t < 0 -> -t, t > S - 2 -> 2 (S - 2) - t), two fp32 roundings as in
//   the plain version (no contraction into an FMA);
//   times the unfolded windowed basis (ops/melspec.py::_dft_basis, 1024 x
//   1026 fp32: 513 cos columns, then 513 sin columns);
//   power over the 513 bins, rounded to fp32, times all n_mels rows of the
//   fp32 banks (513 bins each), (log(x + 1e-5) + 4.5) / 5 in fp32;
// the products and sums in Acc, fp64, so that the result is the fp32
// operands' function to the last fp32 bit or so (2e-7 from its float64
// value). With Acc = float in this layout the edge frames strayed 3.6e-4
// from that value on B = 120 clips of noise, where a near-empty bin under
// a narrow low mel takes the sums' rounding into the log: 8 times as far
// as the plain version's fp32 GEMM (4.4e-5), and over the 1e-4 that the
// whole call is held to against its plain version, for a fifth less time
// (below).
// written into out[b, :, f] of K1's (B, n_mels, n_frames) output, after
// K1's launches on the same stream. Its plain version is
// ops/mel_kernel.py::_patch_edges, whose 2048-sample slivers index the same
// samples (S >= 4096).
//
// What bounds it: the operations. At B = 64 and hop 320 (3 frames a clip)
// the DFT is 64 x 3 x 1024 x 1026 x 2 = 403 MFLOP and the mel product 25
// MFLOP at 128 mels, 6.4 us at 67 TFLOP/s fp32 (12.8 us at the 33.5
// TFLOP/s of fp64 outside the tensor cores); the bytes (the basis once,
// 4.2 MB, the slivers, the banks and 98 KB of output) take 1.4 us at 3.35
// TB/s.
//
// The design: a clip's bins in 1 to 8 blocks (slices), about two blocks
// an SM in all (launch: 8 slices up to B = 33, 5 at B = 64, 3 at B = 120
// on the 132 SMs). Each block forms the clip's NE
// frames once into shared memory (fp64, 32 KB at 4 frames). A bin of its
// slice takes `parts` neighbouring lanes (1 at one slice, up to 8 at
// eight: sample_parts), lane p the samples p, p + parts, ...: it reads
// basis columns k and 513 + k of those rows in batches of 8, the next
// batch's 16 loads in flight while it sums this one's into its frames' re
// and im, the frames read from shared memory (a warp's lanes on
// neighbouring samples: no bank conflict). A bin's lanes sum by shuffles,
// and its first lane writes the power to the clip's scratch row. The
// clip's block that finishes last (a count a clip, which it sets back to
// 0) reads the clip's 513 powers and takes the mel product: each warp
// owns mels, its lanes the bins of a mel's bank row (coalesced, all of a
// row's loads issued together), summed across the warp by shuffles. Any
// bank width takes one launch.
//
// What holds it at 5-20 times its bound (tools/time_k1.py's device times
// on one NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6): the fp32 ->
// fp64 conversion of each basis value a block reads (2 a sample and bin,
// at a sixteenth of the fp32 rate), the L1 wavefronts of its reads (a
// warp's `parts` rows are `parts` cache lines), and the load latency of
// each batch along a thread's walk, which the parts shorten. The steps: a
// block a clip, a lane a bin, fp32 sums a sample at a time: about 0.2 ms
// at B = 8-120; fp64 sums and the next batch in flight: 0.106-0.125 ms,
// about 0.04 of it the mel product's banks read a load at a time; the
// bins in slices, a lane a bin: 0.13-0.21 (no shorter walk); the walk in
// parts (landed): 0.039 ms at B = 8-16, 0.137 at 64, 0.144 at 120 (128
// mels), with Acc = float 0.030-0.031, 0.107-0.108 and 0.104-0.115 (not
// landed: the precision above); a block taking a group of 2 or 4 clips,
// so that a conversion serves more rows: 0.061 / 0.109 at B = 8, 0.092 /
// 0.112 at 64, 0.138 / 0.151 at 120, its registers at 12 rows spilling
// (not landed).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace mel_edges {

constexpr int N_FFT = 1024;
constexpr int N_FREQ = N_FFT / 2 + 1;  // bins with the Nyquist one
constexpr int PAD = N_FFT / 2;         // the reflect pad of each end
constexpr int THREADS = 544;           // 17 warps: a thread a bin, at most
constexpr int MAX_SLICES = 8;          // blocks a clip's bins split into
constexpr int BATCH = 8;               // basis rows a thread loads at a time
constexpr float PREEMPH = 0.97f;
// the type of the frames in shared memory, the DFT's and the mel
// product's products and sums
using Acc = double;

// the bins of each of `slices` blocks of a clip, and the threads that
// share a bin, each taking every parts-th sample: as many as the block's
// threads hold, a power of two up to 8
__host__ __device__ constexpr int slice_width(int slices) {
  return (N_FREQ + slices - 1) / slices;
}
__host__ __device__ constexpr int sample_parts(int slices) {
  return THREADS / slice_width(slices) >= 8   ? 8
         : THREADS / slice_width(slices) >= 4 ? 4
         : THREADS / slice_width(slices) >= 2 ? 2
                                              : 1;
}

// frames 0 .. n_left - 1 and right0 .. right0 + NE - n_left - 1 of clip
// blockIdx.x, bins of slice blockIdx.y of gridDim.y
template <int NE>
__global__ void __launch_bounds__(THREADS)
mel_edges_kernel(const float* __restrict__ x, int S, int hop, int n_frames, int n_left,
                 int right0, const float* __restrict__ basis,  // (N_FFT, 2 N_FREQ)
                 const float* __restrict__ banks,               // (n_mels, N_FREQ)
                 int n_mels, float* __restrict__ out,           // (B, n_mels, n_frames)
                 float* __restrict__ power,                     // (B, NE, N_FREQ)
                 unsigned* __restrict__ done) {                 // (B), 0 between calls
  __shared__ Acc fr[NE][N_FFT];
  __shared__ float pw[NE][N_FREQ];
  __shared__ bool last;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int b = blockIdx.x, slices = gridDim.y;
  const int width = slice_width(slices), parts = sample_parts(slices);
  const int part = tid % parts, k = blockIdx.y * width + tid / parts;
  const bool active = tid / parts < width && k < N_FREQ;
  const float* xb = x + (size_t)b * S;
  float* pb = power + (size_t)b * NE * N_FREQ;
  auto frame = [&](int e) { return e < n_left ? e : right0 + e - n_left; };

  // the frames of the pre-emphasised, reflect-padded wave: sample m of
  // frame f is xe[hop f - PAD + m], reflected at both ends of xe
#pragma unroll 4
  for (int i = tid; i < NE * N_FFT; i += threads) {
    const int e = i / N_FFT, m = i % N_FFT;
    int t = hop * frame(e) - PAD + m;
    t = t < 0 ? -t : t;
    t = t > S - 2 ? 2 * (S - 2) - t : t;
    fr[e][m] = __fsub_rn(__ldg(xb + t + 1), __fmul_rn(PREEMPH, __ldg(xb + t)));
  }
  __syncthreads();

  // bin k, samples part, part + parts, ...: re and im of each frame. The
  // basis comes in batches of BATCH samples, the next batch's loads issued
  // before this one's products; the parts of a bin are neighbouring lanes,
  // summed by shuffles, and the first writes the power
  Acc re[NE], im[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) re[e] = im[e] = 0;
  if (active) {
    const float* col = basis + (size_t)part * 2 * N_FREQ + k;
    const size_t row = (size_t)parts * 2 * N_FREQ;  // a sample of this thread to the next
    float c[BATCH], s[BATCH];
    auto load = [&](int j0, float (&cv)[BATCH], float (&sv)[BATCH]) {
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        cv[j] = __ldg(col + (j0 + j) * row);
        sv[j] = __ldg(col + (j0 + j) * row + N_FREQ);
      }
    };
    auto products = [&](int j0, const float (&cv)[BATCH], const float (&sv)[BATCH]) {
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const Acc cd = cv[j], sd = sv[j];
        const int m = (j0 + j) * parts + part;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          re[e] = fma(fr[e][m], cd, re[e]);
          im[e] = fma(fr[e][m], sd, im[e]);
        }
      }
    };
    const int n = N_FFT / parts;  // this thread's samples
    load(0, c, s);
    for (int j = 0; j < n - BATCH; j += BATCH) {
      float cn[BATCH], sn[BATCH];
      load(j + BATCH, cn, sn);
      products(j, c, s);
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        c[i] = cn[i];
        s[i] = sn[i];
      }
    }
    products(n - BATCH, c, s);
  }
  for (int off = parts / 2; off > 0; off /= 2)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      re[e] += __shfl_xor_sync(0xffffffffu, re[e], off);
      im[e] += __shfl_xor_sync(0xffffffffu, im[e], off);
    }
  if (active && part == 0) {
#pragma unroll
    for (int e = 0; e < NE; ++e) pb[e * N_FREQ + k] = (float)(re[e] * re[e] + im[e] * im[e]);
  }

  // the clip's slice that finishes last takes the mel product of all its
  // bins, and sets the clip's count back to 0 for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + b, 1u) == (unsigned)slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll 4
  for (int i = tid; i < NE * N_FREQ; i += threads) pw[i / N_FREQ][i % N_FREQ] = __ldcg(pb + i);
  if (tid == 0) done[b] = 0;
  __syncthreads();

  // mel m of each frame: a warp a mel, its lanes over the bins, the row's
  // loads all issued before the products
  constexpr int PER_LANE = (N_FREQ + 31) / 32;
  const int warp = tid / 32, lane = tid % 32;
  for (int m = warp; m < n_mels; m += threads / 32) {
    const float* row = banks + (size_t)m * N_FREQ;
    float w[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      w[j] = lane + 32 * j < N_FREQ ? __ldg(row + lane + 32 * j) : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      Acc acc = 0;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (lane + 32 * j < N_FREQ) acc = fma((Acc)pw[e][lane + 32 * j], (Acc)w[j], acc);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0)
        out[((size_t)b * n_mels + m) * n_frames + frame(e)] =
            (logf((float)acc + 1e-5f) + 4.5f) / 5.0f;
    }
  }
}

// x (B, S) f32, the caller's wave; the edge frames 0 .. n_left - 1 and
// right0 .. n_frames - 1 (right0 >= n_left, at most 4 in all; the
// wrapper's ops/melspec.py::edge_frames); basis _dft_basis (1024 x 1026
// f32); banks (n_mels, 513) f32; out (B, n_mels, n_frames) f32, K1's
// output, whose edge columns are overwritten; power (B, edge frames, 513)
// f32 scratch; done (B) u32, zero, and zero again when the launch ends.
// All contiguous on the current device; launches on the same stream may
// share `done`. The bins of a clip in `slices` blocks: about two blocks an
// SM in all (a block a clip leaves most of the card idle at a small
// batch), at most MAX_SLICES.
inline cudaError_t launch(const float* x, int B, int S, int hop, int n_frames, int n_left,
                          int right0, const float* basis, const float* banks, int n_mels,
                          float* out, float* power, unsigned* done, cudaStream_t stream) {
  if (B < 1 || S < 2 * N_FFT || hop < 1 || n_frames < 1 || n_frames > (S - 1) / hop + 1 ||
      n_mels < 1 || n_left < 0 || n_left > n_frames || right0 < n_left)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int slices = std::max(1, std::min(MAX_SLICES, (2 * sms + B - 1) / B));
  const int ne = n_left + (n_frames > right0 ? n_frames - right0 : 0);
  const dim3 grid(B, slices),
      block((slice_width(slices) * sample_parts(slices) + 31) / 32 * 32);
  switch (ne) {
    case 0:
      return cudaSuccess;
    case 1:
      mel_edges_kernel<1><<<grid, block, 0, stream>>>(x, S, hop, n_frames, n_left, right0,
                                                      basis, banks, n_mels, out, power, done);
      break;
    case 2:
      mel_edges_kernel<2><<<grid, block, 0, stream>>>(x, S, hop, n_frames, n_left, right0,
                                                      basis, banks, n_mels, out, power, done);
      break;
    case 3:
      mel_edges_kernel<3><<<grid, block, 0, stream>>>(x, S, hop, n_frames, n_left, right0,
                                                      basis, banks, n_mels, out, power, done);
      break;
    case 4:
      mel_edges_kernel<4><<<grid, block, 0, stream>>>(x, S, hop, n_frames, n_left, right0,
                                                      basis, banks, n_mels, out, power, done);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mel_edges
