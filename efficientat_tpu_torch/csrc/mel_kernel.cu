// K1 — fused log-mel front end, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel efficientat_tpu/ops/mel_pallas.py::_mel_kernel
// and the parts of its wrapper, stft_log_mel_pallas, that run on the device.
// A K1 call (ops/mel_kernel.py::stft_log_mel) is these kernels alone:
//   eat_tile_banks (training: the jittered banks; serving banks are tiled
//     once on the host): the banks^T operand in three bf16 parts, tiled for
//     every mel group (csrc/tile_banks.cuh);
//   eat_mel_log_wgmma, a launch a mel group: for one clip and one tile of
//     frames, frames of the caller's RAW wave, read in place (frame i is
//     samples [hop*i - 512, hop*i + 512), its window clamped into [0, S))
//     times the pre-emphasis-folded, windowed rDFT basis (1024 x 1024: 512
//     cos columns, then 512 sin columns, no Nyquist bin) -> power re^2 +
//     im^2 -> times banks^T (512 x n_mels) -> (log(x + 1e-5) + 4.5) / 5,
//     written into the (B, n_mels, n_frames) output;
//   eat_mel_edges: the few frames whose window reaches the reflect pad,
//     recomputed from the fp32 operands (sums in fp64) and written over
//     K1's (csrc/mel_edges.cuh),
//     as the JAX wrapper patches them (mel_pallas.py:206, :331-341).
// The frames, the projection and the power spectrum never reach device memory.
//
// The main kernel is the Hopper design of csrc/mel_wgmma.cuh, which describes it
// (wgmma DFT, the basis through a bulk-copy ring, the mel product on the
// tensor cores at fp32's precision): mel_kernel_wgmma<2, false, PASSES,
// 128, MELS>, PASSES 3 (bf16x3, the serving and training default: the JAX
// package's 3-pass split, mel_pallas.py:185-189) or 6 (fp32: the six bf16
// products the TPU's MXU runs for Precision.HIGHEST, mel_pallas.py:190-192),
// MELS 128 or 256, the narrowest that holds the launch's mels. The wrapper
// picks the route (ops/mel_kernel.py::k1_route) and computes a bank wider
// than 256 mels in launches of at most 256, each writing its rows of the
// output and redoing the DFT.

#include <cuda_runtime.h>

#include "mel_edges.cuh"
#include "mel_wgmma.cuh"
#include "tile_banks.cuh"

namespace {

template <int PASSES>
int launch_mels(const float* wave, int B, int row_len, int hop, int n_frames, int lead,
                int max_start, const void* b0, const void* b1, const void* b2, const void* mel,
                int n_mels, float* out, int out_mels, void* stream) {
  if (n_mels <= mel_wgmma::MAX_MELS)
    return (int)mel_wgmma::launch<false, PASSES>(wave, B, row_len, hop, n_frames, 128, lead,
                                                 max_start, b0, b1, b2, mel, n_mels, out_mels,
                                                 out, stream);
  return (int)mel_wgmma::launch<false, PASSES, 2 * mel_wgmma::MAX_MELS>(
      wave, B, row_len, hop, n_frames, 128, lead, max_start, b0, b1, b2, mel, n_mels, out_mels,
      out, stream);
}

}  // namespace

// One 128-frame sub-tile a block, on mel_kernel_wgmma<2, false, 3, 128,
// MELS> (parts 2: bf16x3) or <2, false, 6, 128, MELS> (parts 3: fp32), MELS
// 128 at n_mels <= 128 and 256 at 129-256: wave (B, row_len) f32, the
// caller's raw wave (row_len a multiple of 4: its length rounded up where
// it is not), frame i at wave[:, clamp(hop * i - lead, 0, max_start)]
// (lead 512, max_start the last multiple of 8 at or below S - 1024 for a
// clip of S samples; hop a multiple of 64); b0, b1, b2 the folded basis's
// bf16 parts tiled by _tiled_basis (b2 unread at parts 2); mel banks^T in
// three bf16 parts tiled by _tiled_banks at MELS mels; out the first n_mels
// rows of each clip's out_mels rows of a (B, out_mels, n_frames) f32
// output. B <= 65535. All contiguous on the device. Returns the launch's
// cudaError_t (0 = success; cudaErrorInvalidValue for n_mels over 256,
// out_mels under n_mels, or a window outside the row).
extern "C" int eat_mel_log_wgmma(const float* wave, int B, int row_len, int hop, int n_frames,
                                 int lead, int max_start, const void* b0, const void* b1,
                                 const void* b2, int parts, const void* mel, int n_mels,
                                 float* out, int out_mels, void* stream) {
  if (n_mels > 2 * mel_wgmma::MAX_MELS) return (int)cudaErrorInvalidValue;
  if (parts == 2)
    return launch_mels<3>(wave, B, row_len, hop, n_frames, lead, max_start, b0, b1, nullptr,
                          mel, n_mels, out, out_mels, stream);
  if (parts == 3)
    return launch_mels<6>(wave, B, row_len, hop, n_frames, lead, max_start, b0, b1, b2, mel,
                          n_mels, out, out_mels, stream);
  return (int)cudaErrorInvalidValue;
}

// mel_edges::launch: the edge frames 0 .. n_left - 1 and right0 ..
// n_frames - 1 of the (B, S) wave, written over out (B, n_mels, n_frames);
// power (B, edge frames, 513) f32 scratch, done (B) u32 counts, zero before
// and after.
extern "C" int eat_mel_edges(const float* wave, int B, int S, int hop, int n_frames,
                             int n_left, int right0, const float* basis, const float* banks,
                             int n_mels, float* out, float* power, unsigned* done,
                             void* stream) {
  return (int)mel_edges::launch(wave, B, S, hop, n_frames, n_left, right0, basis, banks,
                                n_mels, out, power, done, static_cast<cudaStream_t>(stream));
}

// tile_banks::launch: the (n_mels, 513) banks tiled for every mel group
// into out, `total` bf16 elements (tile_banks::elements(n_mels)).
extern "C" int eat_tile_banks(const float* banks, int n_mels, void* out, long long total,
                              void* stream) {
  return (int)tile_banks::launch(banks, n_mels, out, total,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* eat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
