// K1 — fused log-mel front end, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel efficientat_tpu/ops/mel_pallas.py::_mel_kernel.
// For one clip and one tile of frames, in one kernel:
//   frames of the RAW wave (frame i is samples [hop*i - 512, hop*i + 512),
//   zero outside [0, S)) times the pre-emphasis-folded, windowed rDFT basis
//   (1024 x 1024: 512 cos columns, then 512 sin columns, no Nyquist bin)
//   -> power re^2 + im^2 -> times banks^T (512 x n_mels)
//   -> (log(x + 1e-5) + 4.5) / 5, written into the (B, n_mels, n_frames) output.
// The frames, the projection and the power spectrum never reach device memory.
// The few frames whose window reaches the reflect pad are recomputed exactly
// by the Python wrapper (ops/mel_kernel.py), as the JAX package does.
//
// The kernel is the Hopper design of csrc/mel_wgmma.cuh, which describes it
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

#include "mel_wgmma.cuh"

namespace {

template <int PASSES>
int launch_mels(const float* rows, int B, int S, int hop, int n_frames, const void* b0,
                const void* b1, const void* b2, const void* mel, int n_mels, float* out,
                int out_mels, void* stream) {
  if (n_mels <= mel_wgmma::MAX_MELS)
    return (int)mel_wgmma::launch<false, PASSES>(rows, B, S, hop, n_frames, 128, b0, b1, b2,
                                                 mel, n_mels, out_mels, out, stream);
  return (int)mel_wgmma::launch<false, PASSES, 2 * mel_wgmma::MAX_MELS>(
      rows, B, S, hop, n_frames, 128, b0, b1, b2, mel, n_mels, out_mels, out, stream);
}

}  // namespace

// One 128-frame sub-tile a block, on mel_kernel_wgmma<2, false, 3, 128,
// MELS> (parts 2: bf16x3) or <2, false, 6, 128, MELS> (parts 3: fp32), MELS
// 128 at n_mels <= 128 and 256 at 129-256: rows (B, S) f32 as
// ops/mel_kernel.py::_block_rows makes them (the raw wave behind a 512-sample
// zero pad, frame i at rows[:, hop * i], S a multiple of 4 holding every
// frame of the last 128-frame block, hop a multiple of 64); b0, b1, b2 the
// folded basis's bf16 parts tiled by _tiled_basis (b2 unread at parts 2);
// mel banks^T in three bf16 parts tiled by _tiled_banks at MELS mels; out
// the first n_mels rows of each clip's out_mels rows of a (B, out_mels,
// n_frames) f32 output. B <= 65535. All contiguous on the device. Returns
// the launch's cudaError_t (0 = success; cudaErrorInvalidValue for n_mels
// over 256 or out_mels under n_mels).
extern "C" int eat_mel_log_wgmma(const float* rows, int B, int S, int hop, int n_frames,
                                 const void* b0, const void* b1, const void* b2, int parts,
                                 const void* mel, int n_mels, float* out, int out_mels,
                                 void* stream) {
  if (n_mels > 2 * mel_wgmma::MAX_MELS) return (int)cudaErrorInvalidValue;
  if (parts == 2)
    return launch_mels<3>(rows, B, S, hop, n_frames, b0, b1, nullptr, mel, n_mels, out,
                          out_mels, stream);
  if (parts == 3)
    return launch_mels<6>(rows, B, S, hop, n_frames, b0, b1, b2, mel, n_mels, out, out_mels,
                          stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* eat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
