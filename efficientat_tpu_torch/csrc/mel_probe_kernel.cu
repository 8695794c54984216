// P1-P3 — the probe variants of the fused log-mel, CUDA C++ for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of scripts/probe_mel_kernel.py:
//   eat_probe_p1  variant_kernel (:80),  launched by variant_mel (:145)
//   eat_probe_p2  dma_kernel (:268),     launched by variant_mel_dma (:310)
//   eat_probe_p3  e_kernel (:419),       launched by variant_mel_e (:461)
// Each computes K1's bf16x3 function (ops/mel_kernel.py) on the kernel of
// csrc/mel_wgmma.cuh, which K1 bf16x3 launches too: that header holds the
// function, what bounds it, the design and the steps that led to it.
//   P1: the folded basis (the raw wave behind a zero pad) or the plain one
//       (the pre-emphasised, reflect-padded wave), any multiple of 64 frames
//       a block (frame_tile), 3 passes;
//   P2: P1 folded, each sub-tile's wave segment brought into shared memory by
//       one bulk copy (128 frames up to hop 320, else 64; mel_wgmma::plan);
//   P3: P1 folded at hop 320 and 128-frame tiles, 3, 21 or 22 passes.

#include "mel_wgmma.cuh"

namespace {

constexpr int P3_TILE = 128;

}  // namespace

// The operands of mel_wgmma::launch (ops/mel_probe.py makes them): rows
// holding every frame of the last 128-frame sub-tile (ops/mel_kernel.py::
// _block_rows), frame i at x[:, hop * i] (lead 0, max_start the rows' last
// window start). Each returns the launch's cudaError_t (0 = success).
extern "C" int eat_probe_p1(const float* x, int B, int row_len, int hop, int n_frames,
                            int frame_tile, const void* bhi, const void* blo,
                            const void* mel, int n_mels, float* out, void* stream) {
  return (int)mel_wgmma::launch<false, 3>(x, B, row_len, hop, n_frames, frame_tile, 0,
                                          mel_wgmma::last_start(row_len), bhi, blo, nullptr,
                                          mel, n_mels, n_mels, out, stream);
}

extern "C" int eat_probe_p2(const float* x, int B, int row_len, int hop, int n_frames,
                            int frame_tile, const void* bhi, const void* blo,
                            const void* mel, int n_mels, float* out, void* stream) {
  return (int)mel_wgmma::launch<true, 3>(x, B, row_len, hop, n_frames, frame_tile, 0, 0, bhi,
                                         blo, nullptr, mel, n_mels, n_mels, out, stream);
}

extern "C" int eat_probe_p3(const float* x, int B, int row_len, int hop, int n_frames,
                            int passes, const void* bhi, const void* blo,
                            const void* mel, int n_mels, float* out, void* stream) {
  if (hop != 320) return (int)cudaErrorInvalidValue;
  const int last = mel_wgmma::last_start(row_len);
  switch (passes) {
    case 3:
      return (int)mel_wgmma::launch<false, 3>(x, B, row_len, hop, n_frames, P3_TILE, 0, last,
                                              bhi, blo, nullptr, mel, n_mels, n_mels, out,
                                              stream);
    case 21:
      return (int)mel_wgmma::launch<false, 21>(x, B, row_len, hop, n_frames, P3_TILE, 0, last,
                                               bhi, blo, nullptr, mel, n_mels, n_mels, out,
                                               stream);
    case 22:
      return (int)mel_wgmma::launch<false, 22>(x, B, row_len, hop, n_frames, P3_TILE, 0, last,
                                               bhi, blo, nullptr, mel, n_mels, n_mels, out,
                                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the shared-memory plan P1/P3 (staged 0) or P2 (1) launch at `hop`, with
// ring slots of `parts` basis parts (2; 3 is K1 fp32's, unstaged) and sums
// of `mels` mels (128; 256 is K1's widest, unstaged): its bytes (0 where
// nothing fits), warpgroups and KC
extern "C" long long eat_probe_plan(int staged, int hop, int parts, int mels, int* wg,
                                    int* kc) {
  const mel_wgmma::Plan p = mel_wgmma::plan(staged != 0, hop, parts, mels);
  *wg = p.wg;
  *kc = p.kc;
  return (long long)p.bytes;
}

extern "C" const char* eat_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
