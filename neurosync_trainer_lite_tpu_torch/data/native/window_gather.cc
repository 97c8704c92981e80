// Native batch assembler for stride-1 window training.
//
// The hot host-side loop of training is gathering B windows of `window`
// frames from per-clip feature arrays into one contiguous [B, window, dim]
// batch (the TPU-native replacement for the reference's materialize-all-
// windows Dataset + torch DataLoader collate, reference dataset/dataset.py:
// 58-98 — which needed 128-256 GB RAM). Python/numpy does this as B slice
// copies per field under the GIL; this library does the same copies with
// OpenMP across rows, saturating host memory bandwidth.
//
// The port's own copy of neurosync_trainer_lite_tpu/data/native/
// window_gather.cc. Host code, not a device kernel: the batch it assembles
// is copied to the card by the training loop.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC window_gather.cc
//        -o build/native/libwindow_gather-<hash>.so
//        (driven by data/native/__init__.py)

#include <cstdint>
#include <cstring>

extern "C" {

// clip_ptrs: per-clip [T_i, dim] row-major float32 buffers.
// table: [n_windows, 2] int64 (clip_index, start_frame).
// batch_idx: [batch] int64 indices into table.
// out: [batch, window, dim] float32.
void gather_windows(const float* const* clip_ptrs,
                    const int64_t* table,
                    const int64_t* batch_idx,
                    int64_t batch,
                    int64_t window,
                    int64_t dim,
                    float* out) {
  const int64_t row_bytes = window * dim * sizeof(float);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t w = batch_idx[b];
    const int64_t clip = table[2 * w];
    const int64_t start = table[2 * w + 1];
    std::memcpy(out + b * window * dim,
                clip_ptrs[clip] + start * dim,
                row_bytes);
  }
}

// Paired variant: assemble source and target batches in one parallel region
// (one pass over the batch indices, better cache behavior than two calls).
void gather_windows_pair(const float* const* audio_ptrs,
                         const float* const* facial_ptrs,
                         const int64_t* table,
                         const int64_t* batch_idx,
                         int64_t batch,
                         int64_t window,
                         int64_t audio_dim,
                         int64_t facial_dim,
                         float* out_audio,
                         float* out_facial) {
  const int64_t a_bytes = window * audio_dim * sizeof(float);
  const int64_t f_bytes = window * facial_dim * sizeof(float);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t w = batch_idx[b];
    const int64_t clip = table[2 * w];
    const int64_t start = table[2 * w + 1];
    std::memcpy(out_audio + b * window * audio_dim,
                audio_ptrs[clip] + start * audio_dim,
                a_bytes);
    std::memcpy(out_facial + b * window * facial_dim,
                facial_ptrs[clip] + start * facial_dim,
                f_bytes);
  }
}

}  // extern "C"
