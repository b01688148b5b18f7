// QOA stream assembly for Hopper (sm_90a): every file's bytes, back to back.
//
// Plain version beside it: qoaudio_tpu_torch/ops/assemble.py::
// assemble_streams (which also holds the layout and the per-file table).
// Its byte reference is bitstream.assemble_stream_bytes, one file at a
// time on the host.
//
// What it computes: from the encoder's chain-minor outputs (snaps int32
// (F, 8, N), logical slice words u64 (F, W, N)) and the per-file table,
// each file's stream: the file header, then per frame the u64 frame
// header, the 2C LMS words and the frame's slice words (window-major,
// channel-minor, only the real windows), every word big-endian.
//
// What bounds it: bytes.  It reads each slice word and each LMS value
// once and writes each output word once; there is no arithmetic to speak
// of.  An ESC-50 fold (400 mono files of 44 frames) is ~36 MB in and
// ~36 MB out, ~21 us at 3.35 TB/s.
//
// The design: output-driven.  Every stream is whole u64 words and every
// frame of a file but its last has the full size, so one warp takes one
// (file, frame) pair, finds its file by a binary search of the table's
// first-frame row (the same address in every lane: one broadcast load a
// step) and its output offset with no scan, and its lanes store the
// frame's consecutive words: coalesced u64 stores.  The byte swap is two
// __byte_perm in registers.  The slice words are read chain-minor, one
// 8-byte word per lane from rows N words apart; the neighbouring chains'
// warps run at about the same time, so their sectors are met in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kFrameLen = 5120;  // samples a channel in a full frame
constexpr int64_t kSliceLen = 20;
constexpr int64_t kSlicesPerFrame = 256;
constexpr uint64_t kMagic = 0x716f6166ull;  // "qoaf"
// rows of the per-file table (ops/assemble.py)
enum { kOffset, kChain, kChannels, kRate, kSamples, kFrames, kFirstFrame };

__device__ __forceinline__ uint64_t big_endian(uint64_t v) {
  const uint32_t lo = static_cast<uint32_t>(v), hi = static_cast<uint32_t>(v >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) | __byte_perm(hi, 0, 0x0123);
}

// Four int32 LMS values, `stride` apart, as one u64 word, each truncated
// to 16 bits (bitstream.pack_lms).
__device__ __forceinline__ uint64_t lms_word(const int32_t* p, int64_t stride) {
  uint64_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w = (w << 16) | (static_cast<uint32_t>(p[i * stride]) & 0xFFFFu);
  return w;
}

__global__ void __launch_bounds__(kThreads)
    qoa_assemble_kernel(const int32_t* __restrict__ snaps, const uint64_t* __restrict__ words,
                        int n_windows, int64_t n_chains, const int64_t* __restrict__ table,
                        int n_files, int64_t n_frames, uint64_t* __restrict__ out) {
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (task >= n_frames) return;
  const int lane = threadIdx.x & 31;

  // the file: the last one whose first frame is at or before this task
  const int64_t* first = table + kFirstFrame * static_cast<int64_t>(n_files);
  int lo = 0, hi = n_files - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= task) lo = mid; else hi = mid - 1;
  }
  const int64_t* col = table + lo;
  const int64_t f = task - first[lo];
  const int64_t C = col[kChannels * static_cast<int64_t>(n_files)];
  const int64_t chain = col[kChain * static_cast<int64_t>(n_files)];
  const int64_t rate = col[kRate * static_cast<int64_t>(n_files)];
  const int64_t T = col[kSamples * static_cast<int64_t>(n_files)];
  const int64_t spc = T - f * kFrameLen < kFrameLen ? T - f * kFrameLen : kFrameLen;
  const int64_t nw = (spc + kSliceLen - 1) / kSliceLen;
  const int lms_words = static_cast<int>(2 * C);
  const int n_words = 1 + lms_words + static_cast<int>(nw * C);
  const int64_t full_words = 1 + 2 * C + kSlicesPerFrame * C;
  uint64_t* dst = out + col[kOffset * static_cast<int64_t>(n_files)] / 8 + 1 + f * full_words;
  if (f == 0 && lane == 0) dst[-1] = big_endian((kMagic << 32) | static_cast<uint32_t>(T));

  const uint64_t fsize = 8 * static_cast<uint64_t>(n_words);
  const uint64_t header = (static_cast<uint64_t>(C & 0xFF) << 56) |
                          (static_cast<uint64_t>(rate & 0xFFFFFFFFll) << 32) |
                          (static_cast<uint64_t>(spc & 0xFFFF) << 16) | (fsize & 0xFFFF);
  const int c_count = static_cast<int>(C);
  const int32_t* lms = snaps + f * 8 * n_chains + chain;
  const uint64_t* frame_words = words + f * n_windows * n_chains + chain;
  for (int q = lane; q < n_words; q += 32) {
    uint64_t v;
    if (q == 0) {
      v = header;
    } else if (q <= lms_words) {  // q - 1 = 2c + (0 history, 1 weights)
      v = lms_word(lms + ((q - 1) & 1) * 4 * n_chains + ((q - 1) >> 1), n_chains);
    } else {  // slice word s = w*C + c
      const int s = q - 1 - lms_words;
      const int w = s / c_count;
      v = frame_words[w * n_chains + (s - w * c_count)];
    }
    dst[q] = big_endian(v);
  }
}

}  // namespace

// snaps: (F, 8, N) int32; words: (F, W, N) u64 logical slice words;
// table: (7, n_files) int64 (ops/assemble.py::file_table), n_frames the
// sum of its frames row; out: the streams' bytes, 8-byte aligned.
// Launch on `stream` without synchronising; return cudaGetLastError().
extern "C" int qoa_assemble_cuda(const void* snaps, const void* words, int n_windows,
                                 long long n_chains, const void* table, int n_files,
                                 long long n_frames, void* out, void* stream) {
  if (n_frames > 0) {
    const long long blocks = (n_frames + kWarps - 1) / kWarps;
    qoa_assemble_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(snaps), static_cast<const uint64_t*>(words), n_windows,
        n_chains, static_cast<const int64_t*>(table), n_files, n_frames,
        static_cast<uint64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
