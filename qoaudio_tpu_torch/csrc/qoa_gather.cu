// QOA chain gather for Hopper (sm_90a): the decode kernel's inputs, read
// from the QOA streams as they are.
//
// Plain version beside it: qoaudio_tpu_torch/ops/gather.py::gather_chains
// (which also holds the per-file table and the layout).  It replaces no
// TPU kernel: the JAX package gathers the slice words and LMS state of
// every frame on the host (bitstream.parse_file_arrays, then the corpus
// layer's staging of them, one column block a file).  Here the host
// uploads each device group's streams back to back, once, and the card
// lays them out.
//
// What it computes: for decode chain n (a file's frame f, channel c), the
// frame's raw big-endian slice words of channel c into column n of
// words_be (W, N), zero past the frame's own windows, and the frame's
// LMS words of channel c, as four sign-extended 16-bit history values
// then four weights, into column n of state (8, N).
//
// What bounds it: bytes.  Each slice word is read once and written once,
// each LMS word read once and its values written once; no arithmetic to
// speak of.  An ESC-50 fold (400 mono files of 44 frames, 17,600 chains)
// is ~36 MB in and ~36 MB out, ~21 us at 3.35 TB/s.
//
// The design: a frame's words lie window-major (W, C) in the stream, but
// chains are the minor axis of words_be, so a thread per output word
// would read 8 useful bytes of every 32-byte sector.  Instead a block
// takes a tile of 32 consecutive chains and walks the windows 32 at a
// time: each warp reads a chain's 32 consecutive windows (one run of
// 256 bytes for a mono file; for C channels, C chains of the tile read
// the same sectors), the tile is transposed through shared memory, and
// each warp writes a window row of the tile as one 256-byte run.  A
// chain finds its file by binary search of the table's first-chain row
// (as qoa_assemble_kernel finds a frame's file), once a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // chains a block, and windows a step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows of the per-file table (ops/gather.py)
enum { kOffset, kFramesFull, kFrameBytes, kChannels, kWindows, kTailWindows, kChain };

__device__ __forceinline__ uint64_t byte_swap(uint64_t v) {
  const uint32_t lo = static_cast<uint32_t>(v), hi = static_cast<uint32_t>(v >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) | __byte_perm(hi, 0, 0x0123);
}

// Value i (0 = the top 16 bits) of an LMS word, byte-swapped to its
// logical value, sign-extended.
__device__ __forceinline__ int32_t lms_value(uint64_t logical, int i) {
  return static_cast<int16_t>(static_cast<uint16_t>(logical >> (48 - 16 * i)));
}

__global__ void __launch_bounds__(kThreads)
    qoa_gather_kernel(const uint64_t* __restrict__ streams, const int64_t* __restrict__ table,
                      int n_files, int n_windows, int64_t n_chains,
                      uint64_t* __restrict__ words, int32_t* __restrict__ state) {
  __shared__ uint64_t tile[kTile][kTile + 1];  // [chain][window]; the pad keeps rows apart
  __shared__ int64_t first_word[kTile];        // a chain's window-0 word in the buffer
  __shared__ int stride[kTile];                // words between its windows: its channels
  __shared__ int windows[kTile];               // its frame's windows (0 past the chains)
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (warp == 0) {  // lane j: chain base + j
    const int64_t n = base + lane;
    int64_t at = 0;
    int C = 1, nw = 0;
    if (n < n_chains) {
      const int64_t* first = table + kChain * static_cast<int64_t>(n_files);
      int lo = 0, hi = n_files - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (first[mid] <= n) lo = mid; else hi = mid - 1;
      }
      const int64_t* col = table + lo;
      C = static_cast<int>(col[kChannels * static_cast<int64_t>(n_files)]);
      const int64_t k = n - first[lo];
      const int64_t f = k / C;
      const int c = static_cast<int>(k - f * C);
      const int64_t frame = col[kOffset * static_cast<int64_t>(n_files)] / 8 +
                            f * (col[kFrameBytes * static_cast<int64_t>(n_files)] / 8);
      nw = static_cast<int>(f < col[kFramesFull * static_cast<int64_t>(n_files)]
                                ? col[kWindows * static_cast<int64_t>(n_files)]
                                : col[kTailWindows * static_cast<int64_t>(n_files)]);
      at = frame + 1 + 2 * C + c;
      const uint64_t history = byte_swap(streams[frame + 1 + 2 * c]);
      const uint64_t weights = byte_swap(streams[frame + 2 + 2 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // row-major (8, N): 32 chains a row, one run
        state[i * n_chains + n] = lms_value(history, i);
        state[(4 + i) * n_chains + n] = lms_value(weights, i);
      }
    }
    first_word[lane] = at;
    stride[lane] = C;
    windows[lane] = nw;
  }
  __syncthreads();

  for (int w0 = 0; w0 < n_windows; w0 += kTile) {
    const int w = w0 + lane;
#pragma unroll
    for (int q = 0; q < kTile / kWarps; ++q) {  // a chain's 32 windows
      const int j = warp + q * kWarps;
      tile[j][lane] = w < windows[j] ? streams[first_word[j] + static_cast<int64_t>(w) * stride[j]]
                                     : 0;
    }
    __syncthreads();
    const int64_t n = base + lane;
#pragma unroll
    for (int q = 0; q < kTile / kWarps; ++q) {  // a window row of the tile's chains
      const int r = warp + q * kWarps;
      if (w0 + r < n_windows && n < n_chains) {
        words[static_cast<int64_t>(w0 + r) * n_chains + n] = tile[lane][r];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// streams: the group's QOA streams back to back, as u64 words; table:
// (7, n_files) int64 (ops/gather.py::file_table); words: (n_windows,
// n_chains) u64 raw big-endian; state: (8, n_chains) int32.  Launch on
// `stream` without synchronising; return cudaGetLastError().
extern "C" int qoa_gather_cuda(const void* streams, const void* table, int n_files,
                               int n_windows, long long n_chains, void* words, void* state,
                               void* stream) {
  if (n_chains > 0) {
    const long long blocks = (n_chains + kTile - 1) / kTile;
    qoa_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(streams), static_cast<const int64_t*>(table), n_files,
        n_windows, n_chains, static_cast<uint64_t*>(words), static_cast<int32_t*>(state));
  }
  return static_cast<int>(cudaGetLastError());
}
