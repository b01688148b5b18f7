// QOA batched encoder for Hopper (sm_90a): all 16 scalefactor candidates.
//
// Replaces: qoaudio_tpu/ops/pallas_encode.py::encode_frames_pallas
// (`_encode_kernel` -> `_window_body`) and its full-window twin
// encode_frames_pallas_full (`_encode_kernel_full`).  Both are one
// template here: MASKED=false is the full-window specialisation.  Plain
// versions beside them: qoaudio_tpu_torch/ops/encode.py::encode_frames and
// ::encode_frames_full.
//
// What it computes: per chain and per 20-sample window, every candidate sf
// runs the 20-step predict / penalty / qoa_div / quantize / dequantize /
// reconstruct / rank recurrence from the same LMS; the winner is the
// lexicographic argmin over (total rank, first-sample rank, sf) — the
// reference's sorted early-exit search picks the same one — and its LMS
// carries into the next window.  Per frame the LMS at frame start is
// snapshotted; per window the winner's packed u64 slice word is stored.
//
// What bounds it on the H100: latency.  A frame is a serial chain of
// 256 windows x 20 dependent steps (5,120 steps), plus a shuffle argmin
// per window, and the LMS carries from frame to frame, so a chain's frames
// are serial too.  A corpus holds few chains (48-50 for the 33-file smoke
// corpus: one per file channel), i.e. 48-50 chains x 16 lanes = 24-25
// warps on a 132-SM card, and the corpus is done when its longest chain
// is.  Bytes are negligible (40 B in, 8 B out per chain-window).
//
// What the design does about it:
// * a half-warp serves one chain, lane = sf candidate, so the 16-way
//   search costs no extra serial steps and the argmin is 4 butterfly
//   __shfl_xor_sync rounds on (total, first, sf); __shfl_sync then
//   broadcasts the winner's LMS and word to the half-warp;
// * every shuffle names the FULL warp (a per-half-warp mask compiles each
//   SHFL into a WARPSYNC/collective sequence), so a half-warp past the
//   last chain does not leave: it runs on a clamped chain index and
//   stores nothing;
// * the next window's 20 samples (and length) are loaded while the
//   current window runs, with loads the compiler may not sink to their
//   use (it did, step by step, in the full variant: every step then waited
//   on memory);
// * ranks are plain 64-bit unsigned sums (err^2 < 2^32, penalty <= 8191),
//   replacing the TPU's two-limb u32 ranks and biased compares, which
//   existed only because Mosaic has no 64-bit integers;
// * the loop over frames runs inside the thread with the LMS in
//   registers, and lanes 0-7 write the snapshot at each frame start.  On
//   the TPU the frame axis was a sequential ("arbitrary") grid dimension
//   carrying the LMS in VMEM scratch; CUDA blocks run in no order, so
//   nothing is carried between blocks;
// * blocks of 32 threads (2 chains) spread the few warps over as many SMs
//   as possible; the ragged edge is handled here (no 128-lane padding);
// * in the masked variant the choice of steps is uniform over the warp:
//   when each of its two chains has a full window or has ended, both take
//   the full-window steps (an ended chain's result is then reset), since
//   two chains on different paths would run both paths one after the
//   other; only short windows (file tails) test the length at every step.
//
// Integer semantics: the reference wraps int32 adds and multiplies
// (prediction dot, penalty sum, qoa_div's reciprocal multiply); signed
// overflow is undefined in C++, so those run in uint32 and cast back, and
// every >> stays on a signed int (arithmetic shift).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int32_t kScalefactorTab[16] = {
    1, 7, 21, 45, 84, 138, 211, 304, 421, 562, 731, 928, 1157, 1419, 1715, 2048};
__constant__ int32_t kReciprocalTab[16] = {
    65536, 9363, 3121, 1457, 781, 475, 311, 216, 156, 117, 90, 71, 57, 47, 39, 32};

constexpr int kSliceLen = 20;
constexpr int kLanes = 16;    // one lane per scalefactor candidate
constexpr int kThreads = 32;  // two chains per block
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_dot4(const int32_t* a, const int32_t* b) {
  uint32_t s = static_cast<uint32_t>(a[0]) * static_cast<uint32_t>(b[0]);
  s += static_cast<uint32_t>(a[1]) * static_cast<uint32_t>(b[1]);
  s += static_cast<uint32_t>(a[2]) * static_cast<uint32_t>(b[2]);
  s += static_cast<uint32_t>(a[3]) * static_cast<uint32_t>(b[3]);
  return static_cast<int32_t>(s);
}

__device__ __forceinline__ int32_t sgn(int32_t v) { return (v > 0) - (v < 0); }

// Read-only loads that stay where they are written: volatile asm is not sunk
// towards its first use, so a prefetch stays a prefetch.
__device__ __forceinline__ int32_t load_s16(const int16_t* p) {
  uint16_t v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return static_cast<int16_t>(v);
}

__device__ __forceinline__ int32_t load_s32(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Row i of the (8,) LMS state, without indexing a register array by a
// runtime value (which would move it to local memory).
__device__ __forceinline__ int32_t lms_row(const int32_t* h, const int32_t* w, int i) {
  int32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v = (i == j) ? h[j] : v;
    v = (i == 4 + j) ? w[j] : v;
  }
  return v;
}

// One scalefactor candidate's constants.
struct Candidate {
  int32_t recip, m0, m1, m2, m3;
};

__device__ __forceinline__ Candidate candidate(int sf) {
  const int32_t v = kScalefactorTab[sf];
  return {kReciprocalTab[sf], (3 * v + 2) >> 2, (5 * v + 1) >> 1, (9 * v + 1) >> 1, 7 * v};
}

// One window for one candidate: the first `length` of its 20 steps (all
// of them when FULL) from the LMS in ch/cw, accumulating the rank, the
// first-sample rank and the packed codes into `word`.  Steps past
// `length` change nothing and leave code 0, which reproduces the
// reference's final left shift of a short slice.
template <bool FULL>
__device__ __forceinline__ void run_window(const int32_t (&s)[kSliceLen], int length,
                                           const Candidate& c, int32_t (&ch)[4],
                                           int32_t (&cw)[4], uint64_t& rank,
                                           uint64_t& first, uint64_t& word) {
#pragma unroll
  for (int k = 0; k < kSliceLen; ++k) {
    if (FULL || k < length) {
      const int32_t pred = wrap_dot4(cw, ch) >> 13;
      const int32_t ssum = wrap_dot4(cw, cw);
      const int32_t pen = max((ssum >> 18) - 0x8FF, 0);

      const int32_t residual = s[k] - pred;  // |s| <= 2^15, |pred| < 2^18
      // qoa_div: wrapping reciprocal multiply, +0.5 bias, then the
      // away-from-zero fix from BOTH signs (the multiply can wrap)
      const int32_t nq = static_cast<int32_t>(static_cast<uint32_t>(residual) *
                                                  static_cast<uint32_t>(c.recip) +
                                              32768u) >> 16;
      const int32_t scaled = nq + sgn(residual) - sgn(nq);
      // QOA_QUANT_TAB in closed form, the [-8, 8] clamp folded into min
      const int neg = scaled < 0;
      const int idx = min(abs(scaled) >> 1, 3);
      const int q = (idx << 1) | neg;
      const int32_t mag = idx < 2 ? (idx == 0 ? c.m0 : c.m1) : (idx == 2 ? c.m2 : c.m3);
      const int32_t dq = neg ? -mag : mag;
      int32_t recon = pred + dq;
      recon = recon < -32768 ? -32768 : (recon > 32767 ? 32767 : recon);

      const uint32_t err = static_cast<uint32_t>(s[k] - recon);  // |.| < 2^16
      rank += static_cast<uint64_t>(err * err) +
              static_cast<uint64_t>(static_cast<uint32_t>(pen * pen));
      word |= static_cast<uint64_t>(q) << (57 - 3 * k);

      const int32_t delta = dq >> 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) cw[i] = wrap_add(cw[i], ch[i] < 0 ? -delta : delta);
      ch[0] = ch[1];
      ch[1] = ch[2];
      ch[2] = ch[3];
      ch[3] = recon;
    }
    if (k == 0) first = rank;
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(kThreads)
qoa_encode_kernel(const int16_t* __restrict__ samples,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ state_in, int n_frames,
                  int n_windows, int n_chains, int32_t* __restrict__ state_out,
                  int32_t* __restrict__ snaps, uint64_t* __restrict__ words) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = tid / kLanes < n_chains;  // uniform over a half-warp
  const int chain = real ? tid / kLanes : n_chains - 1;
  const int lane = threadIdx.x % kLanes;
  const bool store = real && lane == 0;
  const size_t N = static_cast<size_t>(n_chains);
  const size_t n_win_total = static_cast<size_t>(n_frames) * n_windows;

  const Candidate cand = candidate(lane);

  int32_t h[4], w[4];  // the chain's carried LMS, identical in all 16 lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = state_in[i * N + chain];
    w[i] = state_in[(4 + i) * N + chain];
  }

  // window g's samples and length, loaded one window ahead
  int32_t nxt[kSliceLen];
  int nxt_len = kSliceLen;
  if (n_win_total > 0) {
#pragma unroll
    for (int k = 0; k < kSliceLen; ++k) nxt[k] = load_s16(samples + k * N + chain);
    if (MASKED) nxt_len = load_s32(lens + chain);
  }

  size_t g = 0;  // flat window index f * n_windows + win
  for (int f = 0; f < n_frames; ++f) {
    if (real && lane < 8) snaps[(static_cast<size_t>(f) * 8 + lane) * N + chain] = lms_row(h, w, lane);

    for (int win = 0; win < n_windows; ++win, ++g) {
      int32_t s[kSliceLen];
#pragma unroll
      for (int k = 0; k < kSliceLen; ++k) s[k] = nxt[k];
      const int length = nxt_len;
      if (g + 1 < n_win_total) {
        const int16_t* src = samples + (g + 1) * kSliceLen * N + chain;
#pragma unroll
        for (int k = 0; k < kSliceLen; ++k) nxt[k] = load_s16(src + k * N);
        if (MASKED) nxt_len = load_s32(lens + (g + 1) * N + chain);
      }

      int32_t ch[4], cw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ch[i] = h[i];
        cw[i] = w[i];
      }
      const uint64_t sf_bits = static_cast<uint64_t>(lane) << 60;
      uint64_t rank = 0, first = 0;
      uint64_t word = sf_bits;
      // Warp-uniform choice: when every chain of the warp is full or ended
      // (length 0), all run the full steps and an ended chain's result is
      // reset to "no step ran" below.  Two chains of one warp on different
      // paths run both paths one after the other.
      const bool full_steps =
          !MASKED || (__all_sync(kFullMask, length == kSliceLen || length == 0) &&
                      __any_sync(kFullMask, length == kSliceLen));
      if (full_steps) {
        run_window<true>(s, length, cand, ch, cw, rank, first, word);
        if (MASKED && length == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ch[i] = h[i];
            cw[i] = w[i];
          }
          rank = first = 0;
          word = sf_bits;
        }
      } else {
        run_window<false>(s, length, cand, ch, cw, rank, first, word);
      }

      // lexicographic argmin over (total, first, sf) across the 16 lanes
      uint64_t bt = rank, bf = first;
      int bs = lane;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        const uint64_t ot = __shfl_xor_sync(kFullMask, bt, off, kLanes);
        const uint64_t of = __shfl_xor_sync(kFullMask, bf, off, kLanes);
        const int os = __shfl_xor_sync(kFullMask, bs, off, kLanes);
        const bool better = ot < bt || (ot == bt && (of < bf || (of == bf && os < bs)));
        bt = better ? ot : bt;
        bf = better ? of : bf;
        bs = better ? os : bs;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __shfl_sync(kFullMask, ch[i], bs, kLanes);
        w[i] = __shfl_sync(kFullMask, cw[i], bs, kLanes);
      }
      const uint64_t best_word = __shfl_sync(kFullMask, word, bs, kLanes);
      if (store) words[g * N + chain] = best_word;
    }
  }
  if (real && lane < 8) state_out[lane * N + chain] = lms_row(h, w, lane);
}

template <bool MASKED>
int launch(const void* samples, const void* lens, const void* state_in, int n_frames,
           int n_windows, int n_chains, void* state_out, void* snaps, void* words,
           void* stream) {
  if (n_chains > 0) {
    const int blocks = (n_chains * kLanes + kThreads - 1) / kThreads;
    qoa_encode_kernel<MASKED><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(samples), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(state_in), n_frames, n_windows, n_chains,
        static_cast<int32_t*>(state_out), static_cast<int32_t*>(snaps),
        static_cast<uint64_t*>(words));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// samples: (F, W, 20, N) int16, zero past each window's length;
// lens: (F, W, N) int32; state_in / state_out: (8, N) int32;
// snaps: (F, 8, N) int32; words: (F, W, N) u64 logical slice words.
// Launch on `stream` without synchronising; return cudaGetLastError().
extern "C" int qoa_encode_frames_cuda(const void* samples, const void* lens,
                                      const void* state_in, int n_frames, int n_windows,
                                      int n_chains, void* state_out, void* snaps,
                                      void* words, void* stream) {
  return launch<true>(samples, lens, state_in, n_frames, n_windows, n_chains, state_out,
                      snaps, words, stream);
}

// The same with every window full (no lens).
extern "C" int qoa_encode_frames_full_cuda(const void* samples, const void* state_in,
                                           int n_frames, int n_windows, int n_chains,
                                           void* state_out, void* snaps, void* words,
                                           void* stream) {
  return launch<false>(samples, nullptr, state_in, n_frames, n_windows, n_chains,
                       state_out, snaps, words, stream);
}

// One resident wave of the encoder on the current device: the blocks of
// either variant that fit on one SM at once (the smaller of the two), the
// SM count, and the chains a block serves.  Launches nothing; returns
// cudaGetLastError() after the queries (the first failing query's error).
extern "C" int qoa_encode_occupancy(int* blocks_per_sm, int* n_sms, int* chains_per_block) {
  int dev = 0, masked = 0, full = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&masked, qoa_encode_kernel<true>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&full, qoa_encode_kernel<false>, kThreads, 0);
  *blocks_per_sm = masked < full ? masked : full;
  *chains_per_block = kThreads / kLanes;
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
}
