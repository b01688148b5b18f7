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
// What bounds it on the H100: the serial chain, one warp at a time.  A
// frame is a chain of 256 windows x 20 dependent steps, the LMS carries
// from frame to frame, and the corpus is done when its longest chain is.
// A corpus holds few chains (50 for the smoke corpus: 25 warps on 132
// SMs), so each warp sits alone on its scheduler: nothing hides the wait
// of an instruction on the one before it, and its instructions issue one
// after the other.  Bytes (40 B in, 8 B out per chain-window) and the
// card's issue rate are far from binding.  Counted in the SASS (the
// longest chain of dependent instructions through a window's 20 unrolled
// steps, over 20; chip_smoke.py phase 2), the step of the template before
// this design took 23.75 (full) and 22.15 (masked) dependent
// instructions; this one takes 13.90 and 13.35.
//
// What the design does about it:
// * the next prediction is taken incrementally (all of it mod 2^32, so the
//   rearrangement is exact): with s_i = (h_i < 0 ? -1 : 1) at step start,
//       pred' = (A + delta*B + (w3 + s3*delta)*recon) >> 13,
//       A = w0*h1 + w1*h2 + w2*h3,  B = s0*h1 + s1*h2 + s2*h3;
//   A and B need only the state at step start, so they are computed beside
//   this step's quantizer, and after dq only delta = dq >> 4, the clamp of
//   recon, two IMADs and the >> 13 remain.  The four weights are updated
//   off the path (for the penalty and for the carry out), and the winner's
//   next prediction is broadcast with its LMS, so no window starts with a
//   4-tap dot;
// * a shorter quantizer: qoa_div's product is one multiply-add after pred
//   (s * recip + 2^15 is known before it), sgn(residual) is a clamp beside
//   it, nq - sgn(nq) is max(nq - 1, 0) + min(nq + 1, 0), and the signed
//   dequantized value comes from one PRMT over the lane's four magnitudes
//   packed 16 bits each (max 7 * 2048 = 14,336 < 2^15), from a positive
//   or a negative pair of registers chosen by the sign, the selector's
//   sign-replicating nibbles filling the high half;
// * fewer instructions off the path: err^2 is the only 64-bit sum (one
//   wide IMAD per step), penalty^2 sums in uint32 (<= 20 * 8191^2 < 2^31)
//   and joins the rank once per window, and the word is packed in two
//   32-bit halves with a constant shift-add per step;
// * tried and dropped (timed against this design in one run on the card):
//   the eight clamped reconstructions pred +- m_j packed beside the
//   quantizer, so one PRMT gives recon (20 more instructions a step: the
//   step got slower), and a two-stage argmin (u64 minimum, then a ballot
//   of the tied lanes), and (first << 4 | sf) as one key: no faster;
// * a half-warp serves one chain, lane = sf candidate, so the 16-way
//   search costs no extra serial steps and the argmin is 4 butterfly
//   __shfl_xor_sync rounds on (total, first, sf); __shfl_sync then
//   broadcasts the winner's LMS, prediction and word to the half-warp;
// * every shuffle names the FULL warp (a per-half-warp mask compiles each
//   SHFL into a WARPSYNC/collective sequence), so a half-warp past the
//   last chain does not leave: it runs on a clamped chain index and
//   stores nothing;
// * the next window's 20 samples (and length) are loaded while the
//   current window runs, with loads the compiler may not sink to their
//   use (it did, step by step, in the full variant: every step then waited
//   on memory);
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
// (prediction dot, penalty sum, qoa_div's reciprocal multiply, weight
// update); signed overflow is undefined in C++, so those run in uint32 and
// cast back, and every >> stays on a signed int (arithmetic shift).

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

__device__ __forceinline__ uint32_t u32(int32_t v) { return static_cast<uint32_t>(v); }

__device__ __forceinline__ int32_t wrap_dot4(const int32_t* a, const int32_t* b) {
  uint32_t s = u32(a[0]) * u32(b[0]);
  s += u32(a[1]) * u32(b[1]);
  s += u32(a[2]) * u32(b[2]);
  s += u32(a[3]) * u32(b[3]);
  return static_cast<int32_t>(s);
}

// a * b + c mod 2^32, as written: the compiler folds s * recip - pred *
// recip back into (s - pred) * recip, one more step on the dependent path
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Bytes of {hi:lo} picked by the four selector nibbles; a nibble's bit 3
// replicates the sign of its byte (PTX prmt's default mode, which
// __byte_perm does not offer).
__device__ __forceinline__ int32_t prmt(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return static_cast<int32_t>(d);
}

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

__device__ __forceinline__ uint32_t pack16(int32_t a, int32_t b) {
  return (u32(a) & 0xFFFFu) | (u32(b) << 16);
}

// One scalefactor candidate's constants: the reciprocal, and the four
// dequantized magnitudes m0..m3 (QOA_DEQUANT_TAB's row in closed form) as
// 16-bit halves, positive and negated, two to a register.
struct Candidate {
  uint32_t recip, neg_recip, pos01, pos23, neg01, neg23;
};

__device__ __forceinline__ Candidate candidate(int sf) {
  const int32_t v = kScalefactorTab[sf];
  const int32_t m0 = (3 * v + 2) >> 2, m1 = (5 * v + 1) >> 1, m2 = (9 * v + 1) >> 1;
  const int32_t m3 = 7 * v;
  const uint32_t recip = u32(kReciprocalTab[sf]);
  return {recip, 0u - recip, pack16(m0, m1), pack16(m2, m3), pack16(-m0, -m1),
          pack16(-m2, -m3)};
}

// One lane's rank of a window: the 64-bit sum of err^2 (each < 2^32), the
// uint32 sum of penalty^2, and the rank after the first step.
struct Rank {
  uint64_t err;
  uint32_t pen;
  uint64_t first;
};

// One window for one candidate: the first `length` of its 20 steps (all
// of them when FULL) from the LMS in h/w, whose prediction is `pred`,
// accumulating the rank and the packed codes into the word's halves.
// Steps past `length` change nothing and leave code 0, which reproduces
// the reference's final left shift of a short slice.
template <bool FULL>
__device__ __forceinline__ void run_window(const int32_t (&s)[kSliceLen], int length,
                                           const Candidate& c, int32_t (&h)[4],
                                           int32_t (&w)[4], int32_t& pred, Rank& r,
                                           uint32_t& hi, uint32_t& lo) {
#pragma unroll
  for (int k = 0; k < kSliceLen; ++k) {
    if (FULL || k < length) {
      // beside the quantizer: what the state at step start gives
      uint32_t sg[4];  // s_i as +-1
#pragma unroll
      for (int i = 0; i < 4; ++i) sg[i] = h[i] < 0 ? 0xFFFFFFFFu : 1u;
      const uint32_t a = u32(w[0]) * u32(h[1]) + u32(w[1]) * u32(h[2]) + u32(w[2]) * u32(h[3]);
      const uint32_t b = sg[0] * u32(h[1]) + sg[1] * u32(h[2]) + sg[2] * u32(h[3]);
      const int32_t pen = max((wrap_dot4(w, w) >> 18) - 0x8FF, 0);

      // the dependent path: qoa_div, quantize, dequantize, reconstruct,
      // next prediction.  qoa_div of residual = s - pred (|s| <= 2^15,
      // |pred| < 2^18):
      // wrapping reciprocal multiply, +0.5 bias, then the away-from-zero
      // fix nq + sgn(residual) - sgn(nq) (the multiply can wrap).  The
      // product is s * recip + 2^15, known before pred, minus pred * recip:
      // one multiply-add after pred.  sgn(residual) is a clamp beside it,
      // and nq - sgn(nq) = max(nq - 1, 0) + min(nq + 1, 0) (|nq| <= 2^15)
      const int32_t p = static_cast<int32_t>(mad(u32(pred), c.neg_recip,
                                                 u32(s[k]) * c.recip + 32768u));
      const int32_t sr = min(max(s[k] - pred, -1), 1);
      const int32_t nq = p >> 16;
      const int32_t scaled = max(nq - 1, 0) + min(nq + 1, 0) + sr;
      // QOA_QUANT_TAB in closed form, the [-8, 8] clamp folded into min;
      // the selector takes bytes 2*idx and 2*idx+1 and fills the high half
      // with the sign of byte 2*idx+1
      const int neg = scaled < 0;
      const int idx = min(abs(scaled) >> 1, 3);
      const int32_t dq = prmt(neg ? c.neg01 : c.pos01, neg ? c.neg23 : c.pos23,
                              u32(idx) * 0x2222u + 0x9910u);
      const int32_t recon = min(max(pred + dq, -32768), 32767);
      const int32_t delta = dq >> 4;
      const uint32_t w3 = u32(w[3]) + sg[3] * u32(delta);
      pred = static_cast<int32_t>(a + u32(delta) * b + w3 * u32(recon)) >> 13;

      // off the path: the carried state, the rank and the word
#pragma unroll
      for (int i = 0; i < 3; ++i) w[i] = static_cast<int32_t>(u32(w[i]) + sg[i] * u32(delta));
      w[3] = static_cast<int32_t>(w3);
      h[0] = h[1];
      h[1] = h[2];
      h[2] = h[3];
      h[3] = recon;
      const int32_t err = s[k] - recon;  // |err| < 2^16
      r.err += static_cast<uint64_t>(static_cast<int64_t>(err) * err);
      r.pen += u32(pen) * u32(pen);
      // code k sits at bit 57 - 3k of the word: the high half for k < 9,
      // split across the halves for k == 9, the low half after
      const uint32_t q = u32((idx << 1) | neg);
      if (k < 9) {
        hi += q << (25 - 3 * k);
      } else if (k == 9) {
        hi += q >> 2;
        lo += q << 30;
      } else {
        lo += q << (57 - 3 * k);
      }
    }
    if (k == 0) r.first = r.err + r.pen;
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

  // the chain's carried LMS and its prediction, identical in all 16 lanes
  int32_t h[4], w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = state_in[i * N + chain];
    w[i] = state_in[(4 + i) * N + chain];
  }
  int32_t pred = wrap_dot4(w, h) >> 13;

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
      int32_t cpred = pred;
      Rank rank = {0, 0, 0};
      const uint32_t sf_bits = u32(lane) << 28;  // bits 60-63 of the word
      uint32_t hi = sf_bits, lo = 0;
      // Warp-uniform choice: when every chain of the warp is full or ended
      // (length 0), all run the full steps and an ended chain's result is
      // reset to "no step ran" below.  Two chains of one warp on different
      // paths run both paths one after the other.
      const bool full_steps =
          !MASKED || (__all_sync(kFullMask, length == kSliceLen || length == 0) &&
                      __any_sync(kFullMask, length == kSliceLen));
      if (full_steps) {
        run_window<true>(s, length, cand, ch, cw, cpred, rank, hi, lo);
        if (MASKED && length == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ch[i] = h[i];
            cw[i] = w[i];
          }
          cpred = pred;
          rank = {0, 0, 0};
          hi = sf_bits;
          lo = 0;
        }
      } else {
        run_window<false>(s, length, cand, ch, cw, cpred, rank, hi, lo);
      }

      // lexicographic argmin over (total, first, sf) across the 16 lanes
      uint64_t bt = rank.err + rank.pen, bf = rank.first;
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
      pred = __shfl_sync(kFullMask, cpred, bs, kLanes);
      const uint32_t best_hi = __shfl_sync(kFullMask, hi, bs, kLanes);
      const uint32_t best_lo = __shfl_sync(kFullMask, lo, bs, kLanes);
      if (store) words[g * N + chain] = (static_cast<uint64_t>(best_hi) << 32) | best_lo;
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
