// QOA batched LMS decoder for Hopper (sm_90a), with the store-shape probe.
//
// Replaces: qoaudio_tpu/ops/pallas_decode.py::decode_chains_pallas (the
// Pallas kernel `_make_kernel.kernel`) and
// experiments/pallas_decode_variants.py::run_variant (its five store shapes).
// Plain versions beside it: qoaudio_tpu_torch/ops/decode.py::
// decode_chains_words and ::decode_chains_variant.
//
// What it computes: for every chain (frame x channel of some file) and
// every slice window, unpack sf and the 20 3-bit codes from the slice word,
// dequantize, and run the LMS predict / reconstruct / update recurrence,
// storing all 20 reconstructed samples (untrimmed) as int16.
//
// One template on the store mode and the block size; the production decoder
// is mode kV0 at 64 threads:
// * kV0       per-sample int16 stores, (W, 20, N) — the production kernel;
// * kNoStore  the whole recurrence, no sample stores: only the final h[3]
//             of each chain, at out[0, 0, n] (the rest is not written) —
//             the compute ceiling;
// * kStoreOnly out[w, k, n] = code k of word (w, n), no LMS — the store
//             cost;
// * kStack    the 20 samples of a window held in registers and stored
//             after its last step;
// * kPack32   sample pairs packed into int32, (W, 10, N): element j is
//             (s[2j] & 0xFFFF) | (s[2j+1] << 16).
//
// What bounds it on the H100: the recurrence is serial, W x 20 dependent
// steps per chain (5,120 for a full frame), and the chain count is the
// only parallelism — a 33-file corpus has ~7,000 chains, about 1.7 warps
// per SM.  So the kernel is latency-bound on the dependency chain, not
// on bytes (it reads 8 B and writes 40 B per chain-window).
//
// What the design does about it:
// * one thread per chain, the LMS held in registers across ALL W windows
//   (on the TPU the carry lived in VMEM scratch across window blocks of a
//   sequential grid; CUDA blocks run in no order, so nothing is carried
//   between blocks, and the loop over windows runs inside the thread);
// * small blocks (64 threads, the production launch; the probe takes 64,
//   128 or 256, the counterpart of the Pallas tile) to spread the few
//   warps over many SMs.  The block size is a template parameter and the
//   kernel's launch bound: a bound of 256 gave the kV0 loop 671 SASS
//   instructions per window against 642 at 64 (cuobjdump on the H100
//   build), so each block size is compiled for itself;
// * the thread reads its raw big-endian u64 word (coalesced: neighbouring
//   threads on neighbouring chains) and byteswaps it in registers, so no
//   host or device pass makes logical halves, and code 9 no longer
//   straddles two u32 halves;
// * the 16-entry scalefactor table sits in __constant__ memory and the
//   four dequant magnitudes follow by closed form once per window; the
//   code -> residual decode is independent of the LMS, so it overlaps the
//   dependent chain;
// * stores are (W, 20, N) int16 with neighbouring threads on neighbouring
//   chains; the ragged edge is masked here (no 128-lane padding).
//
// Integer semantics: the reference wraps int32 adds and multiplies; signed
// overflow is undefined in C++, so those run in uint32 and cast back, and
// every >> stays on a signed int (arithmetic shift).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int32_t kScalefactorTab[16] = {
    1, 7, 21, 45, 84, 138, 211, 304, 421, 562, 731, 928, 1157, 1419, 1715, 2048};

constexpr int kSliceLen = 20;
constexpr int kThreads = 64;  // the production launch

enum StoreMode : int { kV0 = 0, kNoStore = 1, kStoreOnly = 2, kStack = 3, kPack32 = 4 };

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_dot4(const int32_t* w, const int32_t* h) {
  uint32_t s = static_cast<uint32_t>(w[0]) * static_cast<uint32_t>(h[0]);
  s += static_cast<uint32_t>(w[1]) * static_cast<uint32_t>(h[1]);
  s += static_cast<uint32_t>(w[2]) * static_cast<uint32_t>(h[2]);
  s += static_cast<uint32_t>(w[3]) * static_cast<uint32_t>(h[3]);
  return static_cast<int32_t>(s);
}

__device__ __forceinline__ uint64_t bswap64(uint64_t raw) {
  const uint32_t lo = static_cast<uint32_t>(raw);
  const uint32_t hi = static_cast<uint32_t>(raw >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

// out: int16 (W, 20, N), or int32 (W, 10, N) for kPack32; launched with
// THREADS threads per block.
template <int MODE, int THREADS>
__global__ void __launch_bounds__(THREADS)
qoa_decode_kernel(const uint64_t* __restrict__ words_be,
                  const int32_t* __restrict__ state, int n_windows,
                  int n_chains, int16_t* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_chains) return;
  const size_t N = static_cast<size_t>(n_chains);

  int32_t h[4], w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = state[i * N + n];
    w[i] = state[(4 + i) * N + n];
  }

  for (int win = 0; win < n_windows; ++win) {
    const uint64_t word = bswap64(words_be[win * N + n]);
    int16_t* dst = out + static_cast<size_t>(win) * kSliceLen * N + n;
    if constexpr (MODE == kStoreOnly) {
#pragma unroll
      for (int k = 0; k < kSliceLen; ++k)
        dst[k * N] = static_cast<int16_t>((word >> (57 - 3 * k)) & 7u);
      continue;
    }
    const int32_t sfv = kScalefactorTab[static_cast<int>(word >> 60)];
    const int32_t m0 = (3 * sfv + 2) >> 2;
    const int32_t m1 = (5 * sfv + 1) >> 1;
    const int32_t m2 = (9 * sfv + 1) >> 1;
    const int32_t m3 = 7 * sfv;
    int32_t held[kSliceLen];  // kStack / kPack32: the window's samples

#pragma unroll
    for (int k = 0; k < kSliceLen; ++k) {
      const int code = static_cast<int>((word >> (57 - 3 * k)) & 7u);
      const int idx = code >> 1;
      const int32_t mag = idx < 2 ? (idx == 0 ? m0 : m1) : (idx == 2 ? m2 : m3);
      const int32_t dq = (code & 1) ? -mag : mag;

      const int32_t pred = wrap_dot4(w, h) >> 13;
      int32_t r = pred + dq;  // |pred| < 2^18, |dq| < 2^14: no overflow
      r = r < -32768 ? -32768 : (r > 32767 ? 32767 : r);
      if constexpr (MODE == kV0) dst[k * N] = static_cast<int16_t>(r);
      if constexpr (MODE == kStack || MODE == kPack32) held[k] = r;

      const int32_t delta = dq >> 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = wrap_add(w[i], h[i] < 0 ? -delta : delta);
      h[0] = h[1];
      h[1] = h[2];
      h[2] = h[3];
      h[3] = r;
    }
    if constexpr (MODE == kStack) {
#pragma unroll
      for (int k = 0; k < kSliceLen; ++k) dst[k * N] = static_cast<int16_t>(held[k]);
    }
    if constexpr (MODE == kPack32) {
      int32_t* dst32 =
          reinterpret_cast<int32_t*>(out) + static_cast<size_t>(win) * (kSliceLen / 2) * N + n;
#pragma unroll
      for (int j = 0; j < kSliceLen / 2; ++j)
        dst32[j * N] = static_cast<int32_t>((static_cast<uint32_t>(held[2 * j]) & 0xFFFFu) |
                                            (static_cast<uint32_t>(held[2 * j + 1]) << 16));
    }
  }
  if constexpr (MODE == kNoStore) {
    if (n_windows > 0) out[n] = static_cast<int16_t>(h[3]);
  }
}

template <int MODE, int THREADS>
int launch(const void* words_be, const void* state, int n_windows, int n_chains,
           void* out, void* stream) {
  if (n_windows > 0 && n_chains > 0) {
    const int blocks = (n_chains + THREADS - 1) / THREADS;
    qoa_decode_kernel<MODE, THREADS><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(words_be), static_cast<const int32_t*>(state),
        n_windows, n_chains, static_cast<int16_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const void* words_be, const void* state, int n_windows, int n_chains,
                void* out, int threads, void* stream) {
  switch (threads) {
    case 64: return launch<MODE, 64>(words_be, state, n_windows, n_chains, out, stream);
    case 128: return launch<MODE, 128>(words_be, state, n_windows, n_chains, out, stream);
    case 256: return launch<MODE, 256>(words_be, state, n_windows, n_chains, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// words_be: (W, N) raw big-endian u64; state: (8, N) int32;
// out: (W, 20, N) int16.  Launches the kV0 kernel on `stream` with the
// production block of 64 threads (the probe's v0 at 64 threads is this
// same kernel), does not synchronise.  Returns
// cudaGetLastError() as an int (0 on success).
extern "C" int qoa_decode_chains_cuda(const void* words_be, const void* state,
                                      int n_windows, int n_chains, void* out,
                                      void* stream) {
  return launch<kV0, kThreads>(words_be, state, n_windows, n_chains, out, stream);
}

// The store-shape probe: the same decode with store mode `mode` (0 v0,
// 1 nostore, 2 storeonly, 3 stack, 4 pack32) and `threads` per block (64,
// 128 or 256).  out: int16 (W, 20, N), or int32 (W, 10, N) for pack32.
// Returns cudaErrorInvalidValue for another mode or block size, else
// cudaGetLastError().
extern "C" int qoa_decode_variant_cuda(const void* words_be, const void* state,
                                       int n_windows, int n_chains, void* out,
                                       int mode, int threads, void* stream) {
  switch (mode) {
    case kV0: return launch_mode<kV0>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kNoStore:
      return launch_mode<kNoStore>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kStoreOnly:
      return launch_mode<kStoreOnly>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kStack: return launch_mode<kStack>(words_be, state, n_windows, n_chains, out, threads, stream);
    case kPack32:
      return launch_mode<kPack32>(words_be, state, n_windows, n_chains, out, threads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* qoa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
