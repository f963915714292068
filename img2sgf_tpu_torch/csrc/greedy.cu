// Greedy minimum-distance selection: cv2's in-order overlap removal over
// each plane's support-sorted circle candidates.
//
// Replaces no Pallas kernel: in the JAX package this is greedy_min_dist
// (img2sgf_tpu/hough/circles.py:823), a lax.fori_loop that XLA keeps on the
// device. Plain PyTorch can express it only as a host loop or as a device
// loop of several launches per candidate, so it is a kernel of its own.
// Candidate i of a plane is accepted iff it is live and no earlier accepted
// candidate lies closer than min_dist: (ay - fy)^2 + (ax - fx)^2 < md2 in
// float32, tested against a [max_out] buffer of accepted positions whose
// unused slots sit at -2^30. Acceptances past max_out are still reported
// but stop blocking, as in the JAX code (the caller keeps only the first
// max_out).
//
// Bound: the bytes of ys, xs (4 or 8 each), live and accepted, read or
// written once; far above that, the latency of n_live dependent steps per
// plane, each a distance test against the accepted buffer and a block-wide
// OR. Making it fast is later work; this design is the simple one:
//   * One block per plane. The block finds its live length (last live
//     index + 1) itself, so a call makes no host read.
//   * The accepted buffer lives in shared memory, and each slot belongs to
//     one thread (slot s to thread s % kThreads), which both tests and
//     writes it: the walk needs one barrier per candidate, the
//     __syncthreads_or that decides the clash, and no other.
//   * Candidates are staged kThreads at a time into shared memory, one
//     barrier pair per tile.
//   * The distance test is the JAX code's float32 operations in its order,
//     with explicit round-to-nearest products and sum (the library is also
//     built with --fmad=false): coordinates are integers, so every d^2 is
//     exact, and the comparison is the strict < of the reference, so a
//     candidate at exactly min_dist does not clash.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr float kFar = -1073741824.0f;  // -2^30: an unused slot
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
greedy_kernel(const Idx* __restrict__ ys, const Idx* __restrict__ xs,
              const unsigned char* __restrict__ live,
              unsigned char* __restrict__ accepted, int K, int max_out,
              float md2) {
  extern __shared__ float buf[];
  float* ay = buf;            // [max_out] accepted rows
  float* ax = buf + max_out;  // [max_out] accepted columns
  __shared__ float ty[kThreads];
  __shared__ float tx[kThreads];
  __shared__ unsigned char tl[kThreads];
  __shared__ int s_live;

  const int t = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * K;
  const Idx* yp = ys + row;
  const Idx* xp = xs + row;
  const unsigned char* lp = live + row;
  unsigned char* out = accepted + row;

  // live length: the last live index + 1 (live need not be a prefix)
  int n = 0;
  for (int i = t; i < K; i += kThreads) {
    if (lp[i]) n = i + 1;
  }
  if (t == 0) s_live = 0;
  for (int s = t; s < max_out; s += kThreads) {  // each thread its own slots
    ay[s] = kFar;
    ax[s] = kFar;
  }
  __syncthreads();
  atomicMax(&s_live, n);
  __syncthreads();
  const int n_live = s_live;
  for (int i = n_live + t; i < K; i += kThreads) out[i] = 0;

  int cnt = 0;  // acceptances stored so far, the same in every thread
  for (int base = 0; base < n_live; base += kThreads) {
    const int n_tile = min(kThreads, n_live - base);
    __syncthreads();  // the previous tile is read
    if (t < n_tile) {
      ty[t] = static_cast<float>(yp[base + t]);
      tx[t] = static_cast<float>(xp[base + t]);
      tl[t] = lp[base + t];
    }
    __syncthreads();
    for (int k = 0; k < n_tile; ++k) {
      if (!tl[k]) {  // the same in every thread: a dead candidate blocks
        if (t == 0) out[base + k] = 0;  // nothing and is not accepted
        continue;
      }
      const float fy = ty[k];
      const float fx = tx[k];
      int clash = 0;
      for (int s = t; s < max_out; s += kThreads) {
        const float dy = __fsub_rn(ay[s], fy);
        const float dx = __fsub_rn(ax[s], fx);
        const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
        clash |= d2 < md2;
      }
      const bool take = !__syncthreads_or(clash);
      if (take && cnt < max_out) {
        if (cnt % kThreads == t) {  // the slot's owner writes it
          ay[cnt] = fy;
          ax[cnt] = fx;
        }
        ++cnt;
      }
      if (t == 0) out[base + k] = take;
    }
  }
}

template <typename Idx>
int launch(const void* ys, const void* xs, const unsigned char* live,
           unsigned char* accepted, int P, int K, int max_out, float md2,
           cudaStream_t s) {
  const size_t smem = 2 * (size_t)max_out * sizeof(float);
  cudaError_t e;
  if (smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(greedy_kernel<Idx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  greedy_kernel<Idx><<<P, kThreads, smem, s>>>(
      static_cast<const Idx*>(ys), static_cast<const Idx*>(xs), live,
      accepted, K, max_out, md2);
  return cudaGetLastError();
}

}  // namespace

// ys, xs: [P, K] int32 (idx64 = 0) or int64 (idx64 = 1) candidate centres
// in the order of acceptance; live: [P, K] bool; accepted: [P, K] bool,
// every entry written; max_out >= 1 slots of accepted positions (2 *
// max_out floats of shared memory per block); md2: float32 min_dist^2.
// Returns a cudaError_t.
extern "C" int img2sgf_greedy(const void* ys, const void* xs,
                              const unsigned char* live,
                              unsigned char* accepted, int P, int K,
                              int max_out, float md2, int idx64,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64) {
    return launch<long long>(ys, xs, live, accepted, P, K, max_out, md2, s);
  }
  return launch<int>(ys, xs, live, accepted, P, K, max_out, md2, s);
}
