// Greedy minimum-distance selection: cv2's in-order overlap removal over
// each plane's support-sorted circle candidates (kernel G).
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
// written once; far above that, the latency of the chain of decisions, one
// per live candidate of a plane. A first design spent ~0.29 us a
// candidate on an H100 (the K = 8192 case) on a 128-thread
// __syncthreads_or and a test against all max_out slots, used or not. A
// warp walking the candidates alone, with no barrier, took 0.44 us a
// candidate there, and 0.23 us with the stored positions in registers: a
// step is a chain of dependent shuffles, float operations and a vote that
// no other warp can overlap. This design takes the candidates kBatch at a
// time, so the tests run in parallel and only bit operations stay in the
// chain (0.056 us a candidate there; PERF.md, Findings):
//   * One block of kThreads threads per plane. It finds its live length
//     (last live index + 1, so a call makes no host read) and writes the
//     flags past it.
//   * A batch's positions are staged in shared memory (the next batch's
//     while this one is decided). Every candidate of the batch is tested
//     against the stored prefix at once, slot s by warp s % kWarps, the
//     candidate by lane: only slots 0..cnt-1, since an unused slot at
//     -2^30 never clashes. The warps also test each candidate against the
//     batch's earlier ones, and OR the results into shared masks.
//   * One thread then decides the batch in order with masks alone:
//     candidate k is taken iff it is live, clashes with no stored
//     position, and no earlier candidate of the batch that was taken and
//     stored lies within min_dist. Taken candidates past max_out are
//     reported but not stored, so they block nothing, as in the JAX code.
//     The taken and stored ones are appended to the stored prefix in
//     order. Three barriers a batch, none a candidate.
//   * The distance test is the JAX code's float32 operations in its order,
//     with explicit round-to-nearest products and sum (the library is also
//     built with --fmad=false): coordinates are integers, so every d^2 is
//     exact, and the comparison is the strict < of the reference, so a
//     candidate at exactly min_dist does not clash.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;  // candidates decided together, a lane each
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ bool clashes(float2 a, float2 f, float md2) {
  const float dy = __fsub_rn(a.x, f.x);
  const float dx = __fsub_rn(a.y, f.y);
  return __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) < md2;
}

// Candidate base + lane of a plane into cand[lane], and the batch's live
// mask into *live_mask (one warp).
template <typename Idx>
__device__ __forceinline__ void stage(const Idx* yp, const Idx* xp,
                                      const unsigned char* lp, int i,
                                      int n_live, float2* cand,
                                      unsigned* live_mask) {
  const bool l = i < n_live && lp[i];
  cand[threadIdx.x & 31] = l ? make_float2(static_cast<float>(yp[i]),
                                           static_cast<float>(xp[i]))
                             : make_float2(0.0f, 0.0f);
  const unsigned m = __ballot_sync(0xffffffffu, l);
  if ((threadIdx.x & 31) == 0) *live_mask = m;
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
greedy_kernel(const Idx* __restrict__ ys, const Idx* __restrict__ xs,
              const unsigned char* __restrict__ live,
              unsigned char* __restrict__ accepted, int K, int max_out,
              float md2) {
  extern __shared__ float2 slots[];  // [max_out] the stored acceptances
  __shared__ float2 cand[2][kBatch];  // a batch's positions, double-buffered
  __shared__ unsigned live_mask[2];
  __shared__ unsigned conf[kBatch];   // earlier candidates within min_dist
  __shared__ unsigned s_pre;          // candidates that clash with a slot
  __shared__ unsigned s_take, s_store;
  __shared__ int s_live;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
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
  if (t == 0) {
    s_live = 0;
    s_pre = 0;
  }
  if (t < kBatch) conf[t] = 0;
  __syncthreads();
  atomicMax(&s_live, n);
  __syncthreads();
  const int n_live = s_live;
  for (int i = n_live + t; i < K; i += kThreads) out[i] = 0;
  if (warp == 0) stage(yp, xp, lp, lane, n_live, cand[0], &live_mask[0]);
  __syncthreads();

  int cnt = 0;  // stored acceptances, the same in every thread
  for (int base = 0, buf = 0; base < n_live; base += kBatch, buf ^= 1) {
    if (warp == kWarps - 1) {  // the next batch, into the other buffer
      stage(yp, xp, lp, base + kBatch + lane, n_live, cand[buf ^ 1],
            &live_mask[buf ^ 1]);
    }
    // candidate `lane` against the stored slots of this warp, and against
    // the batch's earlier candidates of this warp's share
    const float2 f = cand[buf][lane];
    bool clash = false;
#pragma unroll 4
    for (int s = warp; s < cnt; s += kWarps) clash |= clashes(slots[s], f, md2);
    const unsigned pre = __ballot_sync(0xffffffffu, clash);
    if (lane == 0 && pre) atomicOr(&s_pre, pre);
    unsigned earlier = 0;
    for (int j = warp; j < lane; j += kWarps) {
      if (clashes(cand[buf][j], f, md2)) earlier |= 1u << j;
    }
    if (earlier) atomicOr(&conf[lane], earlier);
    __syncthreads();

    if (t == 0) {  // the batch's decisions, in order
      unsigned c[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) c[k] = conf[k];
      const unsigned todo = live_mask[buf] & ~s_pre;
      unsigned take = 0, store = 0;
      int stored = cnt;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if ((todo >> k & 1u) && !(c[k] & store)) {
          take |= 1u << k;
          if (stored < max_out) {
            store |= 1u << k;
            ++stored;
          }
        }
      }
      s_take = take;
      s_store = store;
    }
    __syncthreads();

    const unsigned take = s_take;
    const unsigned store = s_store;
    if (t < kBatch) {
      if (base + t < n_live) out[base + t] = take >> t & 1u;
      if (store >> t & 1u) {
        slots[cnt + __popc(store & ((1u << t) - 1))] = cand[buf][t];
      }
      conf[t] = 0;
    }
    if (t == 0) s_pre = 0;
    cnt += __popc(store);
    __syncthreads();  // the stored slots and the next batch are in place
  }
}

template <typename Idx>
int launch(const void* ys, const void* xs, const unsigned char* live,
           unsigned char* accepted, int P, int K, int max_out, float md2,
           cudaStream_t s) {
  const size_t smem = (size_t)max_out * sizeof(float2);
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
// every entry written; max_out >= 1 slots of accepted positions (8 *
// max_out bytes of shared memory per block); md2: float32 min_dist^2.
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
