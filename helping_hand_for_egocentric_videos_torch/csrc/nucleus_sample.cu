// Nucleus (top-p) sampling of the next token, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no generative path. It was
// added for LaViLa's narrator (ops/sampling.py), whose plain route sorted
// the whole (rows, V) score matrix every decode step (a segmented radix
// sort that moves int64 indices, then softmax, cumsum, scatter, a second
// softmax and the race: ~15 passes over the scores).
//
// What it computes, per row of f32 logits (ops/sampling.py states the rule;
// nucleus_threshold_ref and sample_next_ref are the plain versions):
//   s = logits / temperature (IEEE division), m = max s, w = exp(s - m)
//   in f32 counted in integer units of 2^-36, Z = the (exact) sum of w,
//   target = top_p * Z in double;
//   the edge t* = the lowest score of positive weight whose mass above
//   (the weight of the scores strictly greater) is below target, or the
//   row's top score where none is (top_p 0); every s >= t* is kept, so
//   tokens tied at the edge are all kept, the top token always is, and a
//   -inf logit (weight 0) never is;
//   the draw: argmax over the kept tokens of s - log(E), E = -log(u) an
//   exponential(1), u from word c % 4 of Philox4x32-10 of the counter
//   (c / 4, row) for column c, keyed by the caller's 64-bit seed; ties go
//   to the lowest column.
// A row with no finite logit draws 0.
//
// Bound. One read of the logits and 8 bytes written a row: at the
// narrator's (640, 50257) 128.66 MB, 38.4 us at 3.35 TB/s. Every pass after
// the first reads shared memory, not device memory; what bounds the kernel
// in practice is the SM's instruction issue over 50257 scores a row (a
// division, an exp and a bin each; a Philox call a quad and two logs a kept
// score), PERF.md section 6 (K7).
//
// Design: one block of 1024 threads holds a row in shared memory (201 KB at
// V = 50257; the limit is kMaxVocab), so one block an SM; the grid is one
// block an SM (more where a short row fits more), each walking rows
// blockIdx.x, + gridDim.x, ...
//   - Staging: 16-byte cp.async copies of the row's 16-byte-aligned middle
//     (a row of 50257 floats starts anywhere mod 16 bytes: the shared copy
//     is offset to match), in 4 commit groups; each thread divides the
//     chunks it copied as its groups land and keeps the max and the least
//     finite score. No barrier between the copy and that pass: a thread
//     reads only what it copied. (A bulk copy (TMA) into mbarriers measured
//     no faster, nor did prefetching the block's next row into L2.)
//   - The masses are exact: a weight is counted in integer units of 2^-36
//     (u64), so every sum is exact whatever the order of the atomics, the
//     kernel gives the same ids run after run, and the plain version,
//     doing the same integer sums, the same edge but where an exp differs in
//     its last bit. Shared-memory atomics on floats or on 64 bits are
//     compare-and-swap loops on sm_90; on 32 bits they are native, so round
//     1 adds a weight's count in two 18-bit halves.
//   - Round 1: a mass histogram of the scores over 255 linear bins of
//     d = m - s across [0, span), span = min(m - least, 32), and one bin for
//     the rest. Linear bins spread a row's bulk over many bins, where the
//     top byte of a float's key would hold it in a handful. The last bin's
//     mass (d >= span, weights below e^-32 when the span is cut, and -inf)
//     is summed in registers instead, where most of a wide row falls. 8
//     histograms, each shared by 4 warps. Z is the histograms' sum; the edge
//     bin b* is the last of positive mass whose mass above is below target.
//   - The split, one pass: the bins above b* are kept and race at once; b*'s
//     columns are listed (1024 of them, or the row rescanned where more
//     fall in it), with the least and greatest order-preserving key among
//     them. A warp scans 128 columns at a time without bank conflicts and
//     queues the quads of 4 columns that hold a kept one (ballots); it
//     draws 64 queued quads at a time, two a lane (one Philox call gives a
//     quad's 4 words), so the Philox and the logs run with full warps on
//     kept scores.
//   - Rounds 2-5: a mass-weighted radix select on the exact 32-bit keys of
//     b*'s scores, 8 bits a round from the first bit where the least and
//     greatest key differ (the common prefix is skipped, so no round puts
//     every candidate in one bin), each digit chosen by the same rule with
//     the mass above carried down. The last round leaves one key: t*.
//   - b*'s columns at or above t* race; a block argmax ends the row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kHists = kWarps / 4;         // round 1's histograms, one to 4 warps
constexpr int kQueue = 96;                 // a warp's queue of quads holding kept columns
constexpr int kListCap = kHists * kBins * 2 - kWarps * kQueue;  // b*'s columns listed (ints)
constexpr int kWindow = 128;               // columns a warp scans at once in the split pass
constexpr int kGroups = 4;                 // cp.async commit groups of the staging
constexpr float kSpan = 32.f;              // the widest span of round 1's linear bins
constexpr float kFix = 0x1p36f;            // a weight's fixed-point scale
constexpr int kLoBits = 18;                // round 1 adds a weight's count in two 18-bit halves
constexpr int kMaxVocab = 53248;           // ops/sampling.py's MAX_VOCAB
constexpr int kMaxDevices = 64;

// Order-preserving 32-bit key of a float (-0 taken as +0): a greater float
// has a greater key.
__device__ __forceinline__ uint32_t order_key(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A score's weight exp(s - m) as an integer count of 2^-36: exact for
// weights from 2^-13 up, rounded to the nearest count below that.
__device__ __forceinline__ u64 weight(float s, float m) { return __float2ull_rn(expf(s - m) * kFix); }

// Philox4x32-10 (Salmon et al., SC'11) of the counter (c0, c1, 0, 0) under
// the key (k0, k1): the four output words.
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// A column's race key: its score less log(E), E = -log(u) exponential(1),
// u = (2 (x >> 9) + 1) / 2^24 in (0, 1) from its Philox word x.
__device__ __forceinline__ float race_key(float s, uint32_t x) {
  const float u = static_cast<float>(((x >> 9) << 1) | 1u) * 0x1p-24f;  // exact
  return s - logf(-logf(u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Round 1's bin of a score: 0..254 linear in d = m - s over [0, span), 255
// beyond it (and for -inf).
__device__ __forceinline__ int bin_of(float s, float m, float inv) {
  return min(static_cast<int>((m - s) * inv), kBins - 1);
}

// The edge digit of one round, by warp 0 alone. hist holds the masses of
// nd <= 256 digits, hist[j] the j-th from the top (descending scores).
// The chosen digit is the last of positive mass whose mass above (``above``
// plus the digits before it) is below target, or equals ``above`` (the
// first positive digit, which holds the row's top score where target is
// 0). Returns j and sets *above_out to its mass above, *total to the sum
// of all digits.
__device__ __forceinline__ int edge_digit(const u64* hist, int nd, u64 above, double target,
                                          u64* above_out, u64* total) {
  const int lane = threadIdx.x & 31;
  u64 mu[8], run = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = lane * 8 + i;
    mu[i] = j < nd ? hist[j] : 0ull;
    run += mu[i];
  }
  u64 incl = run;  // inclusive scan of the lanes' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  *total = __shfl_sync(0xffffffffu, incl, 31);
  const u64 prev = __shfl_up_sync(0xffffffffu, incl, 1);
  u64 excl = above + (lane ? prev : 0ull);
  int pick = -1;
  u64 pick_above = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (mu[i] > 0 && (static_cast<double>(excl) < target || excl == above)) {
      pick = lane * 8 + i;
      pick_above = excl;
    }
    excl += mu[i];
  }
  const unsigned has = __ballot_sync(0xffffffffu, pick >= 0);
  const int src = has ? 31 - __clz(has) : 0;
  pick = __shfl_sync(0xffffffffu, pick, src);
  *above_out = __shfl_sync(0xffffffffu, pick_above, src);
  return pick;
}

struct Shared {
  float red_max[kWarps], red_min[kWarps];
  float race_val[kWarps];
  int race_col[kWarps];
  u64 above, over[kHists];
  double target;
  float top, inv;
  int bstar, count;
  unsigned kmin, kmax, prefix;
};

// The race's running best: the greatest key, ties to the lowest column.
struct Best {
  float key = -INFINITY;
  int col = 0x7fffffff;
  __device__ __forceinline__ void offer(float k, int c) {
    if (k > key || (k == key && c < col)) {
      key = k;
      col = c;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
nucleus_sample_kernel(const float* __restrict__ logits, long long* __restrict__ out,
                      float* __restrict__ threshold_out, const long long* __restrict__ seed,
                      int rows, int v, float temperature, float top_p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint64_t sd = static_cast<uint64_t>(*seed);
  const uint32_t k0 = static_cast<uint32_t>(sd), k1 = static_cast<uint32_t>(sd >> 32);

  // layout: [row (v + 3 floats, rounded to 4)] [round 1's histograms; later
  // b*'s list and the warps' queues] [the block histogram]
  u64* hw = reinterpret_cast<u64*>(smem + ((v + 3 + 3) & ~3));
  u64* hb = hw + kHists * kBins;
  int* list = reinterpret_cast<int*>(hw);
  int* queue = list + kListCap + warp * kQueue;  // entries: quad << 4 | its kept columns' bits

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* g = logits + static_cast<long long>(row) * v;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
    float* srow = smem + mis;  // srow[head] lies on a 16-byte boundary, as g + head does
    __syncthreads();  // the previous row is done with shared memory

    // ---- staging, the division, the max and the least finite score
    const int head = min((4 - mis) & 3, v);
    const int chunks = (v - head) >> 2;
    const int tail0 = head + 4 * chunks;
    const int iters = (chunks + kThreads - 1) / kThreads;
    const int per_group = (iters + kGroups - 1) / kGroups;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      for (int j = q * per_group; j < min((q + 1) * per_group, iters); ++j) {
        const int c = j * kThreads + tid;
        if (c < chunks) cp_async16(srow + head + 4 * c, g + head + 4 * c);
      }
      cp_async_commit();
    }
    for (int i = tid; i < kHists * kBins; i += kThreads) hw[i] = 0ull;
    if (tid < kHists) sh.over[tid] = 0ull;
    float mx = -INFINITY, mn = INFINITY;
    auto take = [&](float& x) {
      x = x / temperature;
      mx = fmaxf(mx, x);
      if (x != -INFINITY) mn = fminf(mn, x);
    };
    auto group = [&](int q) {
      for (int j = q * per_group; j < min((q + 1) * per_group, iters); ++j) {
        const int c = j * kThreads + tid;
        if (c < chunks) {
          float4 x = *reinterpret_cast<float4*>(srow + head + 4 * c);
          take(x.x);
          take(x.y);
          take(x.z);
          take(x.w);
          *reinterpret_cast<float4*>(srow + head + 4 * c) = x;
        }
      }
    };
    cp_async_wait<3>();
    group(0);
    cp_async_wait<2>();
    group(1);
    cp_async_wait<1>();
    group(2);
    cp_async_wait<0>();
    group(3);
    {
      int i = -1;
      if (tid < head) i = tid;
      else if (tid >= 64 && tid < 64 + (v - tail0)) i = tail0 + tid - 64;
      if (i >= 0) {
        float x = g[i];
        take(x);
        srow[i] = x;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      sh.red_max[warp] = mx;
      sh.red_min[warp] = mn;
    }
    __syncthreads();
    if (warp == 0) {
      float a = sh.red_max[lane], b = sh.red_min[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
        b = fminf(b, __shfl_xor_sync(0xffffffffu, b, o));
      }
      if (lane == 0) {
        sh.top = a;
        const float span = fminf(a - b, kSpan);
        sh.inv = static_cast<float>(kBins - 1) / (span > 0.f ? span : 1.f);
      }
    }
    __syncthreads();
    const float m = sh.top, inv = sh.inv;
    if (m == -INFINITY) {  // no finite logit
      if (tid == 0) {
        out[row] = 0;
        if (threshold_out) threshold_out[row] = INFINITY;
      }
      continue;
    }

    // ---- round 1: mass histograms over the linear bins. A weight's count
    // (< 2^37) is added as two halves, each by a native 32-bit atomic (a
    // float or 64-bit one is a compare-and-swap loop): a histogram of 4
    // warps sees at most 6656 columns, so no half's sum passes 2^32.
    {
      unsigned* lo = reinterpret_cast<unsigned*>(hw) + (warp / (kWarps / kHists)) * 2 * kBins;
      unsigned* hi = lo + kBins;
      u64 over = 0;
      for (int i = tid; i < v; i += kThreads) {
        const float s = srow[i];
        const u64 w = weight(s, m);
        const int b = bin_of(s, m, inv);
        if (b < kBins - 1) {
          atomicAdd(lo + b, static_cast<unsigned>(w) & ((1u << kLoBits) - 1u));
          atomicAdd(hi + b, static_cast<unsigned>(w >> kLoBits));
        } else {
          over += w;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(0xffffffffu, over, o);
      if (lane == 0) atomicAdd(&sh.over[warp / (kWarps / kHists)], over);
    }
    __syncthreads();
    if (tid < kBins) {
      const unsigned* lo = reinterpret_cast<const unsigned*>(hw);
      u64 t = 0;
      for (int h = 0; h < kHists; ++h)
        t += static_cast<u64>(lo[2 * h * kBins + tid]) +
             (static_cast<u64>(lo[(2 * h + 1) * kBins + tid]) << kLoBits);
      if (tid == kBins - 1)
        for (int h = 0; h < kHists; ++h) t += sh.over[h];  // the registers' sums of the last bin
      hb[tid] = t;
    }
    __syncthreads();
    if (warp == 0) {
      u64 z = 0, above = 0;
      // Z first (the histogram's total), then the edge against top_p * Z
      edge_digit(hb, kBins, 0ull, 0.0, &above, &z);
      const double target = static_cast<double>(top_p) * static_cast<double>(z);
      const int b = edge_digit(hb, kBins, 0ull, target, &above, &z);
      if (lane == 0) {
        sh.bstar = b;
        sh.above = above;
        sh.target = target;
        sh.count = 0;
        sh.kmin = 0xffffffffu;
        sh.kmax = 0u;
      }
    }
    __syncthreads();
    const int bstar = sh.bstar;

    // ---- the split: the bins above b* are kept and race at once; b*'s
    // columns are listed, with their key range. A warp takes 128 columns at
    // a time, lane l the columns l, l + 32, l + 64, l + 96 (no bank
    // conflicts), then the Philox quad 4l..4l+3 of the window (one call
    // gives its 4 words); the kept bits cross lanes by ballots. A warp
    // draws its queued quads 64 at a time, two a lane.
    Best best;
    int queued = 0;
    auto race_one = [&](int e0) {
      const uint4 x0 = philox(static_cast<uint32_t>(e0 >> 4), static_cast<uint32_t>(row), k0, k1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = 4 * (e0 >> 4) + e;
        const float r0 = race_key(srow[c0], word(x0, e));
        if ((e0 >> e) & 1) best.offer(r0, c0);
      }
    };
    auto race_two = [&](int e0, int e1) {
      const uint4 x0 = philox(static_cast<uint32_t>(e0 >> 4), static_cast<uint32_t>(row), k0, k1);
      const uint4 x1 = philox(static_cast<uint32_t>(e1 >> 4), static_cast<uint32_t>(row), k0, k1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = 4 * (e0 >> 4) + e, c1 = 4 * (e1 >> 4) + e;
        const float r0 = race_key(srow[c0], word(x0, e)), r1 = race_key(srow[c1], word(x1, e));
        if ((e0 >> e) & 1) best.offer(r0, c0);
        if ((e1 >> e) & 1) best.offer(r1, c1);
      }
    };
    {
      unsigned kmin = 0xffffffffu, kmax = 0u;
      for (int c0 = warp * kWindow; c0 < v; c0 += kWarps * kWindow) {
        unsigned keep[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c0 + 32 * k + lane;
          const float s = c < v ? srow[c] : -INFINITY;
          const int b = s == -INFINITY ? kBins : bin_of(s, m, inv);
          keep[k] = __ballot_sync(0xffffffffu, b < bstar);
          const bool in = b == bstar;
          const unsigned members = __ballot_sync(0xffffffffu, in);
          if (members) {
            int at = 0;
            if (lane == 0) at = atomicAdd(&sh.count, __popc(members));
            at = __shfl_sync(0xffffffffu, at, 0) + __popc(members & ((1u << lane) - 1u));
            if (in) {
              if (at < kListCap) list[at] = c;
              const unsigned key = order_key(s);
              kmin = min(kmin, key);
              kmax = max(kmax, key);
            }
          }
        }
        const int sel = lane >> 3;
        const unsigned wd = sel == 0 ? keep[0] : sel == 1 ? keep[1] : sel == 2 ? keep[2] : keep[3];
        const int bits = static_cast<int>((wd >> ((4 * lane) & 31)) & 15u);
        const unsigned mask = __ballot_sync(0xffffffffu, bits != 0);
        if (bits) queue[queued + __popc(mask & ((1u << lane) - 1u))] = ((c0 >> 2) + lane) << 4 | bits;
        queued += __popc(mask);
        __syncwarp();
        if (queued >= 64) {
          race_two(queue[lane], queue[32 + lane]);
          __syncwarp();
          if (lane < queued - 64) queue[lane] = queue[64 + lane];
          __syncwarp();
          queued -= 64;
        }
      }
      // the rest of the queue (an entry of 0 has no kept bit)
      if (queued > 32) race_two(queue[lane], 32 + lane < queued ? queue[32 + lane] : 0);
      else if (queued > 0) race_one(lane < queued ? queue[lane] : 0);
      kmin = __reduce_min_sync(0xffffffffu, kmin);
      kmax = __reduce_max_sync(0xffffffffu, kmax);
      if (lane == 0) {
        atomicMin(&sh.kmin, kmin);
        atomicMax(&sh.kmax, kmax);
      }
    }
    __syncthreads();

    // ---- rounds 2-5: radix select on the exact keys of b*'s scores
    const int n = sh.count;
    const bool listed = n <= kListCap;
    const unsigned kmin = sh.kmin, kmax = sh.kmax;
    int shift = kmin == kmax ? 0 : 32 - __clz(kmin ^ kmax);
    if (tid == 0) sh.prefix = shift == 32 ? 0u : (kmin >> shift) << shift;
    __syncthreads();
    while (shift > 0) {
      const int bits = min(8, shift);
      shift -= bits;
      const int nd = 1 << bits;
      const unsigned prefix = sh.prefix;
      const int hi = shift + bits;  // bits at and above hi are fixed
      if (tid < kBins) hb[tid] = 0ull;
      __syncthreads();
      const int items = listed ? n : v;
      for (int t = tid; t < items; t += kThreads) {
        const int i = listed ? list[t] : t;
        const float s = srow[i];
        if (!listed && (s == -INFINITY || bin_of(s, m, inv) != bstar)) continue;
        const unsigned k = order_key(s);
        if ((static_cast<u64>(k) >> hi) != (static_cast<u64>(prefix) >> hi)) continue;
        const int digit = static_cast<int>((k >> shift) & static_cast<unsigned>(nd - 1));
        atomicAdd(hb + (nd - 1 - digit), weight(s, m));  // hb[j]: the j-th digit from the top
      }
      __syncthreads();
      if (warp == 0) {
        u64 above = 0, total = 0;
        const int j = edge_digit(hb, nd, sh.above, sh.target, &above, &total);
        if (lane == 0) {
          sh.above = above;
          sh.prefix = prefix | (static_cast<unsigned>(nd - 1 - j) << shift);
        }
      }
      __syncthreads();
    }
    const unsigned kstar = sh.prefix;
    if (tid == 0 && threshold_out) threshold_out[row] = key_value(kstar);

    // ---- b*'s kept columns race, each with its quad's Philox call
    {
      const int items = listed ? n : v;
      for (int t = tid; t < items; t += kThreads) {
        const int c = listed ? list[t] : t;
        const float s = srow[c];
        if (!listed && (s == -INFINITY || bin_of(s, m, inv) != bstar)) continue;
        if (order_key(s) < kstar) continue;
        const uint4 x = philox(static_cast<uint32_t>(c >> 2), static_cast<uint32_t>(row), k0, k1);
        best.offer(race_key(s, word(x, c & 3)), c);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ok = __shfl_xor_sync(0xffffffffu, best.key, o);
      const int oc = __shfl_xor_sync(0xffffffffu, best.col, o);
      best.offer(ok, oc);
    }
    if (lane == 0) {
      sh.race_val[warp] = best.key;
      sh.race_col[warp] = best.col;
    }
    __syncthreads();
    if (warp == 0) {
      Best b;
      b.offer(sh.race_val[lane], sh.race_col[lane]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ok = __shfl_xor_sync(0xffffffffu, b.key, o);
        const int oc = __shfl_xor_sync(0xffffffffu, b.col, o);
        b.offer(ok, oc);
      }
      if (lane == 0) out[row] = b.col;
    }
  }
}

size_t smem_bytes(int v) {
  return static_cast<size_t>((v + 3 + 3) & ~3) * sizeof(float) +
         static_cast<size_t>(kHists * kBins + kBins) * sizeof(u64);
}

}  // namespace

extern "C" int hh_nucleus_sample(const void* logits, void* out, void* threshold, const void* seed,
                                 long long rows, int v, float temperature, float top_p,
                                 void* stream) {
  if (v < 1 || v > kMaxVocab || rows < 0 || rows > 0x7fffffffLL || !(temperature > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  static size_t granted[kMaxDevices];  // dynamic shared memory already allowed, per device
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const size_t bytes = smem_bytes(v);
  if (bytes > granted[dev]) {
    if ((err = cudaFuncSetAttribute(nucleus_sample_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(bytes))) != cudaSuccess)
      return static_cast<int>(err);
    granted[dev] = bytes;
  }
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nucleus_sample_kernel, kThreads,
                                                           bytes)) != cudaSuccess)
    return static_cast<int>(err);
  // persistent blocks: each walks the rows blockIdx.x, + gridDim.x, ...
  const long long grid = rows < static_cast<long long>(sms[dev]) * max(per_sm, 1)
                             ? rows
                             : static_cast<long long>(sms[dev]) * max(per_sm, 1);
  nucleus_sample_kernel<<<static_cast<unsigned>(grid), kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<long long*>(out),
      static_cast<float*>(threshold), static_cast<const long long*>(seed), static_cast<int>(rows), v,
      temperature, top_p);
  return static_cast<int>(cudaGetLastError());
}
