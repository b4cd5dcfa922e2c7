// Device code shared by the banded join's kernels (K1 fused sort + count,
// K2 tile sort, K4 general count, K5 narrow count) and K7a, the key-value
// block sort: the register-resident tile sort (K2's; K1 runs it on keys,
// K7a on 64-bit (key, row) composites), 16-byte tile copies, block
// reductions, the per-tile stats row, the band search of the counts (K1,
// K4 and K5) and the narrow-band count with its exactness certificate (K1
// and K5).  One definition each, so the kernels cannot drift apart on them
// (the JAX package's make_tile_stats_row and make_contributions play the
// same role for its Pallas kernels).
//
// Everything sits in an unnamed namespace: each kernel source is its own
// translation unit and gets its own copy.  Block-wide helpers synchronise
// and must be called by every thread of the block.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kOvRows = 8;
constexpr int kOv = kLanes * kOvRows;
constexpr int kMaxI32 = 0x7fffffff;
constexpr int kMinI32 = -kMaxI32 - 1;
constexpr int kPackLimit = 1 << 29;
constexpr int kMaxThreads = 1024;  // the largest block of any kernel here
constexpr int kMaxWarps = kMaxThreads / 32;

enum Method { kBitonic = 0, kBlocks = 1, kOddEven = 2, kBitonicAlt = 3 };

__device__ __forceinline__ int warp_min(int x) {
    for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ int warp_max(int x) {
    for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// Block-wide reductions (blockDim.x a multiple of 32, at most kMaxThreads).
// The result is valid in thread 0.
__device__ int block_min(int x) {
    __shared__ int part[kMaxWarps];
    x = warp_min(x);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
    __syncthreads();
    if (threadIdx.x < 32) {
        x = warp_min(threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : kMaxI32);
    }
    __syncthreads();
    return x;
}

__device__ int block_max(int x) {
    __shared__ int part[kMaxWarps];
    x = warp_max(x);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
    __syncthreads();
    if (threadIdx.x < 32) {
        x = warp_max(threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : kMinI32);
    }
    __syncthreads();
    return x;
}

__device__ long long block_sum(long long x) {
    __shared__ long long part[kMaxWarps];
    x = warp_sum(x);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
    __syncthreads();
    if (threadIdx.x < 32) {
        x = warp_sum(threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : 0LL);
    }
    __syncthreads();
    return x;
}

// ---------------------------------------------------------------------------
// The register-resident tile sort (K1, K2 and K7a).
//
// A block of P threads holds a tile of E * P keys in registers, E keys a
// thread in the blocked layout: key i of the tile is x[i % E] of thread
// i / E.  Index bits below log2(E) are a thread's registers, the next five
// its lane, the rest its warp.  A compare-exchange stage pairs key i with
// key i ^ M, the lower index (bit HB clear) keeping the smaller key; where
// HB falls decides where the stage runs: in registers, across lanes with
// __shfl_xor_sync, or, for warp bits only, through shared memory (each
// thread stores its keys, one barrier, each reads its partners).  Shared
// rows are padded by one element in 128 bytes (one word in 32 for int
// keys, one in 16 for K7a's 64-bit composites, whose accesses a half-warp
// at a time make one 128-byte wavefront), so the blocked stores and the
// partners' loads of a warp hit every bank once.  Every stage index is a
// template argument, so every register index is known at compile time and
// no key leaves the registers for local memory (stage_at picks the stage
// body at run time).  The exact sorters stop the network at the warp's 32E
// keys and merge the warps' runs along the merge path (merge_levels).  The
// element type T is int for K1 and K2 and long long for K7a; stage_at,
// bitonic_levels, rotate_keys and odd_even_regs serve K2's inexact
// sorters and take int only.

__host__ __device__ constexpr int ilog2(int x) {
    return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// Where element i of a tile of T elements sits in shared memory, one
// element of padding after every 128 bytes.
template <typename T = int>
__device__ __forceinline__ int padded(int i) {
    constexpr int kShift = ilog2(128 / static_cast<int>(sizeof(T)));
    return i + (i >> kShift);
}

template <int E, int P, typename T = int>
struct RegTile {
    static constexpr int kT = E * P;
    static constexpr int kLogE = ilog2(E);
    static constexpr int kLogT = ilog2(kT);
    static constexpr int kWarps = P / 32;
    static constexpr int kPadded = kT + kT / (128 / static_cast<int>(sizeof(T)));
    static constexpr int kBufBytes = kPadded * static_cast<int>(sizeof(T));
    // two buffers, used in turn, let a stage's stores follow the previous
    // stage's loads without a second barrier; one where two do not fit
    static constexpr bool kTwoBufs = 2 * kBufBytes <= 160 * 1024;
    static constexpr int kSmemBytes = (kTwoBufs ? 2 : 1) * kBufBytes;
    static_assert(E >= 4 && (E & (E - 1)) == 0, "E: a power of two >= 4");
    static_assert(P % 32 == 0 && P <= kMaxThreads, "P: whole warps");
};

// The shared buffer of the next exchange round (stores, barrier, loads).
template <int E, int P, typename T = int>
struct ShuffleBuf {
    T* base;
    int round;
    __device__ __forceinline__ T* next() {
        T* buf = base;
        if (RegTile<E, P, T>::kTwoBufs) {
            buf += (round & 1) * RegTile<E, P, T>::kPadded;
        } else if (round) {
            __syncthreads();   // the previous round's loads are done
        }
        ++round;
        return buf;
    }
};

// min(x, y) if keep_min, else max(x, y), as one compare and one select
// (a direction known only at run time would otherwise cost a min, a max
// and a select).
template <typename T>
__device__ __forceinline__ T keep_or_take(T x, T y, bool keep_min) {
    return (y < x) == keep_min ? y : x;
}

// One stage over the blocked tile x: key i meets key i ^ M, and the one
// whose bit HB is clear keeps the smaller key.  Keys at indices >= limit
// take no part (limit is a multiple of 2 * HB, so no pair is split).
template <int E, int P, int M, int HB, typename T>
__device__ __forceinline__ void reg_stage(T (&x)[E], ShuffleBuf<E, P, T>& sh,
                                          int limit) {
    constexpr int kLogE = RegTile<E, P, T>::kLogE;
    const int first = threadIdx.x * E;   // the index of x[0]
    if constexpr (HB < E) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
            if ((j & HB) == 0 && first + j < limit) {
                const T a = x[j];
                const T b = x[j ^ M];
                x[j] = min(a, b);
                x[j ^ M] = max(a, b);
            }
        }
    } else if constexpr (HB < 32 * E) {
        constexpr int kLaneMask = M >> kLogE;
        constexpr int kRegMask = M & (E - 1);
        const bool keep_min = (threadIdx.x & (HB >> kLogE)) == 0;
        const bool live = first < limit;   // a thread's keys are all in or out
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int pj = j ^ kRegMask;
            if (pj < j) continue;
            // ya: the partner of key j; yb: the partner of key pj
            const T ya = __shfl_xor_sync(0xffffffffu, x[pj], kLaneMask);
            const T yb = pj == j ? ya
                                 : __shfl_xor_sync(0xffffffffu, x[j], kLaneMask);
            if (live) {
                x[j] = keep_or_take(x[j], ya, keep_min);
                if (pj != j) x[pj] = keep_or_take(x[pj], yb, keep_min);
            }
        }
    } else {
        T* buf = sh.next();
#pragma unroll
        for (int j = 0; j < E; ++j) buf[padded<T>(first + j)] = x[j];
        __syncthreads();
        const bool keep_min = (first & HB) == 0;
        if (first < limit) {
#pragma unroll
            for (int j = 0; j < E; ++j) {
                x[j] = keep_or_take(x[j], buf[padded<T>((first + j) ^ M)],
                                    keep_min);
            }
        }
    }
}

template <int E, int P, int D, typename T>
__device__ __forceinline__ void half_cleaners(T (&x)[E],
                                              ShuffleBuf<E, P, T>& sh) {
    if constexpr (D >= 1) {
        reg_stage<E, P, D, D>(x, sh, RegTile<E, P, T>::kT);
        half_cleaners<E, P, D / 2>(x, sh);
    }
}

// The stage on bit `bit`: the mirror stage of level bit + 1 (key i meets
// key i ^ (2^(bit+1) - 1)) or the half-cleaner (key i meets key i ^ 2^bit).
// The bit is known only at run time; each of the 2 log2(T) stage bodies is
// compiled once, with its register indices fixed, and the level loops of
// "blocks" (whose levels depend on the window) stay loops.
template <int E, int P, int B = 0>
__device__ __forceinline__ void stage_at(int (&x)[E], ShuffleBuf<E, P>& sh,
                                         int limit, int bit, bool mirror) {
    if constexpr (B < RegTile<E, P>::kLogT) {
        if (bit == B) {
            if (mirror) {
                reg_stage<E, P, (2 << B) - 1, 1 << B>(x, sh, limit);
            } else {
                reg_stage<E, P, 1 << B, 1 << B>(x, sh, limit);
            }
        } else {
            stage_at<E, P, B + 1>(x, sh, limit, bit, mirror);
        }
    }
}

// Levels first..last (level L: k = 2^L) of the flip-form bitonic network
// over the keys below limit: the mirror stage, then the half-cleaners k/4,
// ..., 1; every exchange is ascending.  Levels 1..L sort every aligned
// 2^L-key block; level L alone merges 2^L-key blocks whose halves are
// sorted.
template <int E, int P>
__device__ void bitonic_levels(int (&x)[E], ShuffleBuf<E, P>& sh, int first,
                               int last, int limit) {
#pragma unroll 1
    for (int level = first; level <= last; ++level) {
        stage_at<E, P>(x, sh, limit, level - 1, true);
#pragma unroll 1
        for (int bit = level - 2; bit >= 0; --bit) {
            stage_at<E, P>(x, sh, limit, bit, false);
        }
    }
}

// Levels first..last unrolled (each stage body inlined where it runs): for
// the levels whose stages all stay inside a warp, no block barrier.
template <int E, int P, int L, int kLast, typename T>
__device__ __forceinline__ void bitonic_levels_unrolled(T (&x)[E],
                                                        ShuffleBuf<E, P, T>& sh) {
    if constexpr (L <= kLast) {
        reg_stage<E, P, (1 << L) - 1, 1 << (L - 1)>(x, sh,
                                                     RegTile<E, P, T>::kT);
        half_cleaners<E, P, (1 << L) / 4>(x, sh);
        bitonic_levels_unrolled<E, P, L + 1, kLast>(x, sh);
    }
}

// Levels first..last by merging: every aligned 2^level-key block from its
// two sorted halves, along the merge path.  The tile goes to shared memory
// once a level (one barrier); thread t finds by binary search how many of
// the merged block's first d = t*E mod 2^level keys come from the lower
// half, then merges its E keys in registers, one shared load each, so the
// tile stays blocked.  About three shared accesses a key a level, where a
// bitonic level above the warp costs five shuffles and up to four shared
// rounds a key.
template <int E, int P, typename T>
__device__ void merge_levels(T (&x)[E], ShuffleBuf<E, P, T>& sh, int first,
                             int last) {
    const int o = threadIdx.x * E;
#pragma unroll 1
    for (int level = first; level <= last; ++level) {
        T* buf = sh.next();
#pragma unroll
        for (int j = 0; j < E; ++j) buf[padded<T>(o + j)] = x[j];
        __syncthreads();
        const int m = 1 << (level - 1);
        const int a0 = o & ~(2 * m - 1);   // the lower half; b0 the upper
        const int b0 = a0 + m;
        const int d = o - a0;
        int lo = max(0, d - m), hi = min(d, m);
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (buf[padded<T>(a0 + mid)] <= buf[padded<T>(b0 + d - 1 - mid)]) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        int i = lo, j = d - lo;
        T a = i < m ? buf[padded<T>(a0 + i)] : T(0);
        T b = j < m ? buf[padded<T>(b0 + j)] : T(0);
#pragma unroll
        for (int k = 0; k < E; ++k) {
            const bool take_a = j >= m || (i < m && a <= b);
            x[k] = take_a ? a : b;
            i += take_a;
            j += !take_a;
            const bool more = take_a ? i < m : j < m;
            const T next = more ? buf[padded<T>(take_a ? a0 + i : b0 + j)]
                                : T(0);
            a = take_a ? next : a;
            b = take_a ? b : next;
        }
    }
}

// x[i] <- x[(i + shift) mod T], through shared memory.
template <int E, int P>
__device__ void rotate_keys(int (&x)[E], ShuffleBuf<E, P>& sh, int shift) {
    constexpr int kT = RegTile<E, P>::kT;
    const int first = threadIdx.x * E;
    int* buf = sh.next();
#pragma unroll
    for (int j = 0; j < E; ++j) buf[padded(first + j)] = x[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = buf[padded((first + j + shift) & (kT - 1))];
}

// `passes` rounds of odd-even transposition (the even phase exchanges
// keys 2p and 2p + 1, the odd phase 2p + 1 and 2p + 2), step for step as
// the plain sorter: the even phase and the odd phase's pairs inside a
// thread run in registers; the odd pair across two threads takes one
// shuffle, and across two warps a word of shared memory (one barrier a
// round, the words used in turn).
template <int E, int P>
__device__ void odd_even_regs(int (&x)[E], int passes) {
    __shared__ int edge[2][2][kMaxWarps];   // [round parity][first, last][warp]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int r = 0; r < passes; ++r) {
#pragma unroll
        for (int j = 0; j < E; j += 2) {
            const int a = x[j], b = x[j + 1];
            x[j] = min(a, b);
            x[j + 1] = max(a, b);
        }
#pragma unroll
        for (int j = 1; j + 1 < E; j += 2) {
            const int a = x[j], b = x[j + 1];
            x[j] = min(a, b);
            x[j + 1] = max(a, b);
        }
        int next = __shfl_down_sync(0xffffffffu, x[0], 1);
        int prev = __shfl_up_sync(0xffffffffu, x[E - 1], 1);
        int (*e)[kMaxWarps] = edge[r & 1];
        if (lane == 0) e[0][warp] = x[0];
        if (lane == 31) e[1][warp] = x[E - 1];
        __syncthreads();
        if (lane == 31 && warp + 1 < RegTile<E, P>::kWarps) next = e[0][warp + 1];
        if (lane == 0 && warp > 0) prev = e[1][warp - 1];
        if (threadIdx.x + 1 < P) x[E - 1] = min(x[E - 1], next);
        if (threadIdx.x > 0) x[0] = max(x[0], prev);
    }
}

// One tile's sort by method on the blocked tile x ("bitonic" and
// "bitonic_alt": a full ascending sort; "blocks": aligned b-block sorts,
// then half-shifted b-block merges over [b/2, T - b/2), b =
// min(next_pow2(2*passes), T); "oddeven": `passes` rounds of even and odd
// transposition phases).  buf: RegTile<E, P>::kSmemBytes of shared memory.
// "bitonic" sorts each warp's 32E keys by the network, then merges them up
// to the tile; "blocks" sorts the aligned b-blocks, then (b < T) turns
// the tile by b/2 so the half-shifted blocks are aligned, merges all but
// the last (the two end half-blocks) and turns it back.  Results are those
// of the plain sorters (ops/sorters.py) bit for bit: each block is sorted
// exactly, and the odd-even rounds are the same steps.
template <int E, int P>
__device__ void sort_tile_regs(int (&x)[E], int* buf, int method, int passes) {
    constexpr int kT = RegTile<E, P>::kT;
    constexpr int kLogT = RegTile<E, P>::kLogT;
    ShuffleBuf<E, P> sh{buf, 0};
    if (method == kOddEven) {
        odd_even_regs<E, P>(x, passes);
    } else if (method == kBlocks) {
        int lb = 1;
        while ((1 << lb) < 2 * passes && lb < kLogT) ++lb;
        bitonic_levels<E, P>(x, sh, 1, lb, kT);
        if (lb < kLogT) {
            const int b = 1 << lb;
            rotate_keys<E, P>(x, sh, b / 2);
            bitonic_levels<E, P>(x, sh, lb, lb, kT - b);
            rotate_keys<E, P>(x, sh, kT - b / 2);
        }
    } else {   // within warps by the network, then by merging
        constexpr int kWarpLevels = ilog2(32 * E);
        bitonic_levels_unrolled<E, P, 1, kWarpLevels>(x, sh);
        merge_levels<E, P>(x, sh, kWarpLevels + 1, kLogT);
    }
}

// The stats row [min, max without MAXI32 padding, adjacent inversions] of
// the blocked tile x, from registers (inversions are counted only for the
// inexact sorters; the exact ones report 0, as the JAX kernel's stats row
// does); an adjacent pair across threads costs one shuffle, across warps a
// word of shared memory.  Written to row[0..2] by thread 0.
template <int E, int P>
__device__ void tile_stats_row_regs(const int (&x)[E], bool count_inversions,
                                    int* row) {
    __shared__ int edge[kMaxWarps];
    __shared__ int part[3][kMaxWarps];
    constexpr int kWarps = RegTile<E, P>::kWarps;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int mn = kMaxI32, mx = kMinI32, inv = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
        mn = min(mn, x[j]);
        if (x[j] != kMaxI32) mx = max(mx, x[j]);
    }
    if (count_inversions) {
#pragma unroll
        for (int j = 0; j + 1 < E; ++j) inv += x[j] > x[j + 1];
        int next = __shfl_down_sync(0xffffffffu, x[0], 1);
        if (lane == 0) edge[warp] = x[0];
        __syncthreads();
        if (lane == 31 && warp + 1 < kWarps) next = edge[warp + 1];
        if (threadIdx.x + 1 < P && x[E - 1] > next) ++inv;
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    inv = warp_sum(inv);
    if (lane == 0) {
        part[0][warp] = mn;
        part[1][warp] = mx;
        part[2][warp] = inv;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kWarps; ++w) {
            mn = min(mn, part[0][w]);
            mx = max(mx, part[1][w]);
            inv += part[2][w];
        }
        row[0] = mn;
        row[1] = mx;
        row[2] = inv;
    }
}

// x = the E keys src[threadIdx.x * E, +E) (16-byte aligned), and back.
template <int E>
__device__ __forceinline__ void load_blocked(int (&x)[E],
                                             const int* __restrict__ src) {
    const int4* s4 = reinterpret_cast<const int4*>(src) + threadIdx.x * (E / 4);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
        const int4 v = s4[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
    }
}

template <int E>
__device__ __forceinline__ void store_blocked(int* __restrict__ dst,
                                              const int (&x)[E]) {
    int4* d4 = reinterpret_cast<int4*>(dst) + threadIdx.x * (E / 4);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
        d4[q] = make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
}

// ---------------------------------------------------------------------------
// The band search of the counts (K1, K4, K5).
//
// A count holds its sorted tile in registers, E consecutive keys a thread,
// so a thread's keys ascend: its first key takes one binary search over
// the band (or chunk) in shared memory, and each next key gallops from
// where the last one ended (a few steps where the tile and the band
// interleave, as in a merge); a repeated key reuses the last count, and a
// key outside the band's [first, last] is not searched.  The first ports
// ran two full binary searches a key over lane-consecutive keys: 2 log2(T)
// dependent shared reads a key, every lane of a warp on the same path.

// A band sits in shared memory with 4 words of padding after every 32
// (16-byte copies stay aligned): a warp's searches for keys 16 apart in the
// tile land 16-32 words apart in a dense band, which would hit 1-2 of the
// 32 banks; padded, they spread over 8-16.  (One word in 32, copied 4 bytes
// at a time, spreads them over all 32 and measured slower in K4.)
__device__ __forceinline__ int at(const int* band, int p) {
    return band[p + 4 * (p >> 5)];
}

// The padded size of n keys (n a multiple of 32).
__host__ __device__ constexpr int padded_chunk(int n) {
    return n + n / 8;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Starts copying src[0, n) (16-byte aligned, n a multiple of 32) into the
// padded dst with cp.async, 16 bytes a copy, the block's threads in turn;
// commits nothing.
__device__ __forceinline__ void cp_async_padded(int* dst, const int* src,
                                                int n) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
        cp_async16(dst + 4 * i + 4 * (i >> 3), src + 4 * i);
    }
}

__device__ __forceinline__ bool before(int x, int key, bool strict) {
    return x < key || (strict && x == key);
}

// First index in the padded band a[from, n) whose key is >= key (> key
// when strict), where every key before from is below it: exponential
// steps, then a binary search over the last step.  from <= n, and the
// result lies in [from, n] whatever the keys.
__device__ __forceinline__ int gallop(const int* a, int from, int n, int key,
                                      bool strict) {
    int lo = from, hi = n;
    for (int step = 1;; step <<= 1) {
        const int idx = lo + step - 1;
        if (idx >= n) break;
        if (before(at(a, idx), key, strict)) {
            lo = idx + 1;
        } else {
            hi = idx;
            break;
        }
    }
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(at(a, mid), key, strict)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// First index in the padded band a[0, n) whose key is >= key.
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (at(a, mid) < key) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// Pairs of the thread's keys x (ascending where the tile is sorted) with
// the sorted, padded band[0, n) whose keys span [lo, hi].  On keys that do
// not ascend the count is undefined, but every search stays in [0, n] and
// ends: each starts where the last ended, at most n.
template <int E>
__device__ __forceinline__ long long count_chunk(const int (&x)[E],
                                                 const int* band, int n,
                                                 int lo, int hi) {
    long long cnt = 0;
    int pos = -1;    // where the last searched key's run ended
    int last = 0;    // that run's length
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int k = x[j];
        if (k < lo || k > hi || k >= kPackLimit) continue;
        if (j > 0 && k == x[j > 0 ? j - 1 : 0]) {   // x[j - 1] was counted
            cnt += last;
            continue;
        }
        const int l = pos < 0 ? lower_bound(band, n, k)
                              : gallop(band, pos, n, k, false);
        const int u = gallop(band, l, n, k, true);
        last = u - l;
        pos = u;
        cnt += last;
    }
    return cnt;
}

// ---------------------------------------------------------------------------
// The narrow-band count of K1 and K5.
//
// Tile t's band is S[row_off*128, +T + kOv): T keys, which hold every
// match of the tile when the band is narrow, then an overhang of kOv keys
// (OV_ROWS rows), against which the tile's last kOv keys are counted too.

// Starts copying tile t's band into the padded shared band
// (padded_chunk(tile + kOv) ints) with cp.async when it lies inside
// s[0, s_len), and commits the copy as one group; returns whether it lies
// inside (nothing is read if not).  Wait with cp_async_wait<0>() and a
// barrier before reading the band.
__device__ __forceinline__ bool load_band_async(int* band, const int* s,
                                                long long s_len, int row_off,
                                                int tile) {
    const long long start = static_cast<long long>(row_off) * kLanes;
    const bool in_range = row_off >= 0 && start + tile + kOv <= s_len;
    if (in_range) cp_async_padded(band, s + start, tile + kOv);
    cp_async_commit();
    return in_range;
}

// The sum of the thread's keys below MAXI32 (padding left out), in int64.
template <int E>
__device__ __forceinline__ long long key_sum(const int (&x)[E]) {
    long long sum = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) sum += x[j] != kMaxI32 ? x[j] : 0;
    return sum;
}

// The narrow-band count of one tile, from its blocked keys x (E a thread,
// P threads) and its band, landed in shared memory: the equal-key pairs
// (keys < PACK_LIMIT) of every tile key against band[0, T) and of the
// tile's last kOv keys against the overhang band[T, T + kOv), each
// thread's keys by count_chunk; then the certificate
//   ok = need <= T/128 || (mx_pre < ovh_min && need <= T/128 + OV_ROWS)
// (mx_pre: the max of tile row T/128 - OV_ROWS - 1, taken from the
// registers of the threads that hold it, so it is exact on an unsorted
// tile too; ovh_min = band[T], the overhang's first row being sorted).
// The count is the TPU merge's count wherever the tile is sorted.  Thread 0
// writes *count = ok ? pairs : 0, *flag = 0 (ok), 1 (recount exactly) or 2
// (band outside S: nothing was read), and the block's totals of the
// threads' sums a and b to *sum_a and, unless it is null, *sum_b.
template <int E, int P>
__device__ void narrow_count_regs(const int (&x)[E], const int* band,
                                  bool in_range, int need, long long a,
                                  long long b, long long* count, int* flag,
                                  long long* sum_a, long long* sum_b) {
    __shared__ long long part[3][kMaxWarps];
    __shared__ int part_mx[kMaxWarps];
    constexpr int kT = E * P;
    constexpr int kPreLo = kT - kOv - kLanes;   // the row before the overhang's
    static_assert(kPreLo % E == 0, "a thread's keys lie in the row or not");
    const int first = threadIdx.x * E;
    int mx_pre = kMinI32;
    if (first >= kPreLo && first < kPreLo + kLanes) {
#pragma unroll
        for (int j = 0; j < E; ++j) mx_pre = max(mx_pre, x[j]);
    }
    long long cnt = 0;
    if (in_range) {
        cnt = count_chunk(x, band, kT, at(band, 0), at(band, kT - 1));
        if (first >= kT - kOv) {
            const int* ovh = band + padded_chunk(kT);
            cnt += count_chunk(x, ovh, kOv, at(ovh, 0), at(ovh, kOv - 1));
        }
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    cnt = warp_sum(cnt);
    a = warp_sum(a);
    b = warp_sum(b);
    mx_pre = warp_max(mx_pre);
    if (lane == 0) {
        part[0][warp] = cnt;
        part[1][warp] = a;
        part[2][warp] = b;
        part_mx[warp] = mx_pre;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < P / 32; ++w) {
            cnt += part[0][w];
            a += part[1][w];
            b += part[2][w];
            mx_pre = max(mx_pre, part_mx[w]);
        }
        constexpr int kRows = kT / kLanes;
        const bool ok = in_range &&
            (need <= kRows || (mx_pre < at(band, kT) && need <= kRows + kOvRows));
        *count = ok ? cnt : 0;
        *flag = in_range ? (ok ? 0 : 1) : 2;
        *sum_a = a;
        if (sum_b) *sum_b = b;
    }
}

// Sets a kernel's dynamic shared memory, launches it and returns the CUDA
// error code (0 on success): a refused launch never runs, and only
// cudaGetLastError reports it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, int smem, void* stream,
           Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
