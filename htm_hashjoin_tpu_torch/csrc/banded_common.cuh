// Device code shared by the banded join's kernels (K1 fused sort + count,
// K2 tile sort, K3 global sort, K4 general count, K5 narrow count) and the
// key-value sort (K7a, K7b): the shared-memory sorting networks (keys only
// and key-value; K1 and K7a), K2's register-resident tile sort, 16-byte
// tile copies, the band binary
// searches, block reductions, the per-tile stats row and the narrow-band
// count with its exactness certificate.  One definition each, so the
// kernels cannot drift apart on them (the JAX package's make_tile_stats_row
// and make_contributions play the same role for its Pallas kernels).
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
constexpr int kThreads = 512;      // block size of the count kernels
constexpr int kMaxThreads = 1024;  // block size of the sorts on 16K+ tiles
constexpr int kMaxWarps = kMaxThreads / 32;

enum Method { kBitonic = 0, kBlocks = 1, kOddEven = 2, kBitonicAlt = 3 };

__device__ __forceinline__ void compare_exchange(int* s, int i, int j) {
    const int a = s[i];
    const int b = s[j];
    s[i] = min(a, b);
    s[j] = max(a, b);
}

// Stages d = h, h/2, ..., 1 of an ascending bitonic merge over s[0, n):
// every key i with bit d clear is exchanged with key i + d.
__device__ void merge_stages(int* s, int n, int h) {
    const int pairs = n >> 1;
    for (int d = h; d >= 1; d >>= 1) {
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
            compare_exchange(s, i, i + d);
        }
        __syncthreads();
    }
}

// Sorts s[0, n) ascending in aligned segments of `seg` keys (seg a power of
// two dividing n), running levels k0..seg of the bitonic network in its
// flip form: the first stage of level k pairs each key with its mirror in
// the k-block, so every exchange is ascending.  k0 = 2 sorts each segment;
// k0 = seg merges segments whose two halves are already sorted.
__device__ void sort_segments(int* s, int n, int seg, int k0) {
    const int pairs = n >> 1;
    for (int k = k0; k <= seg; k <<= 1) {
        const int h = k >> 1;
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int r = p & (h - 1);
            const int i = ((p & ~(h - 1)) << 1) | r;
            compare_exchange(s, i, (i | (k - 1)) - r);
        }
        __syncthreads();
        merge_stages(s, n, h >> 1);
    }
}

// The key-value forms of the networks above (K7): keys are compared, and a
// key's value moves with it.  Ties are left in place, so equal keys keep
// whatever value order the network gives them (a bitonic network is not
// stable, on the TPU either).
__device__ __forceinline__ void compare_exchange_kv(int* k, int* v, int i,
                                                    int j) {
    const int a = k[i];
    const int b = k[j];
    if (b < a) {
        k[i] = b;
        k[j] = a;
        const int t = v[i];
        v[i] = v[j];
        v[j] = t;
    }
}

__device__ void merge_stages_kv(int* k, int* v, int n, int h) {
    const int pairs = n >> 1;
    for (int d = h; d >= 1; d >>= 1) {
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
            compare_exchange_kv(k, v, i, i + d);
        }
        __syncthreads();
    }
}

// Sorts k[0, n) ascending, v riding (n a power of two), in the flip form
// of sort_segments.  Ends synchronised.
__device__ void sort_kv(int* k, int* v, int n) {
    const int pairs = n >> 1;
    for (int kk = 2; kk <= n; kk <<= 1) {
        const int h = kk >> 1;
        for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
            const int r = p & (h - 1);
            const int i = ((p & ~(h - 1)) << 1) | r;
            compare_exchange_kv(k, v, i, (i | (kk - 1)) - r);
        }
        __syncthreads();
        merge_stages_kv(k, v, n, h >> 1);
    }
}

__device__ void odd_even_passes(int* s, int n, int passes) {
    for (int round = 0; round < passes; ++round) {
        for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
            compare_exchange(s, 2 * p, 2 * p + 1);
        }
        __syncthreads();
        for (int p = threadIdx.x; p < n / 2 - 1; p += blockDim.x) {
            compare_exchange(s, 2 * p + 1, 2 * p + 2);
        }
        __syncthreads();
    }
}

// One tile's sort by method ("bitonic" and "bitonic_alt": full ascending
// sort; "blocks": aligned b-block sorts, then half-shifted b-block merges
// over [b/2, T - b/2), b = min(next_pow2(2*passes), T); "oddeven": `passes`
// rounds of even and odd transposition phases).  Ends synchronised.
__device__ void sort_tile(int* v, int tile, int method, int passes) {
    if (method == kBlocks) {
        int b = 1;
        while (b < 2 * passes) b <<= 1;
        b = min(b, tile);
        sort_segments(v, tile, b, 2);
        if (b < tile) sort_segments(v + b / 2, tile - b, b, b);
    } else if (method == kOddEven) {
        odd_even_passes(v, tile, passes);
    } else {
        sort_segments(v, tile, tile, 2);
    }
}

// dst[0, n) = src[0, n) with 16-byte accesses (both 16-byte aligned, n a
// multiple of 4).  No barrier.
__device__ __forceinline__ void copy_keys(int* __restrict__ dst,
                                          const int* __restrict__ src, int n) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
}

// v[i] = ~v[i]: an order-reversing bijection of int32, so an ascending
// network over ~v sorts (or merges) v descending.  Ends synchronised.
__device__ void complement_keys(int* v, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = ~v[i];
    __syncthreads();
}

// First index in a[lo, n) whose key is >= key (strict = false) or > key
// (strict = true).
__device__ __forceinline__ int bound(const int* a, int lo, int n, int key,
                                     bool strict) {
    int hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int x = a[mid];
        if (x < key || (strict && x == key)) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// Number of keys in the sorted run a[0, n) equal to key.
__device__ __forceinline__ int equal_count(const int* a, int n, int key) {
    const int lo = bound(a, 0, n, key, false);
    return bound(a, lo, n, key, true) - lo;
}

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

// The stats row [min, max without MAXI32 padding, adjacent inversions] of
// the tile v[0, tile), written to row[0..2] by thread 0.  Inversions are
// counted only for the inexact sorters; the exact ones report 0, as the
// JAX kernel's stats row does.
__device__ void tile_stats_row(const int* v, int tile, bool count_inversions,
                               int* row) {
    int mn = kMaxI32, mx = kMinI32, inv = 0;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int x = v[i];
        mn = min(mn, x);
        if (x != kMaxI32) mx = max(mx, x);
        if (count_inversions && i + 1 < tile && x > v[i + 1]) ++inv;
    }
    mn = block_min(mn);
    mx = block_max(mx);
    inv = static_cast<int>(block_sum(inv));
    if (threadIdx.x == 0) {
        row[0] = mn;
        row[1] = mx;
        row[2] = inv;
    }
}

// Loads tile t's narrow band S[row_off*128, +tile + kOv) into band when it
// lies inside s[0, s_len); returns whether it does (nothing is read if not).
// No barrier.
__device__ bool load_band(int* band, const int* s, long long s_len,
                          int row_off, int tile) {
    const long long start = static_cast<long long>(row_off) * kLanes;
    const bool in_range = row_off >= 0 && start + tile + kOv <= s_len;
    if (in_range) copy_keys(band, s + start, tile + kOv);
    return in_range;
}

// The narrow-band count of K1 and K5 for one sorted tile v[0, tile) and its
// band[0, tile + kOv): equal-key pairs (keys < PACK_LIMIT) of every tile key
// against band[:tile] and of the tile's last kOv keys against band[tile:],
// then the certificate
//   ok = need <= T/128 || (mx_pre < ovh_min && need <= T/128 + OV_ROWS)
// (mx_pre: max of tile row T/128 - OV_ROWS - 1; ovh_min: min of band row
// T/128).  Thread 0 writes *count = ok ? pairs : 0 and *flag = 0 (ok),
// 1 (recount exactly) or 2 (band outside S: nothing was read).  The count
// is a binary search per key instead of the TPU's bitonic merge of packed
// key*4+tag runs; it equals the merge's count whenever the tile is sorted.
__device__ void narrow_count(const int* v, const int* band, int tile,
                             bool in_range, int need, long long* count,
                             int* flag) {
    const int pre_lo = tile - kOv - kLanes;
    int mx_pre = kMinI32, ovh_min = kMaxI32;
    long long cnt = 0;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int x = v[i];
        if (i >= pre_lo && i < pre_lo + kLanes) mx_pre = max(mx_pre, x);
        if (in_range && x < kPackLimit) {
            cnt += equal_count(band, tile, x);
            if (i >= tile - kOv) cnt += equal_count(band + tile, kOv, x);
        }
    }
    if (in_range && threadIdx.x < kLanes) ovh_min = band[tile + threadIdx.x];
    mx_pre = block_max(mx_pre);
    ovh_min = block_min(ovh_min);
    cnt = block_sum(cnt);
    if (threadIdx.x == 0) {
        const int rpt = tile / kLanes;
        const bool ok = in_range &&
            (need <= rpt || (mx_pre < ovh_min && need <= rpt + kOvRows));
        *count = ok ? cnt : 0;
        *flag = in_range ? (ok ? 0 : 1) : 2;
    }
}

// ---------------------------------------------------------------------------
// The register-resident tile sort (K2).
//
// A block of P threads holds a T = E * P key tile in registers, E keys a
// thread in the blocked layout: key i of the tile is x[i % E] of thread
// i / E.  Index bits below log2(E) are a thread's registers, the next five
// its lane, the rest its warp.  A compare-exchange stage pairs key i with
// key i ^ M, the lower index (bit HB clear) keeping the smaller key; where
// HB falls decides where the stage runs: in registers, across lanes with
// __shfl_xor_sync, or, for warp bits only, through shared memory (each
// thread stores its keys, one barrier, each reads its partners).  Shared
// rows are padded by one word in 32, so the blocked stores and the
// partners' loads of a warp hit 32 banks.  Every stage index is a template
// argument, so every register index is known at compile time and no key
// leaves the registers for local memory (stage_at picks the stage body at
// run time).  The exact sorters stop the network at the warp's 32E keys and
// merge the warps' runs along the merge path (merge_levels).

__host__ __device__ constexpr int ilog2(int x) {
    return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <int E, int P>
struct RegTile {
    static constexpr int kT = E * P;
    static constexpr int kLogE = ilog2(E);
    static constexpr int kLogT = ilog2(kT);
    static constexpr int kWarps = P / 32;
    static constexpr int kPadded = kT + kT / 32;
    // two buffers, used in turn, let a stage's stores follow the previous
    // stage's loads without a second barrier; one where two do not fit
    static constexpr bool kTwoBufs = 2 * kPadded * 4 <= 160 * 1024;
    static constexpr int kSmemBytes = (kTwoBufs ? 2 : 1) * kPadded * 4;
    static_assert(E >= 4 && (E & (E - 1)) == 0, "E: a power of two >= 4");
    static_assert(P % 32 == 0 && P <= kMaxThreads, "P: whole warps");
};

// The shared buffer of the next exchange round (stores, barrier, loads).
template <int E, int P>
struct ShuffleBuf {
    int* base;
    int round;
    __device__ __forceinline__ int* next() {
        int* buf = base;
        if (RegTile<E, P>::kTwoBufs) {
            buf += (round & 1) * RegTile<E, P>::kPadded;
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
__device__ __forceinline__ int keep_or_take(int x, int y, bool keep_min) {
    return (y < x) == keep_min ? y : x;
}

// One stage over the blocked tile x: key i meets key i ^ M, and the one
// whose bit HB is clear keeps the smaller key.  Keys at indices >= limit
// take no part (limit is a multiple of 2 * HB, so no pair is split).
template <int E, int P, int M, int HB>
__device__ __forceinline__ void reg_stage(int (&x)[E], ShuffleBuf<E, P>& sh,
                                          int limit) {
    constexpr int kLogE = RegTile<E, P>::kLogE;
    const int first = threadIdx.x * E;   // the index of x[0]
    if constexpr (HB < E) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
            if ((j & HB) == 0 && first + j < limit) {
                const int a = x[j];
                const int b = x[j ^ M];
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
            const int ya = __shfl_xor_sync(0xffffffffu, x[pj], kLaneMask);
            const int yb = pj == j ? ya
                                   : __shfl_xor_sync(0xffffffffu, x[j], kLaneMask);
            if (live) {
                x[j] = keep_or_take(x[j], ya, keep_min);
                if (pj != j) x[pj] = keep_or_take(x[pj], yb, keep_min);
            }
        }
    } else {
        int* buf = sh.next();
#pragma unroll
        for (int j = 0; j < E; ++j) buf[padded(first + j)] = x[j];
        __syncthreads();
        const bool keep_min = (first & HB) == 0;
        if (first < limit) {
#pragma unroll
            for (int j = 0; j < E; ++j) {
                x[j] = keep_or_take(x[j], buf[padded((first + j) ^ M)],
                                    keep_min);
            }
        }
    }
}

template <int E, int P, int D>
__device__ __forceinline__ void half_cleaners(int (&x)[E], ShuffleBuf<E, P>& sh) {
    if constexpr (D >= 1) {
        reg_stage<E, P, D, D>(x, sh, RegTile<E, P>::kT);
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
template <int E, int P, int L, int kLast>
__device__ __forceinline__ void bitonic_levels_unrolled(int (&x)[E],
                                                        ShuffleBuf<E, P>& sh) {
    if constexpr (L <= kLast) {
        reg_stage<E, P, (1 << L) - 1, 1 << (L - 1)>(x, sh, RegTile<E, P>::kT);
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
template <int E, int P>
__device__ void merge_levels(int (&x)[E], ShuffleBuf<E, P>& sh, int first,
                             int last) {
    const int o = threadIdx.x * E;
#pragma unroll 1
    for (int level = first; level <= last; ++level) {
        int* buf = sh.next();
#pragma unroll
        for (int j = 0; j < E; ++j) buf[padded(o + j)] = x[j];
        __syncthreads();
        const int m = 1 << (level - 1);
        const int a0 = o & ~(2 * m - 1);   // the lower half; b0 the upper
        const int b0 = a0 + m;
        const int d = o - a0;
        int lo = max(0, d - m), hi = min(d, m);
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (buf[padded(a0 + mid)] <= buf[padded(b0 + d - 1 - mid)]) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        int i = lo, j = d - lo;
        int a = i < m ? buf[padded(a0 + i)] : 0;
        int b = j < m ? buf[padded(b0 + j)] : 0;
#pragma unroll
        for (int k = 0; k < E; ++k) {
            const bool take_a = j >= m || (i < m && a <= b);
            x[k] = take_a ? a : b;
            i += take_a;
            j += !take_a;
            const bool more = take_a ? i < m : j < m;
            const int next = more ? buf[padded(take_a ? a0 + i : b0 + j)] : 0;
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

// `passes` rounds of odd-even transposition, step for step as
// odd_even_passes: the even phase and the odd phase's pairs inside a
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

// One tile's sort by method, as sort_tile does it in shared memory, on the
// blocked tile x.  buf: RegTile<E, P>::kSmemBytes of shared memory.
// "bitonic" sorts each warp's 32E keys by the network, then merges them up
// to the tile; "blocks" sorts the aligned b-blocks, then (b < T) turns
// the tile by b/2 so the half-shifted blocks are aligned, merges all but
// the last (the two end half-blocks) and turns it back.  Results are those
// of sort_tile bit for bit: each block is sorted exactly, and the odd-even
// rounds are the same steps.
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

// The stats row (as tile_stats_row) of the blocked tile x, from registers;
// an adjacent pair across threads costs one shuffle, across warps a word
// of shared memory.  Written to row[0..2] by thread 0.
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
