// K3 and K7 for Hopper: one stable LSD radix sort of int32 keys, keys only
// (global_sort_tiles) or with one int32 value riding each key
// (global_sort_kv_tiles).
//
// Replaces the TPU kernels htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _gsort_pass_kernel (entry global_sort_tiles, pallas_call in
// _gsort_pass_jit), with the per-tile sort it starts from (K2's
// _sort_megakernel, "bitonic_alt"), and _gsort_kv_pass_kernel (entry
// global_sort_kv_tiles, pallas_call in _gsort_kv_pass_jit), with its phase
// A, _sort_kv_megakernel.  The TPU sorts with a bitonic network, which
// needs O(log^2 n) passes over device memory; this sort needs five,
// whatever n is.
//
// The algorithm (Merrill and Adinets' "onesweep"):
//   1. radix_histogram reads the keys once and counts all four 8-bit digits
//      of each key, as the order-preserving unsigned word x ^ 0x80000000
//      (INT32_MIN first, the MAXI32 padding last), into 4 x 256 bins:
//      shared-memory counts in 8 sub-histograms picked by lane, so that
//      lanes holding one digit (skewed or constant keys) hit different
//      words, then one atomic add per bin and block into device memory.
//   2. radix_scatter runs once per digit, least significant first, from
//      the input to the scratch buffer, back to the output, and so on: four
//      passes end in the output.  A block takes a tile of kTileKeys keys
//      (warp-striped, kItems a thread, in registers) whose index comes from
//      an atomic counter in launch order, so every tile it waits on belongs
//      to a block that is already running.  It ranks its keys by digit,
//      stably: item by item, each warp finds the lanes holding the same
//      digit with eight ballots and counts them in its own 256 bins in
//      shared memory; the warps' counts are then scanned in warp order.  It
//      publishes its 256 digit counts (flag "aggregate") in a status word
//      per (tile, digit), sums its predecessors' words back to the first
//      that carries an inclusive prefix (decoupled look-back), publishes its
//      own inclusive prefix, and adds the digit's bucket start (an
//      exclusive scan of the histogram).  It then stages keys (and values)
//      in shared memory in digit order and stores them, so that
//      neighbouring threads write neighbouring addresses of each digit's
//      run.  Values move with their keys through the same ranks, so the
//      key-value sort is stable too.
//
// What bounds it on an H100: device-memory traffic.  The histogram reads
// 4n bytes and each pass reads and writes every key (and value) once:
// 36n bytes keys only, 68n with values, about 4.8 GB at n = 2^27 keys and
// 18.3 GB at n = 2^28 pairs, 1.4 ms and 5.5 ms at 3.35 TB/s.  The design
// spends no pass beyond those five: no separate scan launch (each scatter
// block scans the 256 counts it needs), no per-pass histogram, and the
// staging in shared memory keeps the scattered stores in runs.  On an H100
// the scatter passes reach about a third of the memory rate: each tile's
// ranking (eight ballots and a dependent shared-memory round trip a key)
// and its look-back run between its loads and its stores, and forcing
// three or four blocks an SM (with spills) did not hide them.  Skipping a
// pass whose digit is constant and a wider digit are later work.
//
// Sizes: n < 2^32.  Keys, offsets and digit counts are 32-bit unsigned
// (a key's output index is computed modulo 2^32 and lands below n); a
// look-back status word is 64 bits, a 2-bit flag above a 62-bit count,
// published with st.release.gpu.u64 and read with ld.acquire.gpu.u64, so
// one word carries flag and count together and no count is cut.  The
// status takes 8 bytes per (pass, tile, digit): 1.4 GB at n = 2^30.  The
// last tile may be ragged: its missing keys read as 0xFFFFFFFF (digit 255,
// last in every pass) and are neither counted nor stored.

#include "banded_common.cuh"

namespace {

constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kPasses = 32 / kRadixBits;
constexpr int kSortThreads = kBins;  // thread d owns digit d in scans and look-back
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 24;  // keys a thread holds in registers
constexpr int kTileKeys = kSortThreads * kItems;
constexpr int kHistThreads = 256;
constexpr int kHistParts = 8;
constexpr unsigned kSignFlip = 0x80000000u;
// A look-back status word is 64 bits: a 2-bit flag above a 62-bit count.
using Status = unsigned long long;
constexpr Status kFlagAggregate = 1ull << 62;  // the tile's own counts
constexpr Status kFlagPrefix = 2ull << 62;     // counts of tiles 0..t
constexpr Status kFlagMask = kFlagAggregate | kFlagPrefix;
constexpr Status kCountMask = kFlagAggregate - 1;
constexpr long long kMaxKeys = 1LL << 32;      // keys and offsets are 32-bit
constexpr int kStatusWords = sizeof(Status) / sizeof(unsigned);

__device__ __forceinline__ unsigned digit(unsigned u, int shift) {
    return (u >> shift) & (kBins - 1);
}

__device__ __forceinline__ void store_release(Status* p, Status v) {
    asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ Status load_acquire(const Status* p) {
    Status v;
    asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// The lanes of the warp whose digit equals this lane's (all 32 lanes
// call it).
__device__ __forceinline__ unsigned warp_peers(unsigned d) {
    unsigned peers = 0xffffffffu;
#pragma unroll
    for (int b = 0; b < kRadixBits; ++b) {
        const bool bit = (d >> b) & 1u;
        const unsigned ones = __ballot_sync(0xffffffffu, bit);
        peers &= bit ? ones : ~ones;
    }
    return peers;
}

// Exclusive prefix sum of x over the kSortThreads threads of the block, one
// value each.  Every thread must call it; it synchronises.
__device__ unsigned block_exclusive_scan(unsigned x, unsigned* warp_sums) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    unsigned inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    unsigned before = 0;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    __syncthreads();
    return before + inc - x;
}

__device__ __forceinline__ void count_key(unsigned* bins, int key, int part) {
    const unsigned u = static_cast<unsigned>(key) ^ kSignFlip;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
        atomicAdd(&bins[(p * kBins + digit(u, p * kRadixBits)) * kHistParts +
                        part], 1u);
    }
}

// hist[p * 256 + d] += the number of keys whose digit p is d (hist zeroed
// by the caller).  keys is 16-byte aligned.
__global__ void __launch_bounds__(kHistThreads)
radix_histogram(const int* __restrict__ keys, unsigned n,
                unsigned* __restrict__ hist) {
    __shared__ unsigned bins[kPasses * kBins * kHistParts];
    for (int i = threadIdx.x; i < kPasses * kBins * kHistParts;
         i += kHistThreads) {
        bins[i] = 0;
    }
    __syncthreads();
    const int part = threadIdx.x & (kHistParts - 1);
    const unsigned quads = n / 4;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    for (unsigned q = blockIdx.x * kHistThreads + threadIdx.x; q < quads;
         q += gridDim.x * kHistThreads) {
        const int4 v = k4[q];
        count_key(bins, v.x, part);
        count_key(bins, v.y, part);
        count_key(bins, v.z, part);
        count_key(bins, v.w, part);
    }
    if (blockIdx.x == 0 && threadIdx.x < n % 4) {
        count_key(bins, keys[quads * 4 + threadIdx.x], part);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kPasses * kBins; i += kHistThreads) {
        unsigned sum = 0;
#pragma unroll
        for (int p = 0; p < kHistParts; ++p) sum += bins[i * kHistParts + p];
        if (sum) atomicAdd(hist + i, sum);
    }
}

template <bool kPairs>
struct ScatterSmem {
    unsigned warp_count[kSortWarps][kBins];  // counts, then warp offsets
    unsigned digit_start[kBins];             // the digit's run in the tile
    unsigned delta[kBins];  // output index = delta[d] + staged position (mod 2^32)
    unsigned warp_sums[kSortWarps];
    unsigned tile;
    int keys[kTileKeys];
    int vals[kPairs ? kTileKeys : 1];
};

// One pass: keys_out (and vals_out) receive the keys of keys_in (and their
// values) ordered stably by digit `shift`.  hist holds the pass's 256 digit
// counts over all n keys; status (tiles x 256 words) and *tile_counter are
// zero on entry.
template <bool kPairs>
__global__ void __launch_bounds__(kSortThreads)
radix_scatter(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
              int* __restrict__ keys_out, int* __restrict__ vals_out,
              unsigned n, int shift, const unsigned* __restrict__ hist,
              Status* __restrict__ status, unsigned* __restrict__ tile_counter) {
    extern __shared__ int4 smem4[];
    ScatterSmem<kPairs>& s = *reinterpret_cast<ScatterSmem<kPairs>*>(smem4);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    if (tid == 0) s.tile = atomicAdd(tile_counter, 1u);
    for (int i = tid; i < kSortWarps * kBins; i += kSortThreads) {
        (&s.warp_count[0][0])[i] = 0;
    }
    __syncthreads();
    const unsigned tile = s.tile;
    const unsigned base = tile * kTileKeys;
    const unsigned valid = min(n - base, static_cast<unsigned>(kTileKeys));

    // Warp-striped: item j of lane l of warp w is key w*32*kItems + 32j + l.
    unsigned u[kItems];
    int v[kItems];
    const unsigned first = warp * 32 * kItems + lane;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const unsigned i = first + 32 * j;
        u[j] = i < valid ? static_cast<unsigned>(keys_in[base + i]) ^ kSignFlip
                         : 0xffffffffu;
        if (kPairs) v[j] = i < valid ? vals_in[base + i] : 0;
    }

    // Stable rank within the warp: earlier items, then lower lanes.
    unsigned rank[kItems];
    unsigned* my_count = s.warp_count[warp];
    const unsigned lower_lanes = (1u << lane) - 1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const unsigned d = digit(u[j], shift);
        const unsigned peers = warp_peers(d);
        const int leader = 31 - __clz(peers);
        unsigned before = 0;
        if (lane == leader) {
            before = my_count[d];
            my_count[d] = before + __popc(peers);
        }
        rank[j] = __shfl_sync(0xffffffffu, before, leader) +
                  __popc(peers & lower_lanes);
        __syncwarp();
    }
    __syncthreads();

    // Thread d: each warp's offset within the tile's run of digit d, and the
    // tile's count of d (the ragged tail's keys, all digit 255, left out).
    const int d = tid;
    unsigned count = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
        const unsigned c = s.warp_count[w][d];
        s.warp_count[w][d] = count;
        count += c;
    }
    if (d == kBins - 1) count -= kTileKeys - valid;
    Status* my_status = status + static_cast<size_t>(tile) * kBins + d;
    store_release(my_status, (tile == 0 ? kFlagPrefix : kFlagAggregate) | count);

    s.digit_start[d] = block_exclusive_scan(count, s.warp_sums);
    const unsigned bucket = block_exclusive_scan(hist[d], s.warp_sums);

    // Decoupled look-back: the count of digit d over tiles 0..tile-1.
    Status before = 0;
    if (tile > 0) {
        for (unsigned t = tile - 1;; --t) {
            Status w;
            do {
                w = load_acquire(status + static_cast<size_t>(t) * kBins + d);
            } while (!(w & kFlagMask));
            before += w & kCountMask;
            if (w & kFlagPrefix) break;
        }
        store_release(my_status, kFlagPrefix | (before + count));
    }
    s.delta[d] = bucket + static_cast<unsigned>(before) - s.digit_start[d];

    // Stage in digit order, then store runs of neighbouring addresses.
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const unsigned dj = digit(u[j], shift);
        const unsigned pos = s.digit_start[dj] + s.warp_count[warp][dj] + rank[j];
        s.keys[pos] = static_cast<int>(u[j] ^ kSignFlip);
        if (kPairs) s.vals[pos] = v[j];
    }
    __syncthreads();
    for (unsigned i = tid; i < valid; i += kSortThreads) {
        const int key = s.keys[i];
        const unsigned dk = digit(static_cast<unsigned>(key) ^ kSignFlip, shift);
        const unsigned o = s.delta[dk] + i;
        keys_out[o] = key;
        if (kPairs) vals_out[o] = s.vals[i];
    }
}

// The histogram and tile counters (an even number of 32-bit words, so the
// 64-bit status words that follow are 8-byte aligned), then the status.
constexpr int kHeadWords = kPasses * kBins + kPasses;
static_assert(kHeadWords % kStatusWords == 0, "status words must be aligned");

long long scratch_words_for(long long n) {
    const long long tiles = (n + kTileKeys - 1) / kTileKeys;
    return kHeadWords + kStatusWords * kPasses * tiles * kBins;
}

template <bool kPairs>
int radix_sort(const int* keys, const int* vals, int* keys_out, int* vals_out,
               int* keys_tmp, int* vals_tmp, unsigned* scratch,
               long long scratch_words, long long n, void* stream) {
    if (n <= 0) return 0;
    if (n >= kMaxKeys || scratch_words < scratch_words_for(n)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned nn = static_cast<unsigned>(n);
    const int tiles = static_cast<int>((n + kTileKeys - 1) / kTileKeys);
    unsigned* hist = scratch;
    unsigned* counters = hist + kPasses * kBins;
    Status* status = reinterpret_cast<Status*>(scratch + kHeadWords);
    cudaError_t err = cudaMemsetAsync(
        scratch, 0, scratch_words_for(n) * sizeof(unsigned), st);
    if (err != cudaSuccess) return static_cast<int>(err);

    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long quad_blocks = (n / 4 + kHistThreads - 1) / kHistThreads;
    const int hist_blocks = static_cast<int>(
        quad_blocks < 2LL * sms ? (quad_blocks > 0 ? quad_blocks : 1) : 2LL * sms);
    radix_histogram<<<hist_blocks, kHistThreads, 0, st>>>(keys, nn, hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const int* src_k = keys;
    const int* src_v = vals;
    for (int p = 0; p < kPasses; ++p) {
        int* dst_k = (p & 1) ? keys_out : keys_tmp;  // the last pass lands in the output
        int* dst_v = (p & 1) ? vals_out : vals_tmp;
        const int code = launch(radix_scatter<kPairs>, tiles, kSortThreads,
                                static_cast<int>(sizeof(ScatterSmem<kPairs>)),
                                stream, src_k, src_v, dst_k, dst_v, nn,
                                p * kRadixBits, hist + p * kBins,
                                status + static_cast<size_t>(p) * tiles * kBins,
                                counters + p);
        if (code != 0) return code;
        src_k = dst_k;
        src_v = dst_v;
    }
    return 0;
}

}  // namespace

// Sorts n int32 keys (16-byte aligned device memory) ascending into out,
// stably, on `stream`, with tmp (n ints) as the ping-pong buffer and
// scratch (scratch_words unsigned words: the histogram, tile counters and
// look-back status) as working memory.  keys is not written; out and tmp
// may not overlap it or each other.  0 < n < 2^32.  Returns the first CUDA
// error code (0 on success); cudaErrorInvalidValue when n is out of range
// or the scratch too small.
extern "C" int htm_radix_sort_keys(const int* keys, int* out, int* tmp,
                                   unsigned* scratch, long long scratch_words,
                                   long long n, void* stream) {
    return radix_sort<false>(keys, nullptr, out, nullptr, tmp, nullptr, scratch,
                             scratch_words, n, stream);
}

// As htm_radix_sort_keys, with vals (n ints) moving with their keys into
// vals_out through vals_tmp.
extern "C" int htm_radix_sort_pairs(const int* keys, const int* vals,
                                    int* keys_out, int* vals_out, int* keys_tmp,
                                    int* vals_tmp, unsigned* scratch,
                                    long long scratch_words, long long n,
                                    void* stream) {
    return radix_sort<true>(keys, vals, keys_out, vals_out, keys_tmp, vals_tmp,
                            scratch, scratch_words, n, stream);
}

// The scratch words htm_radix_sort_keys / _pairs need for n keys.
extern "C" long long htm_radix_sort_scratch_words(long long n) {
    return scratch_words_for(n);
}
