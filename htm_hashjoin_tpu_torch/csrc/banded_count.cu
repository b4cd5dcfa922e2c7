// K4 for Hopper: the general banded match count.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _count_megakernel (entry banded_count, pallas_call in _banded_count_jit).
// For each sorted T-key tile t of the build side it counts the equal-key
// pairs (keys < PACK_LIMIT) between the tile and n_chunks[t] T-key chunks of
// the sorted probe side, chunk c at S[row_off[t]*128 + c*T, +T).  Counts are
// int64, so the TPU kernel's int32 per-position accumulator and its
// overflow certificate are not needed.  n_chunks = 0 skips the tile; a tile
// whose chunks would end past s_len reads nothing, counts 0 and gets status
// 2 (the caller raises).
//
// What bounds it on an H100: device memory, each tile and chunk read once
// (0.32 ms for a 2^27 build on its 2^27 probe), and, in the first port of
// this kernel, one block per tile: the skewed probe's repair hands it a few
// tiles whose bands hold most of S (a hot key with 10^7 probe copies is
// about 1200 chunks at T = 8192), so 2^27 probe keys streamed through 4 of
// the 132 SMs, 36 ms at about 14 GB/s.  The design:
//   * work comes in items of kItemChunks chunks of one tile.  Block t takes
//     tile t's first item, as the first port did with the whole band (a
//     tile of no chunks retires at once: most of the multipass join's probe
//     tiles have none, and blocks that walked every tile's item in turn
//     were much slower there); the items past a tile's first
//     are listed by an inclusive prefix sum of their per-tile counts
//     (ops/banded_count.item_plan), and as many more blocks as fit on the
//     card at once stride over them, each finding its tile by a binary
//     search of that sum.  So a band of thousands of chunks spreads over
//     every SM, and the grid size needs no host readback.  A block adds its
//     item's count into counts[t] with one 64-bit atomicAdd;
//   * a chunk whose first and last keys are equal (a hot key's run) is
//     counted from those two keys, without being loaded, as the tile's
//     multiplicity of the key times T;
//   * an item reads its chunks' first and last keys in one step; the
//     other chunks stream through two shared buffers with cp.async, the
//     next chunk's load in flight while the current one is counted;
//   * the tile sits in registers, 16 consecutive keys a thread (loaded once
//     per item; where the tile's keys below PACK_LIMIT, a prefix of the
//     sorted tile, fill half the threads or fewer, they are spread over
//     all of them first: the multipass probe's tiles are mostly padding,
//     and two warps doing all the searches were much slower), so a
//     thread's keys ascend: its first key takes one binary
//     search over the chunk, and each next key gallops from where the last
//     one ended (a few steps where the tile and chunk interleave, as in a
//     merge); a repeated key reuses the last count, and a key outside the
//     chunk's [first, last] is not searched (count_chunk in
//     banded_common.cuh, which K1 and K5 share).  On the wide band the
//     searches, not the bytes, bound the kernel; searching 2-8 keys in
//     lockstep by halving steps, two binary searches a key on
//     lane-consecutive keys (the first port's way), walking word by word
//     before galloping, or two blocks an SM in place of three all measured
//     slower.

#include "banded_common.cuh"

namespace {

constexpr int kItemChunks = 8;   // chunks an item (ops/banded_count.ITEM_CHUNKS)
constexpr int kKeysPerThread = 16;

// The tile of extra item e: the first t with extra_end[t] > e.
__device__ __forceinline__ int extra_tile(const long long* extra_end,
                                          int n_tiles, long long e) {
    int lo = 0, hi = n_tiles - 1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (extra_end[mid] > e) {
            hi = mid;
        } else {
            lo = mid + 1;
        }
    }
    return lo;
}

// Counts one item, chunks c0..c0+kItemChunks-1 of tile t, into counts[t]
// (and, for a tile's first item, writes its status).  Every thread of the
// block calls it; it ends synchronised.
__device__ __forceinline__ void count_item(
        const int* __restrict__ r, const int* __restrict__ s, long long s_len,
        const int* __restrict__ row_off, const int* __restrict__ n_chunks,
        unsigned long long* __restrict__ counts, int* __restrict__ status,
        int tile, int t, int c0, int* bufs, int* ends) {
    const int all = n_chunks[t];
    const long long start = static_cast<long long>(row_off[t]) * kLanes;
    const bool in_range = row_off[t] >= 0 &&
                          start + static_cast<long long>(all) * tile <= s_len;
    if (c0 == 0 && threadIdx.x == 0) status[t] = all > 0 && !in_range ? 2 : 0;
    const int nc = min(kItemChunks, all - c0);
    if (nc <= 0 || !in_range) return;   // the same for the whole block
    int x[kKeysPerThread];
    load_blocked(x, r + static_cast<long long>(t) * tile);
    // The tile is sorted, so its keys below PACK_LIMIT are a prefix, held by
    // the first `busy` threads; where that is half the block or less (a
    // tile mostly of padding), spread them over every thread, through the
    // second chunk buffer (free until chunk 1 is loaded).
    const int busy = __syncthreads_count(x[0] < kPackLimit);
    if (busy == 0) return;   // nothing to count (the same for the block)
    if (2 * busy <= static_cast<int>(blockDim.x)) {
        int* spread = bufs + padded_chunk(tile);
        if (static_cast<int>(threadIdx.x) < busy) {
#pragma unroll
            for (int j = 0; j < kKeysPerThread; ++j) {
                spread[padded(threadIdx.x * kKeysPerThread + j)] = x[j];
            }
        }
        __syncthreads();
        const int keys = busy * kKeysPerThread;
        const int per = (keys + blockDim.x - 1) / blockDim.x;
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
            const int i = threadIdx.x * per + j;
            x[j] = j < per && i < keys ? spread[padded(i)] : kMaxI32;
        }
        __syncthreads();
    }
    const int* band = s + start + static_cast<long long>(c0) * tile;
    if (threadIdx.x < 2 * nc) {
        ends[threadIdx.x] = band[static_cast<long long>(threadIdx.x >> 1) *
                                 tile + (threadIdx.x & 1) * (tile - 1)];
    }
    __syncthreads();

    // chunk c's load, where its first and last keys differ
    auto prefetch = [&](int c) {
        const int lo = ends[2 * c];
        if (lo != ends[2 * c + 1] && lo < kPackLimit) {
            cp_async_padded(bufs + (c & 1) * padded_chunk(tile),
                            band + static_cast<long long>(c) * tile, tile);
        }
        cp_async_commit();
    };
    prefetch(0);
    long long cnt = 0;
    for (int c = 0; c < nc; ++c) {
        const int lo = ends[2 * c], hi = ends[2 * c + 1];
        if (lo >= kPackLimit) break;   // padding only, from here on too
        if (c + 1 < nc) {
            prefetch(c + 1);
        } else {
            cp_async_commit();
        }
        if (lo == hi) {
            int same = 0;
#pragma unroll
            for (int j = 0; j < kKeysPerThread; ++j) same += x[j] == lo;
            cnt += static_cast<long long>(same) * tile;
        } else {
            cp_async_wait<1>();   // chunk c has landed (c + 1 may not)
            __syncthreads();
            cnt += count_chunk(x, bufs + (c & 1) * padded_chunk(tile), tile,
                               lo, hi);
        }
        __syncthreads();   // buffer c & 1 is free for chunk c + 2
    }
    cp_async_wait<0>();
    cnt = block_sum(cnt);   // ends synchronised: ends and buffers are free
    if (threadIdx.x == 0 && cnt) {
        atomicAdd(counts + t, static_cast<unsigned long long>(cnt));
    }
}

// Block b < n_tiles takes tile b's first item; the blocks past them stride
// over the extra items.
// kBlockThreads: the most threads a block (tile / 16) of this instance;
// kMinBlocks: the blocks an SM its registers are sized for.
template <int kBlockThreads, int kMinBlocks>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
banded_count_kernel(const int* __restrict__ r, const int* __restrict__ s,
                    long long s_len, const int* __restrict__ row_off,
                    const int* __restrict__ n_chunks,
                    const long long* __restrict__ extra_end, int n_tiles,
                    unsigned long long* __restrict__ counts,
                    int* __restrict__ status, int tile) {
    extern __shared__ int4 smem4[];
    int* bufs = reinterpret_cast<int*>(smem4);   // two padded chunks
    __shared__ int ends[2 * kItemChunks];        // each chunk's first, last key
    if (blockIdx.x < n_tiles) {
        count_item(r, s, s_len, row_off, n_chunks, counts, status, tile,
                   blockIdx.x, 0, bufs, ends);
        return;
    }
    const long long extras = extra_end[n_tiles - 1];
    for (long long e = blockIdx.x - n_tiles; e < extras;
         e += gridDim.x - n_tiles) {
        const int t = extra_tile(extra_end, n_tiles, e);
        const int c0 = static_cast<int>(e - (t ? extra_end[t - 1] : 0) + 1) *
                       kItemChunks;
        count_item(r, s, s_len, row_off, n_chunks, counts, status, tile, t,
                   c0, bufs, ends);
    }
}

}  // namespace

// Launches K4 on `stream` and returns the CUDA error code (0 on success).
// r (n_tiles * tile keys) and s (s_len keys) are 16-byte aligned device
// pointers; row_off and n_chunks have n_tiles ints; extra_end (n_tiles
// int64) is the inclusive prefix sum of each tile's items past its first
// (ceil(n_chunks / kItemChunks) - 1, at least 0); counts (n_tiles int64) is
// zeroed by the caller and receives each tile's count; status (n_tiles
// ints) gets 2 where a tile's chunks would end past s_len (nothing read),
// else 0.  tile is a power of two in [2048, 16384].
extern "C" int htm_banded_count(const int* r, const int* s, long long s_len,
                                const int* row_off, const int* n_chunks,
                                const long long* extra_end, int n_tiles,
                                long long* counts, int* status, int tile,
                                void* stream) {
    if (n_tiles <= 0) return 0;
    // three blocks of up to 512 threads an SM (tiles to 8192: 2 x 36 KB of
    // padded chunks each), one of 1024 at tile 16384
    auto kernel = tile <= 8192 ? banded_count_kernel<512, 3>
                               : banded_count_kernel<1024, 1>;
    const int threads = tile / kKeysPerThread;
    const int smem = 2 * padded_chunk(tile) * static_cast<int>(sizeof(int));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch(kernel, n_tiles + sms * (per_sm > 0 ? per_sm : 1), threads,
                  smem, stream, r, s, s_len, row_off, n_chunks, extra_end,
                  n_tiles, reinterpret_cast<unsigned long long*>(counts),
                  status, tile);
}
