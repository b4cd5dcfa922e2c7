// K4 for Hopper: the general banded match count.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _count_megakernel (entry banded_count, pallas_call in _banded_count_jit).
// For each sorted T-key tile t of the build side it counts the equal-key
// pairs (keys < PACK_LIMIT) between the tile and n_chunks[t] T-key chunks of
// the sorted probe side, chunk c at S[row_off[t]*128 + c*T, +T).  The count
// of a tile is summed in int64 and written per tile; n_chunks = 0 skips the
// tile.  A tile whose chunks would end past s_len reads nothing, counts 0
// and gets status 2 (the caller raises).
//
// What bounds it on an H100: shared-memory binary searches, log2(T) steps
// twice per tile key per chunk, and, for the repair's unbounded chunk
// counts, one block streaming every chunk of a heavy tile (a hot key with
// 10^7 probe copies is about 1200 chunks at T = 8192).  The design holds
// the tile in shared memory once and streams the chunks through a second
// shared buffer with 16-byte loads.  Each chunk's first and last keys bound
// the keys worth searching for, and a chunk of a single key (a heavy
// hitter's run) is counted without searching, as the number of tile keys
// equal to it times T.  The count is per tile in int64, so the TPU kernel's
// int32 per-position accumulator and its overflow certificate are not
// needed.  Double-buffered chunk loads and splitting a tile's chunks across
// blocks are later work.

#include "banded_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
banded_count_kernel(const int* __restrict__ r, const int* __restrict__ s,
                    long long s_len, const int* __restrict__ row_off,
                    const int* __restrict__ n_chunks,
                    long long* __restrict__ counts, int* __restrict__ status,
                    int tile) {
    extern __shared__ int4 smem4[];
    int* v = reinterpret_cast<int*>(smem4);   // the tile, [tile]
    int* chunk = v + tile;                     // one S chunk, [tile]
    const int t = blockIdx.x;
    const int nc = n_chunks[t];
    const long long start = static_cast<long long>(row_off[t]) * kLanes;
    const bool in_range =
        nc <= 0 || (row_off[t] >= 0 &&
                    start + static_cast<long long>(nc) * tile <= s_len);
    if (nc <= 0 || !in_range) {   // the same for every thread of the block
        if (threadIdx.x == 0) {
            counts[t] = 0;
            status[t] = in_range ? 0 : 2;
        }
        return;
    }

    copy_keys(v, r + static_cast<long long>(t) * tile, tile);
    long long cnt = 0;
    for (int c = 0; c < nc; ++c) {
        __syncthreads();   // the previous chunk is no longer read
        copy_keys(chunk, s + start + static_cast<long long>(c) * tile, tile);
        __syncthreads();
        const int lo = chunk[0];
        const int hi = chunk[tile - 1];
        if (lo >= kPackLimit) continue;   // padding only, from here on too
        if (lo == hi) {
            int same = 0;
            for (int i = threadIdx.x; i < tile; i += blockDim.x) {
                same += v[i] == lo;
            }
            cnt += static_cast<long long>(same) * tile;
        } else {
            for (int i = threadIdx.x; i < tile; i += blockDim.x) {
                const int x = v[i];
                if (x >= lo && x <= hi && x < kPackLimit) {
                    cnt += equal_count(chunk, tile, x);
                }
            }
        }
    }
    cnt = block_sum(cnt);
    if (threadIdx.x == 0) {
        counts[t] = cnt;
        status[t] = 0;
    }
}

}  // namespace

// Launches K4 on `stream` over n_tiles tiles (one block each) and returns
// the CUDA error code (0 on success).  r (n_tiles * tile keys) and s (s_len
// keys) are 16-byte aligned device pointers; row_off and n_chunks have
// n_tiles ints; counts (int64) and status get one entry a tile.  tile is a
// power of two in [2048, 16384].
extern "C" int htm_banded_count(const int* r, const int* s, long long s_len,
                                const int* row_off, const int* n_chunks,
                                long long* counts, int* status, int n_tiles,
                                int tile, void* stream) {
    const int smem = 2 * tile * static_cast<int>(sizeof(int));
    return launch(banded_count_kernel, n_tiles, kThreads, smem, stream, r, s,
                  s_len, row_off, n_chunks, counts, status, tile);
}
