// K5 for Hopper: the narrow banded match count over already sorted tiles.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _count_narrow_megakernel (entry banded_count_narrow, pallas_call in
// _banded_count_narrow_jit).  It is K1 without the sort: for each sorted
// T-key tile t it loads the tile and its band S[row_off[t]*128, +T + OV),
// counts the equal-key pairs and applies the same certificate and flags
// (0 exact, 1 recount, 2 band outside S, nothing read), through the
// narrow_count that K1 also runs (banded_common.cuh).
//
// What bounds it on an H100: device-memory streaming of 4 bytes per R key
// and (T + 1024)/T x 4 bytes per S key, and the shared-memory binary
// searches (2 log2(T) steps per key).  The design is K1's: one block per
// tile, tile and band in dynamic shared memory (about 68 KB at T = 8192),
// 16-byte loads, an int64 count reduced in the block.

#include "banded_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
banded_count_narrow_kernel(const int* __restrict__ r,
                           const int* __restrict__ s, long long s_len,
                           const int* __restrict__ row_off,
                           const int* __restrict__ rows_needed,
                           long long* __restrict__ counts,
                           int* __restrict__ flags, int tile) {
    extern __shared__ int4 smem4[];
    int* v = reinterpret_cast<int*>(smem4);   // the sorted tile, [tile]
    int* band = v + tile;                      // its S band, [tile + kOv]
    const int t = blockIdx.x;

    copy_keys(v, r + static_cast<long long>(t) * tile, tile);
    const bool in_range = load_band(band, s, s_len, row_off[t], tile);
    __syncthreads();
    narrow_count(v, band, tile, in_range, rows_needed[t], counts + t,
                 flags + t);
}

}  // namespace

// Launches K5 on `stream` over n_tiles tiles (one block each) and returns
// the CUDA error code (0 on success).  r and s are 16-byte aligned device
// pointers; row_off and rows_needed have n_tiles ints; counts (int64) and
// flags get one entry a tile.  tile is a power of two in [2048, 16384].
extern "C" int htm_banded_count_narrow(const int* r, const int* s,
                                       long long s_len, const int* row_off,
                                       const int* rows_needed,
                                       long long* counts, int* flags,
                                       int n_tiles, int tile, void* stream) {
    const int smem = (2 * tile + kOv) * static_cast<int>(sizeof(int));
    return launch(banded_count_narrow_kernel, n_tiles, kThreads, smem, stream,
                  r, s, s_len, row_off, rows_needed, counts, flags, tile);
}
