// K5 for Hopper: the narrow banded match count over already sorted tiles.
//
// Replaces the TPU kernel htm_hashjoin_tpu/ops/pallas/join_kernels.py:
// _count_narrow_megakernel (entry banded_count_narrow, pallas_call in
// _banded_count_narrow_jit).  It is K1 without the sort: for each sorted
// T-key tile t it counts the equal-key pairs against the band
// S[row_off[t]*128, +T + OV), applies the same certificate and flags (0
// exact, 1 recount, 2 band outside S, nothing read), through the
// narrow_count_regs that K1 also runs (banded_common.cuh), and writes the
// tile's key sum (MAXI32 left out, int64), the join's conservation check.
//
// What bounds it on an H100: device memory sees 4 bytes a key of R and
// (T + 1024)/T x 4 bytes a key of S, 0.32 ms for a 2^27 build on its 2^27
// probe; the first port ran two binary searches a key over the band in
// shared memory (2 log2(T) dependent reads a key) and took 1.47 ms.  The
// design is K1's count: one block per tile, the band's copy into padded
// shared memory issued with cp.async before the tile is loaded into
// registers (E keys a thread, 16 at T = 8192), then each thread's ascending
// keys counted by one binary search and galloping from there (count_chunk,
// K4's search).  Shared memory holds only the band (41 KB at T = 8192), so
// three blocks share an SM.

#include "banded_common.cuh"

namespace {

template <int E, int P>
__global__ void __launch_bounds__(P, P <= 512 ? 3 : 1)
banded_count_narrow_kernel(const int* __restrict__ r,
                           const int* __restrict__ s, long long s_len,
                           const int* __restrict__ row_off,
                           const int* __restrict__ rows_needed,
                           long long* __restrict__ counts,
                           int* __restrict__ flags,
                           long long* __restrict__ sums) {
    extern __shared__ int4 smem4[];
    constexpr int kT = E * P;
    int* band = reinterpret_cast<int*>(smem4);   // the padded band
    const int t = blockIdx.x;

    const bool in_range = load_band_async(band, s, s_len, row_off[t], kT);
    int x[E];
    load_blocked(x, r + static_cast<long long>(t) * kT);
    cp_async_wait<0>();
    __syncthreads();
    narrow_count_regs<E, P>(x, band, in_range, rows_needed[t], key_sum(x), 0,
                            counts + t, flags + t, sums + t, nullptr);
}

template <int E, int P>
int launch_k5(const int* r, const int* s, long long s_len, const int* row_off,
              const int* rows_needed, long long* counts, int* flags,
              long long* sums, int n_tiles, void* stream) {
    const int smem = padded_chunk(E * P + kOv) * static_cast<int>(sizeof(int));
    return launch(banded_count_narrow_kernel<E, P>, n_tiles, P, smem, stream,
                  r, s, s_len, row_off, rows_needed, counts, flags, sums);
}

}  // namespace

// Launches K5 on `stream` over n_tiles tiles (one block each) and returns
// the CUDA error code (0 on success).  r and s are 16-byte aligned device
// pointers; row_off and rows_needed have n_tiles ints; counts and sums
// (int64) and flags get one entry a tile.  tile is 2048, 4096, 8192 or
// 16384 (4, 8, 16 and 16 keys a thread).
extern "C" int htm_banded_count_narrow(const int* r, const int* s,
                                       long long s_len, const int* row_off,
                                       const int* rows_needed,
                                       long long* counts, int* flags,
                                       long long* sums, int n_tiles, int tile,
                                       void* stream) {
    switch (tile) {
        case 2048:
            return launch_k5<4, 512>(r, s, s_len, row_off, rows_needed, counts,
                                     flags, sums, n_tiles, stream);
        case 4096:
            return launch_k5<8, 512>(r, s, s_len, row_off, rows_needed, counts,
                                     flags, sums, n_tiles, stream);
        case 8192:
            return launch_k5<16, 512>(r, s, s_len, row_off, rows_needed,
                                      counts, flags, sums, n_tiles, stream);
        case 16384:
            return launch_k5<16, 1024>(r, s, s_len, row_off, rows_needed,
                                       counts, flags, sums, n_tiles, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
