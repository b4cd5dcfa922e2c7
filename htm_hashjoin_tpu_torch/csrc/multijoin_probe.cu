// The Wisconsin multijoin's partitioned probe and its emit for Hopper, one
// launch a worker block, under the permutation-build certificate (R's keys
// are kmin..kmax, each once): for every S row of the block, its match in R
// is the R row of rank key - kmin, so the kernel writes the output row at
// the S row's own position, R's payload gathered through the key and S's
// selected column copied, and counts the matches of each schedule unit
// (wisconsin/joiners.py: HashJoiner._kernel_probe).
//
// Replaces no TPU kernel: the JAX package writes the scheduled probe's
// "perm" route and its unit-count emit as jnp arithmetic
// (htm_hashjoin_tpu/wisconsin/joiners.py: _block_bounds_perm, _emit),
// which XLA fuses on the TPU.  It replaces the port's torch formulation of
// it on that route (wisconsin/joiners.py: _block_bounds_perm, _unit_totals,
// _emit), which stays as the path of every other route, policy and device:
// in eager PyTorch that is a 1.1 GiB copy of S's keys into a padded
// column, some 15 passes over each worker block's rows (compares, wheres,
// casts, an int64 cumsum of the counts), cats of the eight blocks' match
// ranges, an arange and a where over the output and a gather of R's
// payload, 23.9 ms a join at 2^28 rows.  The plain version
// (ops/multijoin_probe.py: multijoin_probe_ref) computes what this kernel
// does, exactly: a row whose key lies outside [kmin, kmax] matches nothing
// and gets R's first payload value, the torch route's rank 0; a negative
// key does not void the certificate (it is schedule padding there).
//
// What bounds it on an H100: device memory.  A row's key and selected
// column are read once and its two output values written once, 16 bytes a
// row, and R's payload (4 bytes a key) is read about once: a schedule
// unit's keys fall in one hash partition of 2^18 keys, 1 MiB of payload,
// which the 50 MB L2 holds while the unit is probed.  At 2^28 rows and
// 2^24 keys that is 4.36 GB, 1.30 ms at 3.35 TB/s.  The design reaches for
// that bound as follows: a grid of as many blocks as the SMs hold at once
// splits the block's rows into one contiguous chunk a block.  The chunk is
// walked unit by unit (a unit's bounds come from a binary search of the
// block's unit offsets), so a unit's matches are summed in registers,
// reduced over the block and added with one 64-bit atomic a unit a block;
// the block's total is one more atomic, and a row that voids the
// certificate clears its all-unit flag with a plain store.  Inside a unit
// the threads take the whole quads of four rows (quads aligned to the
// columns' start) kUnroll at a time: a thread issues one 16-byte streaming
// load of four keys and one of four column values for each of its kUnroll
// quads, then the read-only gathers of the payload and two 16-byte
// streaming stores a quad, so that each thread has several independent
// loads in flight.  The rows of a quad cut by the unit's or the chunk's
// edge take one thread each, and so does every row in the kernel's other
// instance, for an input or output that is not 16-byte aligned (a view).

#include "banded_common.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                   // rows a 16-byte load
constexpr int kUnroll = 4;                // quads a thread loads at once

struct Probe {
    int kmin;
    int kmax;
};

__device__ __forceinline__ bool matches(int key, const Probe& p) {
    return key >= p.kmin && key <= p.kmax;
}

// R's payload of a probe key: the R row of rank key - kmin, or rank 0
// where the key matches nothing.
__device__ __forceinline__ int gather(int key, const Probe& p,
                                      const int* __restrict__ payload) {
    return __ldg(payload + (matches(key, p) ? key - p.kmin : 0));
}

// The first unit whose rows reach past `rel` (a row offset in the block):
// the last u < units with ub[u] <= rel.
__device__ __forceinline__ int unit_of(long long rel,
                                       const long long* __restrict__ ub,
                                       int units) {
    int lo = 0, hi = units - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (__ldg(ub + mid) <= rel) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// One row: writes its output values, returns whether it matched and sets
// `voids` where a row with a key >= 0 matches nothing.
__device__ __forceinline__ int probe_row(
        const int* __restrict__ keys, const int* __restrict__ col,
        const int* __restrict__ payload, const Probe& p, long long r,
        int* __restrict__ out_build, int* __restrict__ out_probe,
        bool& voids) {
    const int key = __ldcs(keys + r);
    const bool m = matches(key, p);
    voids |= !m && key >= 0;
    out_build[r] = gather(key, p, payload);
    out_probe[r] = __ldcs(col + r);
    return m;
}

// One whole quad q, its keys k and column values c loaded: writes its
// output values, as probe_row does for each of its rows.
__device__ __forceinline__ int probe_quad(
        int4 k, int4 c, long long q, const int* __restrict__ payload,
        const Probe& p, int* __restrict__ out_build,
        int* __restrict__ out_probe, bool& voids) {
    const int key[kVec] = {k.x, k.y, k.z, k.w};
    int b[kVec];
    int found = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
        b[j] = gather(key[j], p, payload);
        const bool m = matches(key[j], p);
        found += m;
        voids |= !m && key[j] >= 0;
    }
    __stcs(reinterpret_cast<int4*>(out_build) + q,
           make_int4(b[0], b[1], b[2], b[3]));
    __stcs(reinterpret_cast<int4*>(out_probe) + q, c);
    return found;
}

// Rows [lo, hi) of the block: writes their output values and returns the
// matches this thread counted among them; sets `voids` where a row with a
// key >= 0 matches nothing.  The whole quads inside [lo, hi) go kUnroll
// quads a thread at a time, all their loads issued before the gathers;
// the rows before the first and after the last whole quad (or all rows,
// in the instance for unaligned columns) one a thread.
template <bool kAligned>
__device__ __forceinline__ int probe_rows(
        const int* __restrict__ keys, const int* __restrict__ col,
        const int* __restrict__ payload, const Probe& p, long long lo,
        long long hi, int* __restrict__ out_build,
        int* __restrict__ out_probe, bool& voids) {
    int found = 0;
    // the whole quads [qa, qb)
    const long long qa = (lo + kVec - 1) / kVec;
    const long long qb = hi / kVec;
    if (!kAligned || qa >= qb) {
        for (long long r = lo + threadIdx.x; r < hi; r += kThreads) {
            found += probe_row(keys, col, payload, p, r, out_build,
                               out_probe, voids);
        }
        return found;
    }
    for (long long r = lo + threadIdx.x; r < qa * kVec; r += kThreads) {
        found += probe_row(keys, col, payload, p, r, out_build, out_probe,
                           voids);
    }
    for (long long r = qb * kVec + threadIdx.x; r < hi; r += kThreads) {
        found += probe_row(keys, col, payload, p, r, out_build, out_probe,
                           voids);
    }
    const int4* keys4 = reinterpret_cast<const int4*>(keys);
    const int4* col4 = reinterpret_cast<const int4*>(col);
    long long q = qa + threadIdx.x;
    for (; q + (kUnroll - 1) * kThreads < qb; q += kUnroll * kThreads) {
        int4 k[kUnroll], c[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            k[u] = __ldcs(keys4 + q + u * kThreads);
            c[u] = __ldcs(col4 + q + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            found += probe_quad(k[u], c[u], q + u * kThreads, payload, p,
                                out_build, out_probe, voids);
        }
    }
    for (; q < qb; q += kThreads) {
        found += probe_quad(__ldcs(keys4 + q), __ldcs(col4 + q), q, payload,
                            p, out_build, out_probe, voids);
    }
    return found;
}

// One worker block: rows [start, start + rows) of the columns `keys` and
// `col`, its units' row offsets ub[0..units] (relative to start: ub[0] =
// 0, ub[units] = rows).  Writes out_build[r] and out_probe[r] for each of
// its rows r; adds each unit's matches into head[u], the block's into
// head[units], and clears head[units + 1] where a row voids the
// certificate.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
multijoin_probe_kernel(const int* __restrict__ keys,
                       const int* __restrict__ col,
                       const int* __restrict__ payload, Probe p,
                       long long start, long long rows,
                       const long long* __restrict__ ub, int units,
                       int* __restrict__ out_build,
                       int* __restrict__ out_probe,
                       unsigned long long* __restrict__ head) {
    const long long first_q = start / kVec;
    const long long quads = (start + rows + kVec - 1) / kVec - first_q;
    const long long per = (quads + gridDim.x - 1) / gridDim.x;
    const long long q0 = first_q + per * blockIdx.x;
    const long long lo = q0 * kVec > start ? q0 * kVec : start;
    const long long end_q = q0 + per;
    const long long hi = end_q * kVec < start + rows ? end_q * kVec
                                                     : start + rows;
    long long total = 0;
    bool voids = false;
    // the chunk unit by unit; every thread takes the same steps
    for (long long pos = lo; pos < hi;) {
        const int u = unit_of(pos - start, ub, units);
        long long end = start + __ldg(ub + u + 1);
        if (end <= pos || end > hi) end = hi;
        const long long found = block_sum(static_cast<long long>(
            probe_rows<kAligned>(keys, col, payload, p, pos, end, out_build,
                                 out_probe, voids)));
        if (threadIdx.x == 0 && found) {
            atomicAdd(head + u, static_cast<unsigned long long>(found));
        }
        total += found;
        pos = end;
    }
    const bool any_void = block_max(voids ? 1 : 0) != 0;
    if (threadIdx.x == 0) {
        if (total) {
            atomicAdd(head + units, static_cast<unsigned long long>(total));
        }
        if (any_void) head[units + 1] = 0;
    }
}

bool aligned(const void* x) {
    return reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
}

}  // namespace

// Probes on `stream` one worker block, rows [start, start + rows) of the
// split S's key column `keys` and selected column `col`, against R's
// payload in key order (`payload`, n_payload values, kmax - kmin <
// n_payload): writes out_build and out_probe at each row's own index and
// accumulates into `head` (units + 2 int64: each unit's matches, the
// block's, and an all-unit flag that a row with a key >= 0 outside [kmin,
// kmax] clears), as the caller initialised it.  `ub` holds the units' row
// offsets (units + 1 int64, relative to start, from 0 to rows).  Returns
// the CUDA error code (0 on success; cudaErrorInvalidValue for a range or
// size out of bounds).
extern "C" int htm_multijoin_probe(const int* keys, const int* col,
                                   const int* payload, long long n_payload,
                                   int kmin, int kmax, long long start,
                                   long long rows, const long long* ub,
                                   int units, int* out_build, int* out_probe,
                                   long long* head, void* stream) {
    if (start < 0 || rows < 0 || units < 1 || kmin > kmax ||
        static_cast<long long>(kmax) - kmin >= n_payload || !ub || !head) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rows == 0) return static_cast<int>(cudaSuccess);
    const bool vec = aligned(keys) && aligned(col) && aligned(out_build) &&
                     aligned(out_probe);
    const auto kernel = vec ? &multijoin_probe_kernel<true>
                            : &multijoin_probe_kernel<false>;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // as many blocks as the SMs hold at once, or one a chunk of kThreads
    // quads where the rows need fewer
    const long long quads = rows / kVec + 2;
    const long long want = (quads + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int blocks = static_cast<int>(want < cap ? want : cap);
    return launch(kernel, blocks, kThreads, 0, stream, keys, col, payload,
                  Probe{kmin, kmax}, start, rows, ub, units, out_build,
                  out_probe, reinterpret_cast<unsigned long long*>(head));
}
