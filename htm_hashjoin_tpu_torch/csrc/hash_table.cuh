// The slot rule of the scatter tables, shared by the claim rounds that
// build them (claim_insert.cu) and the probe that reads them
// (hash_probe.cu): one definition, so a table is read where it was
// written.
//
// A key's hash h is computed here (identity: key & mask; locality:
// floor(key / 3) & mask, as torch's // on int32) or handed over as an
// int32 value.  Its j-th slot is (h + j) & mask in open addressing (stride
// 0), or h * S + j in buckets of S slots (stride S).
//
// Everything sits in an unnamed namespace: each kernel source is its own
// translation unit and gets its own copy.

#pragma once

namespace {

constexpr int kIdentityHash = 1;       // else 2: locality; 0: handed over
constexpr int kLocalityHash = 2;

// How the keys of a table find their slots.
struct SlotRule {
    int kind;         // kIdentityHash, kLocalityHash, or 0: h handed over
    unsigned mask;    // the hash's mask
    int stride;       // 0: open addressing; else the slots of a bucket
};

__device__ __forceinline__ unsigned hash_of(int key, int given,
                                            const SlotRule& r) {
    if (r.kind == kIdentityHash) return static_cast<unsigned>(key) & r.mask;
    if (r.kind == kLocalityHash) {
        int q = key / 3;
        if (key % 3 < 0) --q;          // floor, as torch's // on int32
        return static_cast<unsigned>(q) & r.mask;
    }
    return static_cast<unsigned>(given) & r.mask;
}

__device__ __forceinline__ unsigned slot_of(unsigned h, int j,
                                            const SlotRule& r) {
    return r.stride ? h * static_cast<unsigned>(r.stride) + j
                    : (h + j) & r.mask;
}

}  // namespace
