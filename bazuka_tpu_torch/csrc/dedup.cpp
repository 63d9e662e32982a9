// The dedup plan's grouping in one pass on the host: the (n, 16) uint16 Fr
// limb rows of a scalar vector -> every nonzero value that more than
// `threshold` rows hold, its member rows, and the values in order, limb 0
// most significant: what `ops/msm_lm.py:_heavy_groups_exact` gives, with
// no comparison sort of the n rows.
//
// Loaded with ctypes.CDLL (`ops/_cxx.py`): the pass touches no Python
// object, so the call releases the GIL and the prover's main thread runs
// on beside it.
//
// Rows whose limbs 1-15 are zero (booleans, small constants) are counted by
// value in a 65,536-entry array.  Every other row is hashed once, as the
// numpy path hashes it (the sum of limb k times mul[k], mod 2^64), the
// hashes are partitioned by their top bits, and each partition is counted
// in an open-addressing table small enough for the L2 cache.  A hash held
// by more than `threshold` rows is a candidate, and every row with that
// hash is compared in full with the first one: any difference is a hash
// clash, and the pass returns kClash for the caller's exact path.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "limb 0 is the low 16 bits of a row's first word"
#endif

namespace {

constexpr int kLimbs = 16;
constexpr int64_t kClash = -1;
constexpr int64_t kTooManyValues = -2;
constexpr int kMaxPartitionBits = 12;
constexpr int64_t kPartitionRows = 8192;  // rows per partition, about

// MurmurHash3's 64-bit finaliser: a bijection, so two mixed hashes are
// equal exactly when the hashes are; its top bits pick the partition and
// its low bits the slot.
inline uint64_t mix(uint64_t h) {
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return h;
}

// Limbs 1-15 are zero.
inline bool is_small(const uint16_t *row) {
    uint64_t w[4];
    std::memcpy(w, row, sizeof w);
    return (w[0] >> 16) == 0 && (w[1] | w[2] | w[3]) == 0;
}

inline uint64_t next_pow2(uint64_t x) {
    uint64_t p = 1;
    while (p < x) {
        p <<= 1;
    }
    return p;
}

struct Entry {  // a hashed row
    uint64_t key;  // mix(hash)
    uint32_t row;
};

struct Slot {  // a distinct key of one partition
    uint64_t key;
    uint32_t count;  // 0: empty
    uint32_t row;    // its first row
};

struct Candidate {
    uint16_t value[kLimbs];
    uint64_t key;  // hashed candidates
    uint32_t row;  // first row (hashed), or the value (small)
    uint32_t count;
    bool small;
};

}  // namespace

// rows: n * 16 uint16, row-major.  mul: 16 uint64 hash multipliers.
// Writes, for the n_heavy rows that hold a heavy value: hm_pos (their
// positions, ascending), labels (each one's value number, in value order)
// and grouped (the same positions ordered by label, ascending within one);
// and values (n_values * 16 uint16, the heavy values in order), at most
// max_values of them.
//
// Returns n_values; kClash on a hash clash; kTooManyValues if more than
// max_values values are heavy.  n must be below 2^32.
extern "C" int64_t bz_heavy_groups(const uint16_t *rows, int64_t n,
                                   int64_t threshold, const uint64_t *mul,
                                   int64_t *hm_pos, int64_t *labels,
                                   int64_t *grouped, uint16_t *values,
                                   int64_t max_values, int64_t *n_heavy) {
    *n_heavy = 0;
    int pbits = 0;
    while (pbits < kMaxPartitionBits && (n >> pbits) > kPartitionRows) {
        ++pbits;
    }
    const int64_t n_parts = int64_t{1} << pbits;
    auto part_of = [pbits](uint64_t key) -> int64_t {
        return pbits == 0 ? 0 : static_cast<int64_t>(key >> (64 - pbits));
    };

    // Pass 1: count the small values; hash the rest, in row order.
    std::vector<uint32_t> small_count(1 << 16, 0);
    std::vector<Entry> hashed;
    hashed.reserve(static_cast<size_t>(n));
    std::vector<int64_t> part_start(n_parts + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        const uint16_t *row = rows + i * kLimbs;
        if (is_small(row)) {
            ++small_count[row[0]];
            continue;
        }
        uint64_t h = 0;
        for (int k = 0; k < kLimbs; ++k) {
            h += row[k] * mul[k];
        }
        const uint64_t key = mix(h);
        hashed.push_back({key, static_cast<uint32_t>(i)});
        ++part_start[part_of(key) + 1];
    }

    // Pass 2: scatter the hashed rows into their partitions, in row order.
    for (int64_t p = 0; p < n_parts; ++p) {
        part_start[p + 1] += part_start[p];
    }
    std::vector<Entry> parts(hashed.size());
    {
        std::vector<int64_t> fill(part_start.begin(), part_start.end() - 1);
        for (const Entry &e : hashed) {
            parts[fill[part_of(e.key)]++] = e;
        }
    }

    // Pass 3: count each partition's keys; keep those above the threshold.
    std::vector<Candidate> cands;
    int64_t largest = 0;
    for (int64_t p = 0; p < n_parts; ++p) {
        largest = std::max(largest, part_start[p + 1] - part_start[p]);
    }
    std::vector<Slot> table(next_pow2(2 * static_cast<uint64_t>(largest) + 2));
    for (int64_t p = 0; p < n_parts; ++p) {
        const int64_t lo = part_start[p], hi = part_start[p + 1];
        if (lo == hi) {
            continue;
        }
        const uint64_t mask = next_pow2(2 * static_cast<uint64_t>(hi - lo)) - 1;
        std::fill(table.begin(), table.begin() + mask + 1, Slot{0, 0, 0});
        for (int64_t j = lo; j < hi; ++j) {
            uint64_t s = parts[j].key & mask;
            while (table[s].count != 0 && table[s].key != parts[j].key) {
                s = (s + 1) & mask;
            }
            if (table[s].count++ == 0) {
                table[s].key = parts[j].key;
                table[s].row = parts[j].row;
            }
        }
        for (uint64_t s = 0; s <= mask; ++s) {
            if (table[s].count > threshold) {
                Candidate c{};
                std::memcpy(c.value, rows + int64_t{table[s].row} * kLimbs,
                            sizeof c.value);
                c.key = table[s].key;
                c.row = table[s].row;
                c.count = table[s].count;
                cands.push_back(c);
            }
        }
    }
    for (uint32_t v = 1; v < (1u << 16); ++v) {
        if (small_count[v] > threshold) {
            Candidate c{};
            c.value[0] = static_cast<uint16_t>(v);
            c.row = v;
            c.count = small_count[v];
            c.small = true;
            cands.push_back(c);
        }
    }
    const int64_t n_values = static_cast<int64_t>(cands.size());
    if (n_values > max_values) {
        return kTooManyValues;
    }

    // Number the values in order, limb 0 most significant.
    std::sort(cands.begin(), cands.end(),
              [](const Candidate &a, const Candidate &b) {
                  return std::lexicographical_compare(
                      a.value, a.value + kLimbs, b.value, b.value + kLimbs);
              });
    std::vector<int32_t> small_label(1 << 16, -1);
    const uint64_t lmask = next_pow2(2 * static_cast<uint64_t>(n_values) + 2) - 1;
    std::vector<std::pair<uint64_t, int32_t>> key_label(lmask + 1, {0, -1});
    std::vector<int64_t> label_start(n_values + 1, 0);
    for (int64_t l = 0; l < n_values; ++l) {
        const Candidate &c = cands[l];
        std::memcpy(values + l * kLimbs, c.value, sizeof c.value);
        label_start[l + 1] = label_start[l] + c.count;
        if (c.small) {
            small_label[c.row] = static_cast<int32_t>(l);
            continue;
        }
        uint64_t s = c.key & lmask;
        while (key_label[s].second >= 0) {
            s = (s + 1) & lmask;
        }
        key_label[s] = {c.key, static_cast<int32_t>(l)};
    }

    // Pass 4: every member, in row order, each hashed one compared in full
    // with its value.
    int64_t k = 0;
    size_t next = 0;  // the next hashed row
    for (int64_t i = 0; i < n; ++i) {
        const uint16_t *row = rows + i * kLimbs;
        int32_t l;
        if (next < hashed.size() && hashed[next].row == i) {
            const uint64_t key = hashed[next++].key;
            uint64_t s = key & lmask;
            while (key_label[s].second >= 0 && key_label[s].first != key) {
                s = (s + 1) & lmask;
            }
            l = key_label[s].second;
            if (l >= 0 && std::memcmp(row, values + int64_t{l} * kLimbs,
                                      kLimbs * sizeof(uint16_t)) != 0) {
                return kClash;
            }
        } else {
            l = small_label[row[0]];
        }
        if (l >= 0) {
            hm_pos[k] = i;
            labels[k] = l;
            grouped[label_start[l]++] = i;
            ++k;
        }
    }
    *n_heavy = k;
    return n_values;
}
