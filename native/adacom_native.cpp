// adacom native host runtime.
//
// C++ counterparts of the engine's host-side hot loops, mirroring where the
// reference keeps its performance-critical code native (the whole reference
// is C++; SURVEY.md §2). Exposed over a C ABI and loaded via ctypes
// (adacom/native.py); every entry point has a NumPy fallback so the
// engine runs without the .so.
//
// Contents:
//  - vertical-lane FOR bit-packing codec (same layout as ops/bitpack.py:
//    element i -> row i/L, lane i%L; word k of a lane holds bits [32k,32k+32)
//    of the lane's 32 concatenated codes)
//  - filter kernels for the host latency tier (eq/range over u32/i64 ->
//    match indices)
//  - bounded Zipf sampler (rejection-inversion, Hormann & Derflinger),
//    matching the reference's generator (benchmark/micro/succinct/zipf.cpp)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <random>
#include <atomic>
#include <thread>
#include <vector>
#include <unordered_map>

extern "C" {

// ----------------------------------------------------------------------
// codec
// ----------------------------------------------------------------------

// codes: n values (already min-subtracted), width w in 1..32,
// words_out: (w, L) row-major with L = ceil(n/32) lanes, zero-initialized
// by the caller.
void adacom_pack_u32(const uint32_t* codes, int64_t n, int width,
                     uint32_t* words_out) {
    const int64_t L = (n + 31) / 32;
    const uint64_t mask = (width == 32) ? 0xFFFFFFFFull
                                        : ((1ull << width) - 1ull);
    for (int64_t lane = 0; lane < L; ++lane) {
        uint64_t acc = 0;
        int shift = 0;
        int k = 0;
        for (int r = 0; r < 32; ++r) {
            const int64_t flat = (int64_t)r * L + lane;  // (32, L) row-major
            uint64_t code = 0;
            if (flat < n) code = codes[flat] & mask;
            acc |= code << shift;
            shift += width;
            if (shift >= 32) {
                words_out[(int64_t)k * L + lane] = (uint32_t)(acc & 0xFFFFFFFFu);
                acc >>= 32;
                shift -= 32;
                ++k;
            }
        }
    }
}

void adacom_unpack_u32(const uint32_t* words, int64_t n, int width,
                       uint32_t* out) {
    const int64_t L = (n + 31) / 32;
    const uint64_t mask = (width == 32) ? 0xFFFFFFFFull
                                        : ((1ull << width) - 1ull);
    for (int64_t lane = 0; lane < L; ++lane) {
        for (int r = 0; r < 32; ++r) {
            const int64_t flat = (int64_t)r * L + lane;
            if (flat >= n) continue;
            const int64_t p = (int64_t)r * width;
            const int64_t k = p >> 5;
            const int off = (int)(p & 31);
            uint64_t code = (uint64_t)words[k * L + lane] >> off;
            if (off + width > 32)
                code |= (uint64_t)words[(k + 1) * L + lane] << (32 - off);
            out[flat] = (uint32_t)(code & mask);
        }
    }
}

// Random-access decode of selected rows (FetchRow parity).
void adacom_gather_u32(const uint32_t* words, int64_t n_lanes, int width,
                       const int64_t* idx, int64_t n_idx, uint32_t* out) {
    const uint64_t mask = (width == 32) ? 0xFFFFFFFFull
                                        : ((1ull << width) - 1ull);
    for (int64_t j = 0; j < n_idx; ++j) {
        const int64_t i = idx[j];
        const int64_t r = i / n_lanes;
        const int64_t lane = i % n_lanes;
        const int64_t p = r * width;
        const int64_t k = p >> 5;
        const int off = (int)(p & 31);
        uint64_t code = (uint64_t)words[k * n_lanes + lane] >> off;
        if (off + width > 32)
            code |= (uint64_t)words[(k + 1) * n_lanes + lane] << (32 - off);
        out[j] = (uint32_t)(code & mask);
    }
}

// ----------------------------------------------------------------------
// host latency-tier filters: return number of matches, fill idx_out
// ----------------------------------------------------------------------

int64_t adacom_filter_eq_u32(const uint32_t* vals, int64_t n, uint32_t v,
                             int64_t* idx_out) {
    // blockwise: a branchless SIMD-friendly "any match?" sweep skips the
    // serial index-emit loop for blocks without hits (selective point
    // lookups match ~1 row per segment)
    int64_t m = 0;
    int64_t i = 0;
    constexpr int64_t B = 512;
    for (; i + B <= n; i += B) {
        uint32_t any = 0;
        for (int64_t j = 0; j < B; ++j) any |= (vals[i + j] == v);
        if (any)
            for (int64_t j = 0; j < B; ++j)
                if (vals[i + j] == v) idx_out[m++] = i + j;
    }
    for (; i < n; ++i)
        if (vals[i] == v) idx_out[m++] = i;
    return m;
}

int64_t adacom_filter_range_u32(const uint32_t* vals, int64_t n, uint32_t lo,
                                uint32_t hi, int64_t* idx_out) {
    // matches lo <= v < hi; same blockwise any-match structure
    int64_t m = 0;
    int64_t i = 0;
    constexpr int64_t B = 512;
    for (; i + B <= n; i += B) {
        uint32_t any = 0;
        for (int64_t j = 0; j < B; ++j)
            any |= (vals[i + j] >= lo) & (vals[i + j] < hi);
        if (any)
            for (int64_t j = 0; j < B; ++j)
                if (vals[i + j] >= lo && vals[i + j] < hi) idx_out[m++] = i + j;
    }
    for (; i < n; ++i)
        if (vals[i] >= lo && vals[i] < hi) idx_out[m++] = i;
    return m;
}

int64_t adacom_filter_eq_i64(const int64_t* vals, int64_t n, int64_t v,
                             int64_t* idx_out) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i)
        if (vals[i] == v) idx_out[m++] = i;
    return m;
}

// Fused decode+filter directly over the packed words (scan over compressed
// data without materializing the column — the AdaCom scan hot loop,
// succinct.cpp:124-144, fused as the device scan kernels do).
int64_t adacom_packed_filter_eq_u32(const uint32_t* words, int64_t n,
                                    int width, uint32_t min_factor,
                                    uint32_t v, int64_t* idx_out) {
    if (v < min_factor) return 0;
    const uint64_t code_target = v - min_factor;
    const uint64_t mask = (width == 32) ? 0xFFFFFFFFull
                                        : ((1ull << width) - 1ull);
    if (code_target > mask) return 0;
    const int64_t L = (n + 31) / 32;
    int64_t m = 0;
    for (int64_t lane = 0; lane < L; ++lane) {
        for (int r = 0; r < 32; ++r) {
            const int64_t flat = (int64_t)r * L + lane;
            if (flat >= n) continue;
            const int64_t p = (int64_t)r * width;
            const int64_t k = p >> 5;
            const int off = (int)(p & 31);
            uint64_t code = (uint64_t)words[k * L + lane] >> off;
            if (off + width > 32)
                code |= (uint64_t)words[(k + 1) * L + lane] << (32 - off);
            if ((code & mask) == code_target) idx_out[m++] = flat;
        }
    }
    return m;
}

// ----------------------------------------------------------------------
// bounded Zipf sampler (reference zipf.cpp parity)
// ----------------------------------------------------------------------

static double zipf_expxm1bx(double x) {
    return (std::abs(x) > 1e-8) ? std::expm1(x) / x
                                : (1.0 + x / 2.0 * (1.0 + x / 3.0 * (1.0 + x / 4.0)));
}
static double zipf_log1pxbx(double x) {
    return (std::abs(x) > 1e-8) ? std::log1p(x) / x
                                : 1.0 - x * (0.5 - x * (1.0 / 3.0 - x * 0.25));
}

void adacom_zipf_sample(uint64_t n, double q, uint64_t seed, int64_t n_out,
                        int64_t* out) {
    auto H = [&](double x) {
        const double lx = std::log(x);
        return zipf_expxm1bx((1.0 - q) * lx) * lx;
    };
    auto h = [&](double x) { return std::exp(-q * std::log(x)); };
    auto H_inv = [&](double x) {
        const double t = std::max(x * (1.0 - q), -1.0);
        return std::exp(zipf_log1pxbx(t) * x);
    };
    const double H_x1 = H(1.5) - 1.0;
    const double H_n = H((double)n + 0.5);
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> dist(H_x1, H_n);
    for (int64_t i = 0; i < n_out; ++i) {
        while (true) {
            const double u = dist(rng);
            const double x = H_inv(u);
            const uint64_t k = (uint64_t)std::clamp(
                std::llround(x), 1ll, (long long)n);
            if (u >= H((double)k + 0.5) - h((double)k)) {
                out[i] = (int64_t)k;
                break;
            }
        }
    }
}

// ----------------------------------------------------------------------
// grouped aggregation hash table (reference GroupedAggregateHashTable,
// src/execution/aggregate_hashtable.cpp: linear probing, power-of-two
// capacity, FindOrCreateGroups). Single 64-bit key column — the engine
// hash-combines multi-column keys into one u64 before calling in.
// ----------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// Returns n_groups. gid_out[n] gets the group id per row (first-occurrence
// order); first_row_out[n_groups] the row index where each group first
// appeared (caller gathers the unique key values from it).
int64_t adacom_groupby_i64(const int64_t* keys, int64_t n,
                           int64_t* gid_out, int64_t* first_row_out) {
    if (n == 0) return 0;
    uint64_t cap = 16;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int64_t> slot_gid(cap, -1);
    std::vector<int64_t> slot_key(cap, 0);
    int64_t n_groups = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t k = keys[i];
        uint64_t pos = splitmix64((uint64_t)k) & mask;
        while (true) {
            int64_t g = slot_gid[pos];
            if (g < 0) {
                slot_gid[pos] = n_groups;
                slot_key[pos] = k;
                first_row_out[n_groups] = i;
                gid_out[i] = n_groups;
                ++n_groups;
                break;
            }
            if (slot_key[pos] == k) {
                gid_out[i] = g;
                break;
            }
            pos = (pos + 1) & mask;  // linear probe
        }
    }
    return n_groups;
}

// exact int64 grouped sum (hugeint-accumulator analogue for decimals)
void adacom_group_sum_i64(const int64_t* gid, const int64_t* vals, int64_t n,
                          int64_t* out /* prezeroed, n_groups */) {
    for (int64_t i = 0; i < n; ++i) out[gid[i]] += vals[i];
}

void adacom_group_sum_f64(const int64_t* gid, const double* vals, int64_t n,
                          double* out) {
    for (int64_t i = 0; i < n; ++i) out[gid[i]] += vals[i];
}

// ----------------------------------------------------------------------
// LSD radix argsort over u64 keys (reference RadixSort,
// src/common/sort/radix_sort.cpp: counting sort per digit). Caller maps
// signed/float keys into order-preserving u64 first. Skips digits whose
// histogram is a single bucket (the reference's zero-byte skip).
// ----------------------------------------------------------------------

void adacom_argsort_u64(const uint64_t* keys, int64_t n, int64_t* idx_out) {
    std::vector<int64_t> tmp(n);
    int64_t* src = idx_out;
    int64_t* dst = tmp.data();
    for (int64_t i = 0; i < n; ++i) src[i] = i;
    int64_t hist[256];
    for (int pass = 0; pass < 8; ++pass) {
        const int shift = pass * 8;
        std::fill(hist, hist + 256, 0);
        for (int64_t i = 0; i < n; ++i)
            ++hist[(keys[src[i]] >> shift) & 0xFF];
        bool single = false;
        for (int b = 0; b < 256; ++b)
            if (hist[b] == n) { single = true; break; }
        if (single) continue;
        int64_t sum = 0;
        for (int b = 0; b < 256; ++b) {
            int64_t c = hist[b];
            hist[b] = sum;
            sum += c;
        }
        for (int64_t i = 0; i < n; ++i)
            dst[hist[(keys[src[i]] >> shift) & 0xFF]++] = src[i];
        std::swap(src, dst);
    }
    if (src != idx_out)
        std::copy(src, src + n, idx_out);
}

// ----------------------------------------------------------------------
// hash join: chained-bucket table, threaded probe
// (reference JoinHashTable::Build / InsertHashes / Probe,
//  src/execution/join_hashtable.cpp:197,308,415 — bitmask bucketing into
//  per-bucket row chains, then vectorized chain-walking probes)
// ----------------------------------------------------------------------

namespace {

struct JoinHT {
    const int64_t* keys;   // build keys (borrowed)
    int64_t n;
    uint64_t mask;         // bucket mask (capacity - 1)
    std::vector<int64_t> head;  // bucket -> first row (-1 empty)
    std::vector<int64_t> next;  // row -> next row in chain (-1 end)
};

inline int n_threads_for(int64_t work) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    int t = (int)std::min<int64_t>(hw, std::max<int64_t>(1, work / 262144));
    return t < 1 ? 1 : t;
}

}  // namespace

void* adacom_join_build_i64(const int64_t* keys, int64_t n) {
    JoinHT* ht = new JoinHT();
    ht->keys = keys;
    ht->n = n;
    uint64_t cap = 16;
    while ((int64_t)cap < 2 * n) cap <<= 1;
    ht->mask = cap - 1;
    ht->head.assign(cap, -1);
    ht->next.assign((size_t)std::max<int64_t>(n, 1), -1);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t b = splitmix64((uint64_t)keys[i]) & ht->mask;
        ht->next[i] = ht->head[b];
        ht->head[b] = i;
    }
    return ht;
}

void adacom_join_free(void* p) { delete (JoinHT*)p; }

// Per-probe-row match counts (threaded); counts_out has n entries.
void adacom_join_count_i64(void* p, const int64_t* probe, int64_t n,
                           int64_t* counts_out) {
    JoinHT* ht = (JoinHT*)p;
    int nt = n_threads_for(n);
    auto work = [&](int64_t a, int64_t z) {
        for (int64_t i = a; i < z; ++i) {
            const int64_t k = probe[i];
            uint64_t b = splitmix64((uint64_t)k) & ht->mask;
            int64_t c = 0;
            for (int64_t j = ht->head[b]; j >= 0; j = ht->next[j])
                if (ht->keys[j] == k) ++c;
            counts_out[i] = c;
        }
    };
    if (nt == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
        ts.emplace_back(work, n * t / nt, n * (t + 1) / nt);
    for (auto& t : ts) t.join();
}

// Emit all (probe_idx, build_idx) pairs; offsets = exclusive prefix sums of
// the counts (caller-computed), li/ri sized to the total.
void adacom_join_emit_i64(void* p, const int64_t* probe, int64_t n,
                          const int64_t* offsets, int64_t* li, int64_t* ri) {
    JoinHT* ht = (JoinHT*)p;
    int nt = n_threads_for(n);
    auto work = [&](int64_t a, int64_t z) {
        for (int64_t i = a; i < z; ++i) {
            const int64_t k = probe[i];
            uint64_t b = splitmix64((uint64_t)k) & ht->mask;
            int64_t o = offsets[i];
            for (int64_t j = ht->head[b]; j >= 0; j = ht->next[j])
                if (ht->keys[j] == k) { li[o] = i; ri[o] = j; ++o; }
        }
    };
    if (nt == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
        ts.emplace_back(work, n * t / nt, n * (t + 1) / nt);
    for (auto& t : ts) t.join();
}

// ----------------------------------------------------------------------
// threaded range filter + multi-column gather (host scan tier hot path)
// ----------------------------------------------------------------------

// ----------------------------------------------------------------------
// threaded group-by: radix partition by hash byte, per-bucket tables,
// then remap group ids to global first-seen order
// (reference RadixPartitionedHashTable, radix_partitioned_hashtable.cpp —
//  partition the input by hash bits, build independent tables per
//  partition in parallel, merge)
// ----------------------------------------------------------------------

int64_t adacom_groupby_i64_mt(const int64_t* keys, int64_t n,
                              int64_t* gid_out, int64_t* first_row_out) {
    if (n == 0) return 0;
    const int T = n_threads_for(n);
    if (T <= 1 || n < 1 << 18) {
        return adacom_groupby_i64(keys, n, gid_out, first_row_out);
    }
    constexpr int B = 256;
    // pass A: per-thread bucket histograms (bucket = high hash byte)
    std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(B, 0));
    auto bucket_of = [&](int64_t k) {
        return (int)(splitmix64((uint64_t)k) >> 56);
    };
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t)
            ts.emplace_back([&, t] {
                auto& h = hist[t];
                for (int64_t i = n * t / T; i < n * (t + 1) / T; ++i)
                    ++h[bucket_of(keys[i])];
            });
        for (auto& th : ts) th.join();
    }
    // bucket-major, thread-minor exclusive prefix: keeps rows within a
    // bucket in global row order (thread slices are contiguous row ranges)
    std::vector<int64_t> bucket_start(B + 1, 0);
    {
        int64_t sum = 0;
        for (int b = 0; b < B; ++b) {
            bucket_start[b] = sum;
            for (int t = 0; t < T; ++t) {
                int64_t c = hist[t][b];
                hist[t][b] = sum;  // becomes this thread's write cursor
                sum += c;
            }
        }
        bucket_start[B] = sum;
    }
    // pass B: scatter row indices into partitioned order
    std::vector<int64_t> part(n);
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t)
            ts.emplace_back([&, t] {
                auto& cur = hist[t];
                for (int64_t i = n * t / T; i < n * (t + 1) / T; ++i)
                    part[cur[bucket_of(keys[i])]++] = i;
            });
        for (auto& th : ts) th.join();
    }
    // pass C: per-bucket open-addressing tables (buckets split over
    // threads); local gid = bucket-local; firsts in bucket row order
    std::vector<int64_t> bucket_groups(B, 0);
    std::vector<std::vector<int64_t>> bucket_firsts(B);
    {
        std::atomic<int> next_b{0};
        auto work = [&] {
            std::vector<int64_t> slot_gid, slot_key;
            while (true) {
                int b = next_b.fetch_add(1);
                if (b >= B) break;
                const int64_t a = bucket_start[b], z = bucket_start[b + 1];
                const int64_t bn = z - a;
                if (bn == 0) continue;
                uint64_t cap = 16;
                while (cap < (uint64_t)bn * 2) cap <<= 1;
                const uint64_t mask = cap - 1;
                slot_gid.assign(cap, -1);
                slot_key.assign(cap, 0);
                auto& firsts = bucket_firsts[b];
                int64_t ng = 0;
                for (int64_t j = a; j < z; ++j) {
                    const int64_t row = part[j];
                    const int64_t k = keys[row];
                    uint64_t pos = splitmix64((uint64_t)k) & mask;
                    while (true) {
                        int64_t g = slot_gid[pos];
                        if (g < 0) {
                            slot_gid[pos] = ng;
                            slot_key[pos] = k;
                            firsts.push_back(row);
                            gid_out[row] = ng;
                            ++ng;
                            break;
                        }
                        if (slot_key[pos] == k) {
                            gid_out[row] = g;
                            break;
                        }
                        pos = (pos + 1) & mask;
                    }
                }
                bucket_groups[b] = ng;
            }
        };
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(work);
        for (auto& th : ts) th.join();
    }
    // global first-seen order: sort (first_row) across buckets, build the
    // old (bucket, local gid) -> new gid remap
    std::vector<int64_t> bucket_base(B + 1, 0);
    for (int b = 0; b < B; ++b)
        bucket_base[b + 1] = bucket_base[b] + bucket_groups[b];
    const int64_t n_groups = bucket_base[B];
    std::vector<int64_t> all_first(n_groups);
    for (int b = 0; b < B; ++b)
        std::copy(bucket_firsts[b].begin(), bucket_firsts[b].end(),
                  all_first.begin() + bucket_base[b]);
    std::vector<int64_t> order(n_groups);
    for (int64_t g = 0; g < n_groups; ++g) order[g] = g;
    std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
        return all_first[x] < all_first[y];
    });
    std::vector<int64_t> remap(n_groups);
    for (int64_t r = 0; r < n_groups; ++r) {
        remap[order[r]] = r;
        first_row_out[r] = all_first[order[r]];
    }
    // final pass: bucket-local gids -> global first-seen gids (threaded)
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t)
            ts.emplace_back([&, t] {
                for (int64_t i = n * t / T; i < n * (t + 1) / T; ++i) {
                    const int b = bucket_of(keys[i]);
                    gid_out[i] = remap[bucket_base[b] + gid_out[i]];
                }
            });
        for (auto& th : ts) th.join();
    }
    return n_groups;
}

// ----------------------------------------------------------------------
// threaded gathers (join output materialization: out[j] = src[idx[j]])
// ----------------------------------------------------------------------

void adacom_gather8(const void* src, const int64_t* idx, int64_t n,
                    void* out) {
    const uint64_t* s = (const uint64_t*)src;
    uint64_t* o = (uint64_t*)out;
    int nt = n_threads_for(n);
    auto work = [&](int64_t a, int64_t z) {
        for (int64_t j = a; j < z; ++j) o[j] = s[idx[j]];
    };
    if (nt == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
        ts.emplace_back(work, n * t / nt, n * (t + 1) / nt);
    for (auto& t : ts) t.join();
}

void adacom_gather4(const void* src, const int64_t* idx, int64_t n,
                    void* out) {
    const uint32_t* s = (const uint32_t*)src;
    uint32_t* o = (uint32_t*)out;
    int nt = n_threads_for(n);
    auto work = [&](int64_t a, int64_t z) {
        for (int64_t j = a; j < z; ++j) o[j] = s[idx[j]];
    };
    if (nt == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
        ts.emplace_back(work, n * t / nt, n * (t + 1) / nt);
    for (auto& t : ts) t.join();
}

void adacom_gather1(const void* src, const int64_t* idx, int64_t n,
                    void* out) {
    const uint8_t* s = (const uint8_t*)src;
    uint8_t* o = (uint8_t*)out;
    int nt = n_threads_for(n);
    auto work = [&](int64_t a, int64_t z) {
        for (int64_t j = a; j < z; ++j) o[j] = s[idx[j]];
    };
    if (nt == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
        ts.emplace_back(work, n * t / nt, n * (t + 1) / nt);
    for (auto& t : ts) t.join();
}

// rows_out must hold n entries; returns the match count. Inclusive [lo, hi].
int64_t adacom_filter_range_i64(const int64_t* vals, int64_t n, int64_t lo,
                                int64_t hi, int64_t* rows_out) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i)
        if (vals[i] >= lo && vals[i] <= hi) rows_out[m++] = i;
    return m;
}

int64_t adacom_filter_range_i32(const int32_t* vals, int64_t n, int32_t lo,
                                int32_t hi, int64_t* rows_out) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i)
        if (vals[i] >= lo && vals[i] <= hi) rows_out[m++] = i;
    return m;
}


// ----------------------------------------------------------------------
// FSST-class string compression (reference: src/storage/compression/
// fsst.cpp + third_party/fsst; Boncz, Neumann, Leis, "FSST: Fast Random
// Access String Compression", VLDB 2020). Simplified trainer: one
// counting pass over a bounded sample scores every 2..8-gram by saved
// bytes ((len-1) * freq) and the top <=254 become the symbol table.
// Encoder: greedy longest match, escape byte 255 + literal for misses.
// Random access is preserved: strings encode independently (per-string
// offsets), so one dictionary entry decodes without touching the rest.
// ----------------------------------------------------------------------

// Symbols are 2..7 bytes: (bytes << 3) | len is then an INVERTIBLE
// 59-bit key (8-byte symbols would overflow it — the paper's tables go
// to 8; one byte of headroom costs ~2% ratio and buys exact keys).
static inline uint64_t fsst_gram_key(const uint8_t* p, int len) {
    uint64_t k = 0;
    for (int i = 0; i < len; ++i) k = (k << 8) | p[i];
    return (k << 3) | (uint64_t)len;
}

// symtab: 254*8 bytes, symlens: 254. Returns the symbol count.
int adacom_fsst_train(const uint8_t* corpus, int64_t len,
                      uint8_t* symtab, uint8_t* symlens) {
    const int64_t SAMPLE = 1 << 18;  // 256 KB of sampled positions
    int64_t stride = len <= SAMPLE ? 1 : len / SAMPLE;
    std::unordered_map<uint64_t, uint32_t> counts;
    counts.reserve((size_t)(std::min(len, SAMPLE) * 2));
    for (int64_t base = 0; base < len; base += stride) {
        const uint8_t* p = corpus + base;
        int max_l = (int)std::min<int64_t>(7, len - base);
        for (int l = 2; l <= max_l; ++l) ++counts[fsst_gram_key(p, l)];
    }
    struct Cand { uint64_t key; uint64_t score; };
    std::vector<Cand> cands;
    cands.reserve(counts.size());
    for (const auto& kv : counts) {
        int l = (int)(kv.first & 7u);
        if (kv.second < 2) continue;  // singletons never pay
        cands.push_back({kv.first, (uint64_t)(l - 1) * kv.second});
    }
    int want = (int)std::min<size_t>(254, cands.size());
    std::partial_sort(cands.begin(), cands.begin() + want, cands.end(),
                      [](const Cand& a, const Cand& b) {
                          return a.score > b.score;
                      });
    for (int i = 0; i < want; ++i) {
        int l = (int)(cands[i].key & 7u);
        uint64_t bytes = cands[i].key >> 3;
        symlens[i] = (uint8_t)l;
        for (int j = l - 1; j >= 0; --j) {
            symtab[(int64_t)i * 8 + j] = (uint8_t)(bytes & 0xFF);
            bytes >>= 8;
        }
    }
    return want;
}

struct FsstLookup {
    std::unordered_map<uint64_t, uint8_t> map;
};

static FsstLookup* fsst_build_lookup(const uint8_t* symtab,
                                     const uint8_t* symlens, int n_sym) {
    auto* lk = new FsstLookup();
    lk->map.reserve((size_t)n_sym * 2);
    for (int i = 0; i < n_sym; ++i)
        lk->map[fsst_gram_key(symtab + (int64_t)i * 8, symlens[i])] =
            (uint8_t)i;
    return lk;
}

// Encode n_str strings (corpus with n_str+1 offsets) into out/out_offs.
// Returns total encoded bytes, or -1 if out_cap would overflow.
int64_t adacom_fsst_encode(const uint8_t* symtab, const uint8_t* symlens,
                           int n_sym, const uint8_t* corpus,
                           const int64_t* offs, int64_t n_str,
                           uint8_t* out, int64_t out_cap,
                           int64_t* out_offs) {
    FsstLookup* lk = fsst_build_lookup(symtab, symlens, n_sym);
    int64_t w = 0;
    out_offs[0] = 0;
    for (int64_t s = 0; s < n_str; ++s) {
        const uint8_t* p = corpus + offs[s];
        int64_t slen = offs[s + 1] - offs[s];
        int64_t i = 0;
        while (i < slen) {
            int max_l = (int)std::min<int64_t>(7, slen - i);
            int hit = -1, hit_l = 0;
            for (int l = max_l; l >= 2; --l) {
                auto it = lk->map.find(fsst_gram_key(p + i, l));
                if (it != lk->map.end()) {
                    hit = it->second;
                    hit_l = l;
                    break;
                }
            }
            if (hit >= 0) {
                if (w + 1 > out_cap) { delete lk; return -1; }
                out[w++] = (uint8_t)hit;
                i += hit_l;
            } else {
                if (w + 2 > out_cap) { delete lk; return -1; }
                out[w++] = 255;
                out[w++] = p[i++];
            }
        }
        out_offs[s + 1] = w;
    }
    delete lk;
    return w;
}

// Decode one encoded string into out; returns decoded length or -1 if cap
// would overflow.
int64_t adacom_fsst_decode(const uint8_t* symtab, const uint8_t* symlens,
                           int n_sym, const uint8_t* in, int64_t len,
                           uint8_t* out, int64_t cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < len;) {
        uint8_t c = in[i++];
        if (c == 255) {
            if (i >= len || w + 1 > cap) return -1;
            out[w++] = in[i++];
        } else {
            if (c >= n_sym) return -1;
            int l = symlens[c];
            if (w + l > cap) return -1;
            std::memcpy(out + w, symtab + (int64_t)c * 8, (size_t)l);
            w += l;
        }
    }
    return w;
}

}  // extern "C"
