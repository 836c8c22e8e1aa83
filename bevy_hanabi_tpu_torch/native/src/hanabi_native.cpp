// Native host-side runtime for bevy_hanabi_tpu.
//
// The reference implements its CPU-side runtime in Rust: the spawner state
// machine (spawn.rs:838-921) ticked per ECS entity, and the slab sub-allocator
// managing particle storage ranges (effect_cache.rs:482-612). This library is
// the equivalent for this framework: the TPU consumes per-frame spawn counts
// and row ranges; producing them for thousands of instances is host work that
// belongs in native code, not per-instance Python.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 hanabi_native.cpp -o libhanabi_native.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <map>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PCG32 (for CpuValue::Uniform resampling, one stream per spawner)
// ---------------------------------------------------------------------------

struct Pcg32 {
    uint64_t state;
    uint64_t inc;
};

static inline uint32_t pcg32_next(Pcg32* r) {
    uint64_t old = r->state;
    r->state = old * 6364136223846793005ULL + (r->inc | 1);
    uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = (uint32_t)(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
}

static inline float pcg32_float(Pcg32* r) {
    // 24-bit mantissa uniform in [0, 1)
    return (pcg32_next(r) >> 8) * (1.0f / 16777216.0f);
}

// ---------------------------------------------------------------------------
// Spawner bank: N spawner state machines with identical settings, ticked as
// one contiguous pass (mirrors EffectSpawner::tick control flow).
// ---------------------------------------------------------------------------

struct SpawnerBank {
    int32_t n;
    // settings: CpuValue ranges [lo, hi]; lo==hi means Single
    float count_lo, count_hi;
    float duration_lo, duration_hi;
    float period_lo, period_hi;
    uint32_t cycle_count;  // 0 = forever
    // per-instance state
    std::vector<double> cycle_time;
    std::vector<double> remainder;
    std::vector<double> sampled_period;      // 0 => resample
    std::vector<double> sampled_duration;
    std::vector<double> sampled_count;
    std::vector<uint32_t> completed;
    std::vector<uint8_t> active;
    std::vector<Pcg32> rng;
};

static inline float sample_range(Pcg32* r, float lo, float hi) {
    if (lo == hi) return lo;
    return lo + (hi - lo) * pcg32_float(r);
}

void* hanabi_spawner_bank_create(
    int32_t n,
    float count_lo, float count_hi,
    float duration_lo, float duration_hi,
    float period_lo, float period_hi,
    uint32_t cycle_count,
    int32_t starts_active,
    int32_t emit_on_start,
    uint64_t seed) {
    auto* b = new (std::nothrow) SpawnerBank();
    if (!b) return nullptr;
    b->n = n;
    b->count_lo = count_lo; b->count_hi = count_hi;
    b->duration_lo = duration_lo; b->duration_hi = duration_hi;
    b->period_lo = period_lo; b->period_hi = period_hi;
    b->cycle_count = cycle_count;
    b->cycle_time.assign(n, 0.0);
    b->remainder.assign(n, 0.0);
    b->sampled_period.assign(n, 0.0);
    b->sampled_duration.assign(n, 0.0);
    b->sampled_count.assign(n, 0.0);
    // emit_on_start=false starts finite-cycle spawners at their last cycle
    // (nothing emits until reset); forever spawners ignore the flag
    // (reference: spawn.rs:703-710).
    uint32_t start_cycles =
        (emit_on_start || cycle_count == 0) ? 0u : cycle_count;
    b->completed.assign(n, start_cycles);
    b->active.assign(n, starts_active ? 1 : 0);
    b->rng.resize(n);
    for (int32_t i = 0; i < n; ++i) {
        b->rng[i].state = seed + 0x9E3779B97F4A7C15ULL * (uint64_t)(i + 1);
        b->rng[i].inc = (seed ^ 0xDA3E39CB94B95BDBULL) + 2 * (uint64_t)i + 1;
        pcg32_next(&b->rng[i]);
    }
    return b;
}

void hanabi_spawner_bank_destroy(void* handle) {
    delete static_cast<SpawnerBank*>(handle);
}

void hanabi_spawner_bank_reset(void* handle, int32_t index) {
    auto* b = static_cast<SpawnerBank*>(handle);
    int32_t lo = index < 0 ? 0 : index;
    int32_t hi = index < 0 ? b->n : index + 1;
    for (int32_t i = lo; i < hi; ++i) {
        b->cycle_time[i] = 0.0;
        b->remainder[i] = 0.0;
        b->sampled_period[i] = 0.0;
        b->completed[i] = 0;
    }
}

void hanabi_spawner_bank_set_active(void* handle, int32_t index, int32_t active) {
    auto* b = static_cast<SpawnerBank*>(handle);
    int32_t lo = index < 0 ? 0 : index;
    int32_t hi = index < 0 ? b->n : index + 1;
    for (int32_t i = lo; i < hi; ++i) b->active[i] = active ? 1 : 0;
}

// Tick every spawner by dt; writes int32 spawn counts to out[n].
// Mirrors EffectSpawner::tick: per-cycle resampling, spawn-window ratio
// accumulation, multi-cycle catch-up, fractional remainder carry.
void hanabi_spawner_bank_tick(void* handle, double dt_in, int32_t* out) {
    auto* b = static_cast<SpawnerBank*>(handle);
    const bool once = b->cycle_count == 1;
    const bool forever = b->cycle_count == 0;
    for (int32_t i = 0; i < b->n; ++i) {
        if (!b->active[i] || (!forever && b->completed[i] >= b->cycle_count)) {
            out[i] = 0;
            continue;
        }
        double dt = dt_in;
        for (int guard = 0; guard < 1024; ++guard) {
            if (b->sampled_period[i] == 0.0) {
                Pcg32* r = &b->rng[i];
                if (once) {
                    b->sampled_duration[i] =
                        sample_range(r, b->duration_lo, b->duration_hi);
                    b->sampled_period[i] =
                        std::max(b->sampled_duration[i], 1e-12);
                } else {
                    b->sampled_period[i] =
                        sample_range(r, b->period_lo, b->period_hi);
                    double d = sample_range(r, b->duration_lo, b->duration_hi);
                    b->sampled_duration[i] =
                        std::min(std::max(d, 0.0), b->sampled_period[i]);
                }
                b->sampled_count[i] =
                    std::max((double)sample_range(r, b->count_lo, b->count_hi), 0.0);
            }
            double new_time = b->cycle_time[i] + dt;
            if (b->cycle_time[i] <= b->sampled_duration[i]) {
                // threshold uses the per-cycle rebound dt (spawn.rs:878
                // rebinds dt each cycle; the frame dt would keep later
                // cycles in burst mode)
                if (b->sampled_duration[i] < std::max(1e-5, dt / 100.0)) {
                    b->remainder[i] += b->sampled_count[i];
                } else {
                    double ratio =
                        (std::min(new_time, b->sampled_duration[i]) -
                         b->cycle_time[i]) /
                        b->sampled_duration[i];
                    ratio = std::min(std::max(ratio, 0.0), 1.0);
                    b->remainder[i] += b->sampled_count[i] * ratio;
                }
            }
            b->cycle_time[i] = new_time;
            if (b->cycle_time[i] >= b->sampled_period[i]) {
                dt = b->cycle_time[i] - b->sampled_period[i];
                b->cycle_time[i] = 0.0;
                b->completed[i] += 1;
                b->sampled_period[i] = 0.0;
                if (!forever && b->completed[i] >= b->cycle_count) break;
            } else {
                break;
            }
        }
        double c = std::floor(b->remainder[i]);
        b->remainder[i] -= c;
        out[i] = (int32_t)c;
    }
}

// ---------------------------------------------------------------------------
// Slab allocator: best-fit free-list over particle rows (EffectCache /
// ParticleSlab analogue, effect_cache.rs:482-612). Offsets are row indices.
// ---------------------------------------------------------------------------

struct Slab {
    uint32_t capacity;
    // free ranges: offset -> size, kept coalesced
    std::map<uint32_t, uint32_t> free_ranges;
    uint32_t used;
};

void* hanabi_slab_create(uint32_t capacity) {
    auto* s = new (std::nothrow) Slab();
    if (!s) return nullptr;
    s->capacity = capacity;
    s->free_ranges[0] = capacity;
    s->used = 0;
    return s;
}

void hanabi_slab_destroy(void* handle) { delete static_cast<Slab*>(handle); }

// Best-fit allocate; returns row offset or 0xFFFFFFFF if it doesn't fit.
uint32_t hanabi_slab_alloc(void* handle, uint32_t size) {
    auto* s = static_cast<Slab*>(handle);
    if (size == 0) return 0xFFFFFFFFu;
    auto best = s->free_ranges.end();
    uint32_t best_size = 0xFFFFFFFFu;
    for (auto it = s->free_ranges.begin(); it != s->free_ranges.end(); ++it) {
        if (it->second >= size && it->second < best_size) {
            best = it;
            best_size = it->second;
            if (best_size == size) break;
        }
    }
    if (best == s->free_ranges.end()) return 0xFFFFFFFFu;
    uint32_t offset = best->first;
    uint32_t remaining = best->second - size;
    s->free_ranges.erase(best);
    if (remaining > 0) s->free_ranges[offset + size] = remaining;
    s->used += size;
    return offset;
}

// Free a range, coalescing with neighbors. Returns 0 on success.
int32_t hanabi_slab_free(void* handle, uint32_t offset, uint32_t size) {
    auto* s = static_cast<Slab*>(handle);
    // 64-bit sum: offset + size can wrap uint32 and slip past the check.
    if ((uint64_t)offset + (uint64_t)size > (uint64_t)s->capacity || size == 0)
        return -1;
    auto next = s->free_ranges.lower_bound(offset);
    // overlap checks
    if (next != s->free_ranges.end() && offset + size > next->first) return -2;
    if (next != s->free_ranges.begin()) {
        auto prev = std::prev(next);
        if (prev->first + prev->second > offset) return -2;
    }
    uint32_t new_off = offset;
    uint32_t new_size = size;
    if (next != s->free_ranges.end() && next->first == offset + size) {
        new_size += next->second;
        s->free_ranges.erase(next);
    }
    auto again = s->free_ranges.lower_bound(new_off);
    if (again != s->free_ranges.begin()) {
        auto prev = std::prev(again);
        if (prev->first + prev->second == new_off) {
            new_off = prev->first;
            new_size += prev->second;
            s->free_ranges.erase(prev);
        }
    }
    s->free_ranges[new_off] = new_size;
    s->used -= size;
    return 0;
}

uint32_t hanabi_slab_used(void* handle) {
    return static_cast<Slab*>(handle)->used;
}

uint32_t hanabi_slab_capacity(void* handle) {
    return static_cast<Slab*>(handle)->capacity;
}

uint32_t hanabi_slab_num_free_ranges(void* handle) {
    return (uint32_t)static_cast<Slab*>(handle)->free_ranges.size();
}

uint32_t hanabi_slab_largest_free(void* handle) {
    auto* s = static_cast<Slab*>(handle);
    uint32_t best = 0;
    for (auto& kv : s->free_ranges) best = std::max(best, kv.second);
    return best;
}

}  // extern "C"
