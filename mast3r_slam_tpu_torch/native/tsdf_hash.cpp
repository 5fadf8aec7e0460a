// Sparse TSDF voxel hash — native runtime component.
//
// Replaces the reference's Python-dict global TSDF volume (reference:
// mast3r_slam/tsdf/global_volume.py:15-140, the slowest structure in that
// system) with an open-addressing hash table over packed integer voxel
// coordinates. Exposed to Python through a plain C ABI (ctypes).
//
// Design:
// - keys: 3 x 21-bit signed voxel coords packed into int64 (capacity for
//   ±1M voxels per axis); EMPTY = INT64_MIN sentinel.
// - open addressing with linear probing; capacity is a power of two chosen
//   at create time; the table never rehashes (fixed memory budget, matches
//   the framework's fixed-capacity design ethos). Inserts fail gracefully
//   when the load factor would exceed ~0.9.
// - integrate: for each (point, conf), sample the camera ray in the
//   ±trunc band at half-voxel steps; weighted-average TSDF update with
//   weight conf * exp(-|sdf|/trunc) clamped to max_weight.
// - query: TSDF value + central-difference gradient (6 neighbor lookups).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <cstdlib>

namespace {

constexpr int64_t EMPTY = INT64_MIN;

struct Volume {
    int64_t capacity;      // power of two
    int64_t mask;
    int64_t size;          // occupied slots
    float voxel_size;
    float trunc;
    float max_weight;
    // stats
    double total_updates;
    int64_t failed_inserts;
    int64_t* keys;
    float* tsdf;
    float* weight;
};

inline int64_t pack(int32_t x, int32_t y, int32_t z) {
    const int64_t B = 1 << 20;  // bias to keep each field non-negative
    return (((int64_t)(x + B)) << 42) | (((int64_t)(y + B)) << 21) |
           ((int64_t)(z + B));
}

inline uint64_t hash_key(int64_t k) {
    uint64_t h = (uint64_t)k;
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return h;
}

// Find slot for key; returns index or -1 if table is too full to insert.
inline int64_t find_slot(Volume* v, int64_t key, bool insert) {
    uint64_t idx = hash_key(key) & (uint64_t)v->mask;
    for (int64_t probe = 0; probe <= v->mask; ++probe) {
        int64_t cur = v->keys[idx];
        if (cur == key) return (int64_t)idx;
        if (cur == EMPTY) {
            if (!insert) return -1;
            if (v->size * 10 >= v->capacity * 9) return -1;  // load cap 0.9
            v->keys[idx] = key;
            v->size++;
            return (int64_t)idx;
        }
        idx = (idx + 1) & (uint64_t)v->mask;
    }
    return -1;
}

inline bool lookup(Volume* v, int32_t x, int32_t y, int32_t z,
                   float* tsdf, float* w) {
    int64_t slot = find_slot(v, pack(x, y, z), false);
    if (slot < 0) return false;
    *tsdf = v->tsdf[slot];
    *w = v->weight[slot];
    return true;
}

}  // namespace

extern "C" {

void* tsdf_create(int64_t capacity_pow2, float voxel_size, float trunc,
                  float max_weight) {
    int64_t cap = 1;
    while (cap < capacity_pow2) cap <<= 1;
    Volume* v = new Volume();
    v->capacity = cap;
    v->mask = cap - 1;
    v->size = 0;
    v->voxel_size = voxel_size;
    v->trunc = trunc;
    v->max_weight = max_weight;
    v->total_updates = 0;
    v->failed_inserts = 0;
    v->keys = (int64_t*)malloc(sizeof(int64_t) * cap);
    v->tsdf = (float*)calloc(cap, sizeof(float));
    v->weight = (float*)calloc(cap, sizeof(float));
    for (int64_t i = 0; i < cap; ++i) v->keys[i] = EMPTY;
    return v;
}

void tsdf_destroy(void* handle) {
    Volume* v = (Volume*)handle;
    free(v->keys);
    free(v->tsdf);
    free(v->weight);
    delete v;
}

void tsdf_clear(void* handle) {
    Volume* v = (Volume*)handle;
    for (int64_t i = 0; i < v->capacity; ++i) v->keys[i] = EMPTY;
    memset(v->tsdf, 0, sizeof(float) * v->capacity);
    memset(v->weight, 0, sizeof(float) * v->capacity);
    v->size = 0;
}

// points (n, 3) world frame; conf (n,); origin (3,) camera center.
// Returns number of voxel updates applied.
int64_t tsdf_integrate(void* handle, const float* points, const float* conf,
                       int64_t n, const float* origin, float min_conf) {
    Volume* v = (Volume*)handle;
    const float vs = v->voxel_size;
    const float trunc = v->trunc;
    const float step = 0.5f * vs;
    int64_t updates = 0;

    for (int64_t i = 0; i < n; ++i) {
        const float c = conf[i];
        if (c < min_conf) continue;
        const float px = points[3 * i], py = points[3 * i + 1],
                    pz = points[3 * i + 2];
        if (!std::isfinite(px) || !std::isfinite(py) || !std::isfinite(pz))
            continue;
        float dx = px - origin[0], dy = py - origin[1], dz = pz - origin[2];
        const float len = std::sqrt(dx * dx + dy * dy + dz * dz);
        // Range gate: garbage/outlier depths (e.g. exp-head blowups) would
        // both pollute the volume and, at ~1e9 m, make float ray stepping
        // degenerate. 1 km is far beyond any indoor/outdoor SLAM scene.
        if (len < 1e-6f || len > 1000.0f) continue;
        dx /= len; dy /= len; dz /= len;

        const float t0 = len - trunc > 0.f ? len - trunc : 0.f;
        const int n_steps = (int)((len + trunc - t0) / step) + 1;
        for (int s = 0; s < n_steps; ++s) {
            const float t = t0 + step * (float)s;
            const float sx = origin[0] + dx * t;
            const float sy = origin[1] + dy * t;
            const float sz = origin[2] + dz * t;
            const int32_t ix = (int32_t)std::floor(sx / vs);
            const int32_t iy = (int32_t)std::floor(sy / vs);
            const int32_t iz = (int32_t)std::floor(sz / vs);
            const float sdf = (len - t) / trunc;  // +1 front .. -1 behind
            const float w = c * std::exp(-std::fabs(sdf));
            if (w <= 0.f) continue;

            int64_t slot = find_slot(v, pack(ix, iy, iz), true);
            if (slot < 0) { v->failed_inserts++; continue; }
            const float w_old = v->weight[slot];
            float w_new = w_old + w;
            v->tsdf[slot] = (v->tsdf[slot] * w_old + sdf * w) / w_new;
            if (w_new > v->max_weight) w_new = v->max_weight;
            v->weight[slot] = w_new;
            updates++;
        }
    }
    v->total_updates += (double)updates;
    return updates;
}

// Query TSDF value + central-difference gradient at world points (n, 3).
// valid_out[i] = 1 iff the containing voxel and all 6 axis neighbors exist
// with weight >= min_weight. Gradient is in 1/meter units (normalized by
// 2 * voxel_size).
int64_t tsdf_query(void* handle, const float* points, int64_t n,
                   float* tsdf_out, float* grad_out, uint8_t* valid_out,
                   float min_weight) {
    Volume* v = (Volume*)handle;
    const float vs = v->voxel_size;
    int64_t n_valid = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t ix = (int32_t)std::floor(points[3 * i] / vs);
        const int32_t iy = (int32_t)std::floor(points[3 * i + 1] / vs);
        const int32_t iz = (int32_t)std::floor(points[3 * i + 2] / vs);
        float c, wc, xp, xm, yp, ym, zp, zm, w;
        bool ok = lookup(v, ix, iy, iz, &c, &wc) && wc >= min_weight;
        ok = ok && lookup(v, ix + 1, iy, iz, &xp, &w) && w >= min_weight;
        ok = ok && lookup(v, ix - 1, iy, iz, &xm, &w) && w >= min_weight;
        ok = ok && lookup(v, ix, iy + 1, iz, &yp, &w) && w >= min_weight;
        ok = ok && lookup(v, ix, iy - 1, iz, &ym, &w) && w >= min_weight;
        ok = ok && lookup(v, ix, iy, iz + 1, &zp, &w) && w >= min_weight;
        ok = ok && lookup(v, ix, iy, iz - 1, &zm, &w) && w >= min_weight;
        if (ok) {
            tsdf_out[i] = c;
            const float inv = 1.0f / (2.0f * vs);
            grad_out[3 * i] = (xp - xm) * inv;
            grad_out[3 * i + 1] = (yp - ym) * inv;
            grad_out[3 * i + 2] = (zp - zm) * inv;
            valid_out[i] = 1;
            n_valid++;
        } else {
            tsdf_out[i] = 0.f;
            grad_out[3 * i] = grad_out[3 * i + 1] = grad_out[3 * i + 2] = 0.f;
            valid_out[i] = 0;
        }
    }
    return n_valid;
}

int64_t tsdf_num_voxels(void* handle) { return ((Volume*)handle)->size; }

void tsdf_stats(void* handle, double* out4) {
    Volume* v = (Volume*)handle;
    out4[0] = (double)v->size;
    out4[1] = (double)v->capacity;
    out4[2] = v->total_updates;
    out4[3] = (double)v->failed_inserts;
}

}  // extern "C"
