// Native permutohedral-lattice builder.
//
// Host-side companion to models/lattice.py: the per-map lattice build
// (embedding, rounding, rank, barycentric, vertex dedup, blur-neighbor
// table) is irregular pointer-chasing work that belongs on the CPU; the
// per-iteration filtering runs on the device. This C++ implementation replaces the
// NumPy sort/unique path with an open-addressing hash table, cutting the
// build from O(N (d+1) log) sorting to O(N (d+1)) expected.
//
// Semantics match the reference lattice init
// (/root/reference/third-party/densecrf/src/permutohedral.cpp:323-474) and
// the NumPy implementation bit-for-bit up to vertex numbering (here:
// insertion order, like the reference).
//
// Exposed as a C ABI for ctypes; no Python headers needed.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Open-addressing hash table over int16 keys of fixed dimension d.
class KeyTable {
 public:
  KeyTable(int key_size, size_t expected)
      : key_size_(key_size), capacity_(1), mask_(0) {
    while (capacity_ < expected * 2) capacity_ <<= 1;
    mask_ = capacity_ - 1;
    slots_.assign(capacity_, -1);
    keys_.reserve(expected * key_size);
  }

  int size() const { return static_cast<int>(keys_.size() / key_size_); }

  const int16_t* key(int idx) const { return keys_.data() + idx * key_size_; }

  uint64_t hash(const int16_t* k) const {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (int i = 0; i < key_size_; ++i) {
      h ^= static_cast<uint16_t>(k[i]);
      h *= 1099511628211ull;
    }
    return h;
  }

  // Find the key, inserting when requested. Returns vertex id or -1.
  int find(const int16_t* k, bool create) {
    size_t h = hash(k) & mask_;
    while (true) {
      int slot = slots_[h];
      if (slot == -1) {
        if (!create) return -1;
        int id = size();
        slots_[h] = id;
        keys_.insert(keys_.end(), k, k + key_size_);
        return id;
      }
      if (std::memcmp(key(slot), k, key_size_ * sizeof(int16_t)) == 0)
        return slot;
      h = (h + 1) & mask_;
    }
  }

 private:
  int key_size_;
  size_t capacity_;
  size_t mask_;
  std::vector<int> slots_;
  std::vector<int16_t> keys_;
};

}  // namespace

extern "C" {

// Build the lattice for `features` [n, d] (row-major).
// Outputs (caller-allocated):
//   offsets      [n, d+1] int32
//   barycentric  [n, d+1] float32
// Returns M (vertex count) or -1 on error. Vertex keys are kept in
// thread-local state for the immediately following
// rovina_lattice_neighbors call.
static thread_local KeyTable* g_table = nullptr;
static thread_local int g_dim = 0;

namespace {

// Stage 1: map a feature row onto the E-embedding hyperplane sum(y) = 0.
// y[j] = (sum of scaled coords at indices >= j) - j * scaled[j-1], built
// from a precomputed right-to-left running sum (IEEE addition commutes, so
// this matches the accumulator formulation bit-for-bit).
inline void embed_point(const float* f, const float* axis_scale, int d,
                        float* tail_sum, float* y) {
  tail_sum[d] = 0.0f;
  for (int j = d - 1; j >= 0; --j)
    tail_sum[j] = f[j] * axis_scale[j] + tail_sum[j + 1];
  y[0] = tail_sum[0];
  for (int j = 1; j <= d; ++j)
    y[j] = tail_sum[j] - static_cast<float>(j) * (f[j - 1] * axis_scale[j - 1]);
}

// Stage 2: nearest lattice remainder point (each coordinate snapped to a
// multiple of d+1) and its color sum / (d+1).
inline int snap_to_remainder(const float* y, int d, float* snapped) {
  const float inv = 1.0f / (d + 1);
  const float unit = static_cast<float>(d + 1);
  int color = 0;
  for (int i = 0; i <= d; ++i) {
    const float t = inv * y[i];
    const float above = std::ceil(t) * unit;
    const float below = std::floor(t) * unit;
    // Pick whichever multiple is closer (ties go down, as the metric
    // comparison below is strict).
    const bool take_above = above - y[i] < y[i] - below;
    const int snapped_i =
        take_above ? static_cast<int>(above) : static_cast<int>(below);
    snapped[i] = static_cast<float>(snapped_i);
    color += static_cast<int>(snapped_i * inv);
  }
  return color;
}

// Stage 3: descending-order rank of the residuals y - snapped, computed
// per coordinate by counting (a) later coordinates strictly larger and
// (b) earlier coordinates at least as large — ties break by index, the
// same total order a stable descending sort induces.
inline void residual_ranks(const float* y, const float* snapped, int d,
                           int* order) {
  for (int i = 0; i <= d; ++i) {
    const float res_i = y[i] - snapped[i];
    int r = 0;
    for (int j = 0; j <= d; ++j) {
      if (j == i) continue;
      const float res_j = y[j] - snapped[j];
      if (j > i ? (res_i < res_j) : (res_j >= res_i)) ++r;
    }
    order[i] = r;
  }
}

}  // namespace

int rovina_lattice_build(const float* features, int n, int d,
                         int32_t* offsets, float* barycentric) {
  delete g_table;
  g_table = new KeyTable(d, static_cast<size_t>(n) * (d + 1));
  g_dim = d;

  // Per-axis embedding scales: inv_std_dev / sqrt((i+1)(i+2)).
  std::vector<float> axis_scale(d);
  const float inv_std_dev = std::sqrt(2.0f / 3.0f) * (d + 1);
  for (int i = 0; i < d; ++i)
    axis_scale[i] =
        1.0f / std::sqrt(static_cast<float>((i + 2) * (i + 1))) * inv_std_dev;

  std::vector<float> tail_sum(d + 2), y(d + 1), snapped(d + 1), wts(d + 2);
  std::vector<int> order(d + 1);
  std::vector<int16_t> key(d + 1);
  const float inv = 1.0f / (d + 1);

  for (int k = 0; k < n; ++k) {
    embed_point(features + static_cast<size_t>(k) * d, axis_scale.data(), d,
                tail_sum.data(), y.data());
    const int color = snap_to_remainder(y.data(), d, snapped.data());
    residual_ranks(y.data(), snapped.data(), d, order.data());

    // Shift by the color sum and wrap coordinates whose rank leaves
    // [0, d] back into range (moving the snapped point one cell).
    for (int i = 0; i <= d; ++i) {
      order[i] += color;
      if (order[i] < 0) {
        order[i] += d + 1;
        snapped[i] += d + 1;
      } else if (order[i] > d) {
        order[i] -= d + 1;
        snapped[i] -= d + 1;
      }
    }

    // Barycentric weights: each residual contributes +w at slot d-rank
    // and -w at the next slot; slot 0 absorbs the wrap-around term.
    for (int i = 0; i <= d + 1; ++i) wts[i] = 0.0f;
    for (int i = 0; i <= d; ++i) {
      const float w = (y[i] - snapped[i]) * inv;
      const int slot = d - order[i];
      wts[slot] += w;
      wts[slot + 1] -= w;
    }
    wts[0] += 1.0f + wts[d + 1];

    // One simplex corner per color r: coordinate i moves up by r cells,
    // wrapping by d+1 once its rank passes d - r. (The closed form of
    // the canonical-simplex table.)
    for (int r = 0; r <= d; ++r) {
      for (int i = 0; i < d; ++i) {
        const int step = order[i] <= d - r ? r : r - (d + 1);
        key[i] = static_cast<int16_t>(static_cast<int>(snapped[i]) + step);
      }
      offsets[static_cast<size_t>(k) * (d + 1) + r] =
          g_table->find(key.data(), true);
      barycentric[static_cast<size_t>(k) * (d + 1) + r] = wts[r];
    }
  }
  return g_table->size();
}

// Fill the blur-neighbor tables [d+1, M] after rovina_lattice_build.
// Missing neighbors get `missing` (the zero slot).
int rovina_lattice_neighbors(int32_t* blur_n1, int32_t* blur_n2, int missing) {
  if (!g_table) return -1;
  const int d = g_dim;
  const int m = g_table->size();
  std::vector<int16_t> n1(d), n2(d);
  for (int j = 0; j <= d; ++j) {
    for (int i = 0; i < m; ++i) {
      const int16_t* key = g_table->key(i);
      for (int k = 0; k < d; ++k) {
        n1[k] = static_cast<int16_t>(key[k] - 1);
        n2[k] = static_cast<int16_t>(key[k] + 1);
      }
      if (j < d) {
        n1[j] = static_cast<int16_t>(key[j] + d);
        n2[j] = static_cast<int16_t>(key[j] - d);
      }
      const int f1 = g_table->find(n1.data(), false);
      const int f2 = g_table->find(n2.data(), false);
      blur_n1[static_cast<size_t>(j) * m + i] = f1 < 0 ? missing : f1;
      blur_n2[static_cast<size_t>(j) * m + i] = f2 < 0 ? missing : f2;
    }
  }
  delete g_table;
  g_table = nullptr;
  return m;
}

}  // extern "C"
