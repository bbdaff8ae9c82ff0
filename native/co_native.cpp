// co_native — host-side native runtime for convex_optimization_tpu.
//
// The device compute path is XLA plus one CUDA kernel (see ops/); this
// library covers the runtime *around* it, where the hot cost is host CPU
// and disk:
//   * threaded standard-normal generation (xoshiro256++ + Box-Muller) for
//     synthesizing large design matrices on the host without going through
//     the Python RNG (used by core/datagen.py for host-side instances),
//   * a zero-copy binary problem store (header + raw little-endian f32),
//     written atomically and read back with plain fread into caller-owned
//     buffers (numpy arrays), so checkpointed problems and solutions move
//     at disk speed with no pickling.
//
// Exposed as a plain C ABI consumed via ctypes (utils/native.py).  The
// reference's only native component was its CUDA compute backend
// (SURVEY.md section 2.1 native-component ledger); this file is the
// framework's host-runtime counterpart, not a port of it.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Xoshiro256pp {
  uint64_t s[4];

  explicit Xoshiro256pp(uint64_t seed) {
    // splitmix64 expansion of the seed
    uint64_t z = seed;
    for (int i = 0; i < 4; ++i) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }

  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  inline uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // uniform in (0, 1] — never 0, safe for log()
  inline double uniform() {
    return ((next() >> 11) + 1) * 0x1.0p-53;
  }
};

void fill_normal_range(float* out, int64_t lo, int64_t hi, uint64_t seed) {
  Xoshiro256pp rng(seed);
  int64_t i = lo;
  // Box-Muller, two at a time
  for (; i + 1 < hi; i += 2) {
    double u1 = rng.uniform(), u2 = rng.uniform();
    double rad = std::sqrt(-2.0 * std::log(u1));
    double ang = 6.283185307179586 * u2;
    out[i] = static_cast<float>(rad * std::cos(ang));
    out[i + 1] = static_cast<float>(rad * std::sin(ang));
  }
  if (i < hi) {
    double u1 = rng.uniform(), u2 = rng.uniform();
    out[i] = static_cast<float>(std::sqrt(-2.0 * std::log(u1)) *
                                std::cos(6.283185307179586 * u2));
  }
}

constexpr char kMagic[8] = {'C', 'O', 'T', 'P', 'U', 'M', '0', '1'};

struct Header {
  char magic[8];
  int64_t rows;
  int64_t cols;
  int32_t dtype;  // 0 = f32, 1 = f64
  int32_t reserved;
};

}  // namespace

extern "C" {

// Fill out[0..size) with standard normals. Deterministic in (seed, size,
// nthreads are independent: each thread derives its own stream from seed +
// chunk index, so the result does not depend on nthreads).
void co_gaussian_fill(float* out, int64_t size, uint64_t seed, int nthreads) {
  if (size <= 0) return;
  const int64_t kChunk = 1 << 20;  // 1M elements per stream
  const int64_t nchunks = (size + kChunk - 1) / kChunk;
  if (nthreads < 1) nthreads = 1;
  std::atomic<int64_t> next_chunk{0};
  auto worker = [&]() {
    for (;;) {
      int64_t c = next_chunk.fetch_add(1);
      if (c >= nchunks) break;
      int64_t lo = c * kChunk;
      int64_t hi = lo + kChunk < size ? lo + kChunk : size;
      fill_normal_range(out, lo, hi, seed * 0x9e3779b97f4a7c15ULL + c + 1);
    }
  };
  if (nthreads == 1 || nchunks == 1) {
    worker();
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

// Atomic binary matrix write: header + raw row-major data. Returns 0 on
// success, negative errno-style codes on failure.
int co_write_matrix(const char* path, const float* data, int64_t rows,
                    int64_t cols) {
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  Header h{};
  std::memcpy(h.magic, kMagic, 8);
  h.rows = rows;
  h.cols = cols;
  h.dtype = 0;
  bool ok = std::fwrite(&h, sizeof(h), 1, f) == 1;
  const int64_t total = rows * cols;
  const int64_t kIO = 1 << 22;
  for (int64_t off = 0; ok && off < total; off += kIO) {
    int64_t cnt = off + kIO < total ? kIO : total - off;
    ok = std::fwrite(data + off, sizeof(float), cnt, f) ==
         static_cast<size_t>(cnt);
  }
  ok = (std::fclose(f) == 0) && ok;
  if (!ok) {
    std::remove(tmp.c_str());
    return -2;
  }
  if (std::rename(tmp.c_str(), path) != 0) {
    std::remove(tmp.c_str());
    return -3;
  }
  return 0;
}

// Read the header only: out_shape[0] = rows, out_shape[1] = cols.
int co_read_matrix_shape(const char* path, int64_t* out_shape) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Header h{};
  bool ok = std::fread(&h, sizeof(h), 1, f) == 1 &&
            std::memcmp(h.magic, kMagic, 8) == 0;
  std::fclose(f);
  if (!ok) return -2;
  out_shape[0] = h.rows;
  out_shape[1] = h.cols;
  return 0;
}

// Read data into a caller-owned buffer of rows*cols floats.
int co_read_matrix(const char* path, float* out, int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Header h{};
  bool ok = std::fread(&h, sizeof(h), 1, f) == 1 &&
            std::memcmp(h.magic, kMagic, 8) == 0 && h.rows == rows &&
            h.cols == cols && h.dtype == 0;
  const int64_t total = rows * cols;
  const int64_t kIO = 1 << 22;
  for (int64_t off = 0; ok && off < total; off += kIO) {
    int64_t cnt = off + kIO < total ? kIO : total - off;
    ok = std::fread(out + off, sizeof(float), cnt, f) ==
         static_cast<size_t>(cnt);
  }
  std::fclose(f);
  return ok ? 0 : -2;
}

// Cyclic coordinate-descent sweeps (lasso "shooting") on an f32
// COLUMN-MAJOR slab with float64 iterates — the hot loop of the polish
// phase's support solve (solvers/polish.py _cd64).
//
// Why native: the NumPy version makes three interpreter-dispatched calls
// per column (cast-copy, dot, axpy); at the headline's |S|~7k support
// that is ~21k GIL windows per sweep, each a chance for another Python
// thread to take the core.  One C call runs gap_every full sweeps with
// the GIL RELEASED, at streaming speed, with identical f64 update
// arithmetic.
//
//   As      (m x width) float32, column-major (column j at As + j*m)
//   xs      (width,) float64 iterate, updated in place
//   r       (m,) float64 residual A xs - b, updated in place
//   col_sq  (width,) ||A_j||^2 + lam2 (f64)
//   nonneg  0 = soft-threshold (l1), 1 = shift-and-clip (nonneg_l1)
void co_cd64_sweeps(const float* As, int64_t m, int64_t width, double* xs,
                    double* r, const double* col_sq, double lam1,
                    double lam2, int nonneg, int sweeps) {
  for (int s = 0; s < sweeps; ++s) {
    for (int64_t j = 0; j < width; ++j) {
      const float* aj = As + j * m;
      const double xj = xs[j];
      // 4-way accumulators: lets the compiler vectorize the f32->f64
      // convert + fma reduction without -ffast-math reassociation
      double g0 = 0.0, g1 = 0.0, g2 = 0.0, g3 = 0.0;
      int64_t i = 0;
      for (; i + 4 <= m; i += 4) {
        g0 += static_cast<double>(aj[i]) * r[i];
        g1 += static_cast<double>(aj[i + 1]) * r[i + 1];
        g2 += static_cast<double>(aj[i + 2]) * r[i + 2];
        g3 += static_cast<double>(aj[i + 3]) * r[i + 3];
      }
      double g = (g0 + g1) + (g2 + g3);
      for (; i < m; ++i) g += static_cast<double>(aj[i]) * r[i];
      g += lam2 * xj;
      const double cs = col_sq[j];
      const double v = xj - g / cs;
      const double tl = lam1 / cs;
      double xn;
      if (nonneg) {
        xn = v > tl ? v - tl : 0.0;
      } else {
        xn = v > tl ? v - tl : (v < -tl ? v + tl : 0.0);
      }
      const double d = xn - xj;
      if (d != 0.0) {
        for (int64_t k = 0; k < m; ++k) {
          r[k] += static_cast<double>(aj[k]) * d;
        }
        xs[j] = xn;
      }
    }
  }
}

// Group-lasso block coordinate-descent sweeps (the group analog of
// co_cd64_sweeps; solvers/polish.py _cd64_group).  One prox-gradient step
// per contiguous gsize-wide group per visit with Gauss-Seidel residual
// updates; L = per-group Lipschitz (lam_max(Ag^T Ag) + lam2), w =
// per-group weights.
void co_cd64_group_sweeps(const float* As, int64_t m, int64_t width,
                          int64_t gsize, double* xs, double* r,
                          const double* L, const double* w, double lam1,
                          double lam2, int sweeps, double* scratch) {
  const int64_t ngroups = width / gsize;
  double* grad = scratch;              // (gsize,)
  double* xn = scratch + gsize;        // (gsize,)
  for (int s = 0; s < sweeps; ++s) {
    for (int64_t gidx = 0; gidx < ngroups; ++gidx) {
      const float* Ag = As + gidx * gsize * m;
      double* xg = xs + gidx * gsize;
      // grad = Ag^T r + lam2 xg; v = xg - grad / L  (stored into xn)
      double nv2 = 0.0;
      for (int64_t c = 0; c < gsize; ++c) {
        const float* ac = Ag + c * m;
        double g0 = 0.0, g1 = 0.0, g2 = 0.0, g3 = 0.0;
        int64_t i = 0;
        for (; i + 4 <= m; i += 4) {
          g0 += static_cast<double>(ac[i]) * r[i];
          g1 += static_cast<double>(ac[i + 1]) * r[i + 1];
          g2 += static_cast<double>(ac[i + 2]) * r[i + 2];
          g3 += static_cast<double>(ac[i + 3]) * r[i + 3];
        }
        double g = (g0 + g1) + (g2 + g3);
        for (; i < m; ++i) g += static_cast<double>(ac[i]) * r[i];
        grad[c] = g + lam2 * xg[c];
        const double v = xg[c] - grad[c] / L[gidx];
        xn[c] = v;
        nv2 += v * v;
      }
      const double nv = std::sqrt(nv2);
      const double denom = nv > 1e-300 ? nv : 1e-300;
      double scale = 1.0 - lam1 * w[gidx] / (L[gidx] * denom);
      if (scale < 0.0) scale = 0.0;
      bool any = false;
      for (int64_t c = 0; c < gsize; ++c) {
        xn[c] *= scale;
        if (xn[c] != xg[c]) any = true;
      }
      if (any) {
        for (int64_t c = 0; c < gsize; ++c) {
          const double d = xn[c] - xg[c];
          if (d != 0.0) {
            const float* ac = Ag + c * m;
            for (int64_t i = 0; i < m; ++i) {
              r[i] += static_cast<double>(ac[i]) * d;
            }
          }
          xg[c] = xn[c];
        }
      }
    }
  }
}

// Column gather from an f32 column-major matrix into an f32 or f64
// column-major output (solvers/polish.py _gather_cols).  Contiguous
// 4m-byte reads and contiguous writes, one GIL-released call for the
// whole index set (the NumPy fallback is the batched version in
// solvers/polish.py).
void co_gather_cols(const float* A, int64_t m, const int64_t* idx,
                    int64_t k, int to_f64, void* out) {
  if (to_f64) {
    double* o = static_cast<double*>(out);
    for (int64_t c = 0; c < k; ++c) {
      const float* src = A + idx[c] * m;
      double* dst = o + c * m;
      for (int64_t i = 0; i < m; ++i) dst[i] = static_cast<double>(src[i]);
    }
  } else {
    float* o = static_cast<float*>(out);
    for (int64_t c = 0; c < k; ++c) {
      std::memcpy(o + c * m, A + idx[c] * m, sizeof(float) * m);
    }
  }
}

// z = -(As^T r) - lam2 * xs in f64 from the f32 column-major slab (the
// polish gap-check witness, solvers/polish.py _gemv_t_mixed).
void co_atr_mixed(const float* As, int64_t m, int64_t width,
                  const double* r, double lam2, const double* xs,
                  double* z) {
  for (int64_t j = 0; j < width; ++j) {
    const float* aj = As + j * m;
    double g0 = 0.0, g1 = 0.0, g2 = 0.0, g3 = 0.0;
    int64_t i = 0;
    for (; i + 4 <= m; i += 4) {
      g0 += static_cast<double>(aj[i]) * r[i];
      g1 += static_cast<double>(aj[i + 1]) * r[i + 1];
      g2 += static_cast<double>(aj[i + 2]) * r[i + 2];
      g3 += static_cast<double>(aj[i + 3]) * r[i + 3];
    }
    double g = (g0 + g1) + (g2 + g3);
    for (; i < m; ++i) g += static_cast<double>(aj[i]) * r[i];
    z[j] = -g - (xs ? lam2 * xs[j] : 0.0);
  }
}

// r = As xs - b in f64 streaming only the nonzero columns (the polish
// exact residual refresh, solvers/polish.py _residual_sparse32).
void co_ax_sparse(const float* As, int64_t m, int64_t width,
                  const double* xs, const double* b, double* r) {
  for (int64_t i = 0; i < m; ++i) r[i] = -b[i];
  for (int64_t j = 0; j < width; ++j) {
    const double xj = xs[j];
    if (xj != 0.0) {
      const float* aj = As + j * m;
      for (int64_t i = 0; i < m; ++i) {
        r[i] += static_cast<double>(aj[i]) * xj;
      }
    }
  }
}

// Per-group block Lipschitz estimates via power iteration on the f32
// column-major slab (solvers/polish.py _cd64_group setup): L[g] =
// safety * lam_max(Ag^T Ag) + lam2, f64 accumulation.  Deterministic
// start (ones + a small tilt — orthogonality to the top singular vector
// has measure zero), matching the Python fallback exactly.
void co_group_power_l(const float* As, int64_t m, int64_t width,
                      int64_t gsize, int iters, double safety, double lam2,
                      double* L, double* scratch) {
  const int64_t ngroups = width / gsize;
  double* v = scratch;           // (gsize,)
  double* u = scratch + gsize;   // (m,)
  for (int64_t g = 0; g < ngroups; ++g) {
    const float* Ag = As + g * gsize * m;
    double nv2 = 0.0;
    for (int64_t c = 0; c < gsize; ++c) {
      v[c] = 1.0 + 0.01 * static_cast<double>(c) / gsize;
      nv2 += v[c] * v[c];
    }
    double inv = 1.0 / std::sqrt(nv2);
    for (int64_t c = 0; c < gsize; ++c) v[c] *= inv;
    double un2 = 0.0;
    for (int it = 0; it <= iters; ++it) {
      // u = Ag v (column-major: accumulate per column)
      for (int64_t i = 0; i < m; ++i) u[i] = 0.0;
      for (int64_t c = 0; c < gsize; ++c) {
        const float* ac = Ag + c * m;
        const double vc = v[c];
        for (int64_t i = 0; i < m; ++i) {
          u[i] += static_cast<double>(ac[i]) * vc;
        }
      }
      un2 = 0.0;
      for (int64_t i = 0; i < m; ++i) un2 += u[i] * u[i];
      if (it == iters) break;   // final u norm is the Rayleigh quotient
      // v = Ag^T u, normalized
      nv2 = 0.0;
      for (int64_t c = 0; c < gsize; ++c) {
        const float* ac = Ag + c * m;
        double s = 0.0;
        for (int64_t i = 0; i < m; ++i) {
          s += static_cast<double>(ac[i]) * u[i];
        }
        v[c] = s;
        nv2 += s * s;
      }
      inv = 1.0 / std::max(std::sqrt(nv2), 1e-30);
      for (int64_t c = 0; c < gsize; ++c) v[c] *= inv;
    }
    // floor: an all-zero group slab with lam2 == 0 yields un2 == 0,
    // and a zero L would NaN-poison the caller's prox division
    L[g] = std::max(safety * un2 + lam2, 1e-30);
  }
}

int co_version() { return 7; }

}  // extern "C"
