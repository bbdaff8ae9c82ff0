// Fused Gauss-Seidel block sweep for Hopper (sm_90a), called from JAX
// through the foreign function interface.  ops/cuda_sweep.py builds this
// file into build/ with nvcc at first use and registers the handler.
//
// One cooperative launch runs one whole cyclic sweep over the column blocks
// of the transposed layout A_t (nb, B, m) for L >= 1 problems that share A
// (a lambda grid, or one lambda when L == 1):
//
//     g_l   = A_j^T r_l + lam2 x_jl               (block gradient)
//     x_jl' = prox_{t_j lam1_l}(x_jl - t_j g_l)   (per-lambda prox)
//     r_l  += rm * A_j (x_jl' - x_jl)             (residual update)
//
// Block j + 1 needs all of r after block j's update, and Hopper's CTAs run
// concurrently, so the rows of the problem are split across the CTAs
// instead: CTA c owns rows [c*ms, c*ms + ms) of every residual r_l and keeps
// them in shared memory for the whole sweep.  For each block it
//   1. reduces its own rows into a partial g (B*L floats) and adds that to a
//      global accumulator with fire-and-forget atomics;
//   2. meets the other CTAs at one grid-wide barrier;
//   3. reads the finished g and computes the prox redundantly (every CTA
//      computes the same x' from the same g; CTA j % G stores it);
//   4. updates its own residual rows from the tile it already holds.
// A is read from device memory once per sweep: the (B, ms) tiles of the
// next blocks, with their x, keep-mask, weight and step operands, are
// copied into a ring of shared-memory stages with cp.async while the
// current block waits at its barrier.  The g accumulator is a
// ring of three buffers (written at block j, read after barrier j, zeroed by
// CTA 0 during block j + 2 before barrier j + 2), so one barrier per block
// suffices.  The atomics make the order of the cross-CTA f32 sum vary from
// run to run; the tests state their tolerances for that.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStages = 8;
constexpr int kMaxBatch = 16;
constexpr int kCounterWords = 64;  // scratch words before the g ring

enum Kind : int { kL1 = 0, kNonnegL1 = 1, kGroupL2 = 2 };

struct Params {
  const float* A_t;    // (nb, B, m)
  const float* X;      // (nb, L, B)
  const float* R;      // (L, m)
  const float* steps;  // (nb,)  step_scale / (L_j + lam2)
  const float* lam1s;  // (L,)
  const float* lam2;   // (1,)
  const float* w;      // (nb, B / gsize) group weights (group_l2 only)
  const float* mask;   // (nb, B) keep mask, 0 or 1
  const float* rm;     // (m,) row mask, or nullptr
  float* X_out;        // (nb, L, B)
  float* R_out;        // (L, m)
  unsigned* counter;   // barrier arrivals
  float* gbuf;         // 3 * L * B
  int nb, B, m, L, kind, gsize;
  int ms;              // rows per CTA
  int rs;              // shared row stride of a tile (odd: no bank conflicts)
  int stages;
  int k1, k2;          // split factors of the two block reductions
  int red_n;           // floats in the split-reduction scratch
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 4 : 0;  // 0 source bytes: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp.async.wait_group takes an immediate; the stage count is a launch
// parameter, so dispatch over the few values it can take.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void arrive_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every CTA arrives once per block; block j's barrier opens at G * (j + 1).
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    arrive_release(counter);
    while (load_acquire(counter) < target) {
    }
  }
  __syncthreads();
}

// Stage layout: the (B, rs) tile, then x_j (L*B), the keep mask (B), the
// group weights (gpb) and the step (padded to 4 floats).
__device__ __forceinline__ int stage_floats(const Params& p, int gpb) {
  return p.B * p.rs + p.L * p.B + p.B + gpb + 4;
}

__device__ __forceinline__ void load_stage(const Params& p, float* stage,
                                           int jb, int row0, int rows,
                                           int gpb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* src0 = p.A_t + static_cast<size_t>(jb) * p.B * p.m + row0;
  for (int b = warp; b < p.B; b += kThreads / 32) {
    const float* src = src0 + static_cast<size_t>(b) * p.m;
    float* dst = stage + b * p.rs;
    for (int i = lane; i < p.ms; i += 32) {
      const bool ok = i < rows;
      cp_async4(dst + i, ok ? src + i : p.A_t, ok);
    }
  }
  const int LB = p.L * p.B;
  float* xs = stage + p.B * p.rs;
  float* ks = xs + LB;
  float* ws = ks + p.B;
  float* st = ws + gpb;
  for (int o = threadIdx.x; o < LB; o += kThreads)
    cp_async4(xs + o, p.X + static_cast<size_t>(jb) * LB + o, true);
  for (int b = threadIdx.x; b < p.B; b += kThreads)
    cp_async4(ks + b, p.mask + static_cast<size_t>(jb) * p.B + b, true);
  for (int q = threadIdx.x; q < gpb; q += kThreads)
    cp_async4(ws + q, p.w + static_cast<size_t>(jb) * gpb + q, true);
  if (threadIdx.x == 0) cp_async4(st, p.steps + jb, true);
}

__global__ void __launch_bounds__(kThreads, 1) bcd_sweep_kernel(Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int B = p.B, L = p.L, ms = p.ms, rs = p.rs, m = p.m;
  const int LB = L * B;
  const int row0 = c * ms;
  const int rows = max(0, min(ms, m - row0));
  const int S = p.stages;
  const int gpb = (p.kind == kGroupL2) ? B / p.gsize : 0;
  const int stage = stage_floats(p, gpb);

  float* A_s = smem;              // S * stage
  float* r_s = A_s + S * stage;   // L * ms   this CTA's residual rows
  float* rm_s = r_s + L * ms;     // ms       row mask
  float* red = rm_s + ms;         // red_n    split-reduction scratch
  float* v_s = red + p.red_n;     // LB       prox input (group_l2)
  float* d_s = v_s + LB;          // LB       x_j' - x_j
  float* l_s = d_s + LB;          // L        lam1 per problem
  float* sc_s = l_s + L;          // L * gpb  group scales

  for (int e = tid; e < L * ms; e += kThreads) {
    const int l = e / ms, i = e - (e / ms) * ms;
    r_s[e] = (i < rows) ? p.R[static_cast<size_t>(l) * m + row0 + i] : 0.f;
  }
  for (int i = tid; i < ms; i += kThreads)
    rm_s[i] = (p.rm == nullptr) ? 1.f : ((i < rows) ? p.rm[row0 + i] : 0.f);
  for (int l = tid; l < L; l += kThreads) l_s[l] = p.lam1s[l];
  const float lam2 = p.lam2[0];

  for (int s = 0; s < S - 1; ++s) {
    if (s < p.nb) load_stage(p, A_s + s * stage, s, row0, rows, gpb);
    cp_async_commit();
  }

  for (int j = 0; j < p.nb; ++j) {
    const int jn = j + S - 1;
    if (jn < p.nb) load_stage(p, A_s + (jn % S) * stage, jn, row0, rows, gpb);
    cp_async_commit();
    cp_async_wait(S - 1);
    __syncthreads();
    const float* At = A_s + (j % S) * stage;
    const float* x_s = At + B * rs;  // x_j before the update
    const float* k_s = x_s + LB;     // keep mask of block j
    const float* w_s = k_s + B;      // group weights of block j
    const float step = w_s[gpb];
    float* gb = p.gbuf + static_cast<size_t>(j % 3) * LB;

    // ---- phase 1: partial g over this CTA's rows -> global atomics ----
    {
      const int k1 = p.k1;
      const int chunk = (ms + k1 - 1) / k1;
      for (int t = tid; t < k1 * LB; t += kThreads) {
        const int o = t % LB, k = t / LB;
        const int l = o / B, b = o - (o / B) * B;
        const int ia = k * chunk, ib = min(ms, ia + chunk);
        const float* a = At + b * rs;
        const float* rr = r_s + l * ms;
        float s = 0.f;
        for (int i = ia; i < ib; ++i) s = fmaf(a[i], rr[i], s);
        if (k1 == 1)
          atomicAdd(gb + o, s);
        else
          red[t] = s;
      }
      if (k1 > 1) {
        __syncthreads();
        for (int o = tid; o < LB; o += kThreads) {
          float s = 0.f;
          for (int k = 0; k < k1; ++k) s += red[k * LB + o];
          atomicAdd(gb + o, s);
        }
      }
    }
    if (c == 0) {
      float* gz = p.gbuf + static_cast<size_t>((j + 1) % 3) * LB;
      for (int o = tid; o < LB; o += kThreads) gz[o] = 0.f;
    }

    grid_barrier(p.counter, static_cast<unsigned>(G) * (j + 1));

    // ---- prox, computed redundantly by every CTA ----
    const bool writer = (j % G) == c;
    float* xo = p.X_out + static_cast<size_t>(j) * LB;
    for (int o = tid; o < LB; o += kThreads) {
      const int l = o / B, b = o - (o / B) * B;
      const float xj = x_s[o];
      const float g = __ldcg(gb + o) + lam2 * xj;
      const float v = xj - step * g;
      const float tl = step * l_s[l];
      float xn;
      if (p.kind == kL1) {
        xn = copysignf(fmaxf(fabsf(v) - tl, 0.f), v);
      } else if (p.kind == kNonnegL1) {
        xn = fmaxf(v - tl, 0.f);
      } else {
        v_s[o] = v;
        continue;
      }
      xn = (k_s[b] > 0.f) ? xn : 0.f;
      d_s[o] = xn - xj;
      if (writer) xo[o] = xn;
    }
    if (p.kind == kGroupL2) {
      __syncthreads();
      const int warp = tid / 32, lane = tid % 32;
      for (int u = warp; u < L * gpb; u += kThreads / 32) {
        const int l = u / gpb, q = u - (u / gpb) * gpb;
        const float* vv = v_s + l * B + q * p.gsize;
        float s = 0.f;
        for (int e = lane; e < p.gsize; e += 32) s = fmaf(vv[e], vv[e], s);
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) {
          const float tl = step * l_s[l];
          sc_s[u] = fmaxf(0.f, 1.f - tl * w_s[q] / fmaxf(sqrtf(s), 1e-30f));
        }
      }
      __syncthreads();
      for (int o = tid; o < LB; o += kThreads) {
        const int l = o / B, b = o - (o / B) * B;
        float xn = v_s[o] * sc_s[l * gpb + b / p.gsize];
        xn = (k_s[b] > 0.f) ? xn : 0.f;
        d_s[o] = xn - x_s[o];
        if (writer) xo[o] = xn;
      }
    }
    __syncthreads();

    // ---- phase 2: r_l += rm * A_j dx_l on this CTA's rows ----
    {
      const int k2 = p.k2;
      const int o2 = L * ms;
      const int chunk = (B + k2 - 1) / k2;
      for (int t = tid; t < k2 * o2; t += kThreads) {
        const int o = t % o2, k = t / o2;
        const int l = o / ms, i = o - (o / ms) * ms;
        const int ba = k * chunk, bb = min(B, ba + chunk);
        const float* dd = d_s + l * B;
        float s = 0.f;
        for (int b = ba; b < bb; ++b) s = fmaf(At[b * rs + i], dd[b], s);
        if (k2 == 1)
          r_s[o] += rm_s[i] * s;
        else
          red[t] = s;
      }
      if (k2 > 1) {
        __syncthreads();
        for (int o = tid; o < o2; o += kThreads) {
          float s = 0.f;
          for (int k = 0; k < k2; ++k) s += red[k * o2 + o];
          r_s[o] += rm_s[o % ms] * s;
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < L * ms; e += kThreads) {
    const int l = e / ms, i = e - (e / ms) * ms;
    if (i < rows) p.R_out[static_cast<size_t>(l) * m + row0 + i] = r_s[e];
  }
}

struct Plan {
  int grid, ms, rs, stages, k1, k2, red_n;
  size_t smem_bytes;
};

// Shared-memory plan of one launch; ops/cuda_sweep.py mirrors it to decide
// eligibility before tracing.
bool MakePlan(int sms, int smem_limit, int B, int m, int L, int gsize,
              bool group, Plan* plan) {
  int ms = (m + sms - 1) / sms;
  ms = (ms + 7) / 8 * 8;  // whole 32-byte sectors per row segment
  const int LB = L * B;
  const int gpb = group ? B / gsize : 0;
  plan->ms = ms;
  plan->grid = (m + ms - 1) / ms;
  plan->rs = ms + 1;
  plan->k1 = LB >= kThreads ? 1 : kThreads / LB;
  plan->k2 = L * ms >= kThreads ? 1 : kThreads / (L * ms);
  int red_n = kThreads;
  if (LB > red_n) red_n = LB;
  if (L * ms > red_n) red_n = L * ms;
  plan->red_n = red_n;
  const size_t fixed = static_cast<size_t>(L) * ms + ms + red_n + 2 * LB +
                       L + static_cast<size_t>(L) * gpb;
  const size_t tile =
      static_cast<size_t>(B) * plan->rs + LB + B + gpb + 4;  // one stage
  const size_t avail = static_cast<size_t>(smem_limit) / 4;
  // one stage still works (the next tile's load then waits for the block
  // to finish); wide tiles are bandwidth-bound anyway
  if (avail < fixed + tile) return false;
  size_t st = (avail - fixed) / tile;
  if (st > kMaxStages) st = kMaxStages;
  plan->stages = static_cast<int>(st);
  plan->smem_bytes = (fixed + st * tile) * 4;
  return true;
}

ffi::Error SweepImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> A_t,
                     ffi::Buffer<ffi::F32> X, ffi::Buffer<ffi::F32> R,
                     ffi::Buffer<ffi::F32> steps, ffi::Buffer<ffi::F32> lam1s,
                     ffi::Buffer<ffi::F32> lam2, ffi::Buffer<ffi::F32> w,
                     ffi::Buffer<ffi::F32> mask, ffi::Buffer<ffi::F32> rm,
                     ffi::ResultBuffer<ffi::F32> X_out,
                     ffi::ResultBuffer<ffi::F32> R_out,
                     ffi::ResultBuffer<ffi::U32> scratch, int32_t kind,
                     int32_t gsize, int32_t masked) {
  auto ad = A_t.dimensions();
  auto xd = X.dimensions();
  if (ad.size() != 3 || xd.size() != 3)
    return ffi::Error::InvalidArgument("A_t and X must be rank 3");
  const int nb = static_cast<int>(ad[0]), B = static_cast<int>(ad[1]),
            m = static_cast<int>(ad[2]), L = static_cast<int>(xd[1]);
  if (xd[0] != nb || xd[2] != B || L < 1 || L > kMaxBatch)
    return ffi::Error::InvalidArgument("X must be (nb, L, B), 1 <= L <= 16");
  if (kind == kGroupL2 && (gsize <= 0 || B % gsize != 0))
    return ffi::Error::InvalidArgument("block must hold whole groups");
  const size_t need = kCounterWords + 3 * static_cast<size_t>(L) * B;
  if (scratch->element_count() < need)
    return ffi::Error::InvalidArgument("scratch too small");

  int dev = 0, sms = 0, smem_limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  Plan plan;
  if (!MakePlan(sms, smem_limit, B, m, L, gsize, kind == kGroupL2, &plan))
    return ffi::Error::InvalidArgument("tile does not fit shared memory");

  cudaError_t err = cudaFuncSetAttribute(
      bcd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem_bytes));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bcd_sweep_kernel, kThreads, plan.smem_bytes);
  if (per_sm < 1 || plan.grid > per_sm * sms)
    return ffi::Error::Internal("sweep grid cannot be co-resident");

  err = cudaMemsetAsync(scratch->typed_data(), 0, need * sizeof(uint32_t),
                        stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));

  Params p;
  p.A_t = A_t.typed_data();
  p.X = X.typed_data();
  p.R = R.typed_data();
  p.steps = steps.typed_data();
  p.lam1s = lam1s.typed_data();
  p.lam2 = lam2.typed_data();
  p.w = w.typed_data();
  p.mask = mask.typed_data();
  p.rm = masked ? rm.typed_data() : nullptr;
  p.X_out = X_out->typed_data();
  p.R_out = R_out->typed_data();
  p.counter = scratch->typed_data();
  p.gbuf = reinterpret_cast<float*>(scratch->typed_data() + kCounterWords);
  p.nb = nb;
  p.B = B;
  p.m = m;
  p.L = L;
  p.kind = kind;
  p.gsize = gsize;
  p.ms = plan.ms;
  p.rs = plan.rs;
  p.stages = plan.stages;
  p.k1 = plan.k1;
  p.k2 = plan.k2;
  p.red_n = plan.red_n;

  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(bcd_sweep_kernel),
                                    dim3(plan.grid), dim3(kThreads), args,
                                    plan.smem_bytes, stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CoBcdSweep, SweepImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // A_t
                                  .Arg<ffi::Buffer<ffi::F32>>()  // X
                                  .Arg<ffi::Buffer<ffi::F32>>()  // R
                                  .Arg<ffi::Buffer<ffi::F32>>()  // steps
                                  .Arg<ffi::Buffer<ffi::F32>>()  // lam1s
                                  .Arg<ffi::Buffer<ffi::F32>>()  // lam2
                                  .Arg<ffi::Buffer<ffi::F32>>()  // weights
                                  .Arg<ffi::Buffer<ffi::F32>>()  // keep mask
                                  .Arg<ffi::Buffer<ffi::F32>>()  // row mask
                                  .Ret<ffi::Buffer<ffi::F32>>()  // X out
                                  .Ret<ffi::Buffer<ffi::F32>>()  // R out
                                  .Ret<ffi::Buffer<ffi::U32>>()  // scratch
                                  .Attr<int32_t>("kind")
                                  .Attr<int32_t>("gsize")
                                  .Attr<int32_t>("masked"));
