// GroupNorm(+SiLU) over channels-last activations for Hopper (sm_90a),
// replacing the TPU kernel hedit_tpu/ops/groupnorm.py:100 _gn_kernel
// (entry point hedit_group_norm_nhwc, wrapper ops/groupnorm.py:group_norm_cuda):
//
//   y = SiLU?((x - mean_g) * rsqrt(var_g + eps) * w + b)
//
// over each (image, group) of x, physically [B, HW, C] (a logical NCHW
// tensor in torch.channels_last, as the TPU kernel's blocks are [HW, C]).
// Statistics in float32, two-pass: the mean first, then the mean of the
// squares centred on it (never E[x^2] - E[x]^2, which breaks the 50-step
// identities at 1e-3); the output rounded once to x's dtype.  Every sum runs
// in a fixed order, with no atomics: two launches give the same bits.
//
// What bounds it: about ten float32 operations an element against 2 bytes
// (bf16) or 4 read and as many written, so device memory (3.35 TB/s): the
// least traffic is x read once and y written once.  The design keeps the
// traffic at that wherever the data fits on chip:
//
// * Loads follow the layout.  A CTA's tile is `pixels` consecutive pixels x
//   a block of whole groups (`cb` channels, cb * elt a multiple of 16 bytes,
//   at least 128 bytes where C allows); each thread owns one 16-byte column
//   of the block (8 bf16 or 4 float32 channels) and every lanes-th pixel, so
//   its channels and groups are fixed over the pixel loop: its partial sums
//   live in registers, no element does a run-time division, and w and b are
//   loaded once a thread.
// * Resident regime (apply_pixels == 0): the `cluster` CTAs of a thread-block
//   cluster split one (image, group block) over its pixels, each copying its
//   slice into shared memory with 16-byte cp.async.  Each CTA sums its slice
//   per group, the sums cross the cluster through distributed shared memory
//   (map_shared_rank, in rank order, so every CTA gets the same bits), the
//   centred squares are taken from the shared copy and cross the cluster
//   the same way, and the CTA normalises and stores from shared memory: x is
//   read from device memory once and y written once.
// * Streamed regime (apply_pixels > 0), where an (image, group block) with
//   rows of >= 128 bytes does not fit 16 CTAs of <= 112 KB (the VAE's
//   layers from 128^2 at 512 channels up): the same slice kernel over whole
//   rows (all C channels) writes, for each cluster's span of 4 slices, its
//   (mean - pilot, M2) per group, exactly two-pass through the cluster as
//   above; an apply kernel combines an image's spans by Chan's formula in
//   span order (chunks of consecutive spans, then the chunks, in order) and
//   streams x again to normalise it: x is read twice, 1.5x the traffic of
//   the bound.
// * Every first pass sums x - pilot_g, where pilot_g is the group's first
//   element (pixel 0, its first channel): the sums then stay near the
//   spread of the data, not its offset, so the float32 mean of x = 1e3 +
//   N(0, 1) is within rounding of the exact one.  The variance is unchanged
//   by the shift; the partials keep their means relative to the pilot.
// * A cluster of one CTA (small images) skips the cluster barriers.
//
// Tiles and clusters (ops/groupnorm.py:plan chooses, by a rule taken from a
// sweep of tiles on the H100; bf16): the smallest group block whose rows
// are >= 128 bytes, the fewest CTAs of <= 112 KB of shared memory (two an
// SM), a small grid's clusters of more than one CTA grown to ~3/4 of the
// SMs (a cluster exchange costs ~1.5 us, so one CTA is not grown).
//
//   shape              regime     cb x pixels  cluster  CTAs        why
//   [8,320,64,64]      resident   80 x 586      7        224        2.6 MB an image, 4 blocks of 160-byte rows:
//                                                                   32 clusters of 7, as many as the card runs at once
//   [2,320,64,64]      resident   80 x 316     13        104        the same block, clusters grown
//   [8,960,64,64]      resident  120 x 373     11        704        7.9 MB an image, 8 blocks of 240-byte rows
//   [8,640,64,64]      resident   80 x 586      7        448        8 blocks of 160-byte rows
//   [8,1920,32,32]     resident  120 x 342      3        384        16 blocks of 240-byte rows
//   [8,1280,8,8]       resident   80 x 64       1        128        164 KB an image: latency-bound, one CTA a
//   [8,2560,8,8]       resident   80 x 64       1        256        block, no cluster barrier
//   [2,512,64,64]      resident   64 x 586      7        112        8 blocks of 128-byte rows
//   [2,256,256,256]    streamed  256 x 200      4   656 + 128       33.6 MB an image: 82 spans an image
//   [2,128,512,512]    streamed  128 x 400      4  1312 + 128       67.1 MB an image: 164 spans an image

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxGroups = 128;  // the apply kernel's statistics in static shared memory
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may use

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// 16 bytes of a row: 8 bf16 or 4 float32 channels, unpacked to float32
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void two(unsigned u, float* f) {
    f[0] = __uint_as_float(u << 16);          // the element at the lower address
    f[1] = __uint_as_float(u & 0xffff0000u);
  }
  __device__ __forceinline__ static unsigned round2(float a, float b) {
    return unsigned(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
           (unsigned(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    two(r.x, f);
    two(r.y, f + 2);
    two(r.z, f + 4);
    two(r.w, f + 6);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(round2(f[0], f[1]), round2(f[2], f[3]), round2(f[4], f[5]),
                      round2(f[6], f[7]));
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  float2* part;      // streamed: [B, spans, G] (mean - pilot, M2) of each span
  int hw, c, cpg;     // pixels an image, channels, channels a group
  int cb;             // channels a CTA (whole groups)
  int pixels;         // pixels a slice CTA
  int apply_pixels;   // pixels an apply CTA; 0 in the resident regime
  float eps;
  int silu;
};

// Shared memory of a slice CTA: the slice, the lane partials, and four
// values a group (sums, centred sums, mean, rstd).
__host__ __device__ __forceinline__ int slice_smem(int pixels, int cb, int elt, int lanes,
                                                   int cpg) {
  return align16(pixels * cb * elt) + 4 * lanes * cb + 16 * (cb / cpg);
}

// Per-group sums of the CTA's thread partials: acc[V] of each thread's
// column into red[lanes][cb], the lanes summed in order per channel, then a
// warp a group: its 32 threads sum the group's channels 32 apart, in order,
// and a shuffle tree of fixed shape adds the 32 sums into out[gb].
template <int V>
__device__ __forceinline__ void group_sums(const float* acc, float* red, float* out, int cb,
                                           int cpg, int lanes, int col, int lane) {
  float4* dst = reinterpret_cast<float4*>(red + lane * cb + col * V);
#pragma unroll
  for (int j = 0; j < V / 4; ++j) dst[j] = make_float4(acc[4 * j], acc[4 * j + 1],
                                                       acc[4 * j + 2], acc[4 * j + 3]);
  __syncthreads();
  for (int c = threadIdx.x; c < cb; c += blockDim.x) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[l * cb + c];
    red[c] = s;  // only this thread touches column c
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32, warps = blockDim.x / 32;
  if (warps == 0) {  // fewer than 32 threads: a thread a group
    for (int g = threadIdx.x; g < cb / cpg; g += blockDim.x) {
      float s = 0.f;
      for (int k = 0; k < cpg; ++k) s += red[g * cpg + k];
      out[g] = s;
    }
  } else if (warp < warps) {  // whole warps only
    for (int g = warp; g < cb / cpg; g += warps) {
      float s = 0.f;
      for (int k = wl; k < cpg; k += 32) s += red[g * cpg + k];
#pragma unroll
      for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (wl == 0) out[g] = s;
    }
  }
  __syncthreads();
}

enum Mode { kResident = 0, kPartials = 1 };

// The sum over the cluster's ranks, in rank order, of element g of a shared
// array (this CTA's own in a cluster of one): every rank's load issued
// before the first add.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* p, int g,
                                             int ranks) {
  if (ranks == 1) return p[g];
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < ranks ? cluster.map_shared_rank(p, r)[g] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < ranks) s += v[r];
  return s;
}

// grid (spans x cluster, C / cb, B), clusters of (cluster, 1, 1): the CTAs
// of a cluster take consecutive slices of `pixels` pixels, the cluster's
// span.  Resident: one span covers the image; partials: an image has many.
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads, 2) gn_slice_kernel(Args a) {
  using P = Pack<T>;
  constexpr int V = P::N;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int cb = a.cb, cpg = a.cpg, gb = cb / cpg;
  const int vc = cb / V, lanes = blockDim.x / vc;
  const int col = threadIdx.x % vc, lane = threadIdx.x / vc;
  const int c0 = blockIdx.y * cb, img = blockIdx.z;
  const int span = ranks * a.pixels, sp = blockIdx.x / ranks;  // the cluster's span
  const int q0 = sp * span, p0 = q0 + rank * a.pixels;
  const int np = max(0, min(a.pixels, a.hw - p0));
  const float count = float(min(span, a.hw - q0)) * float(cpg);  // the cluster's elements a group

  T* sx = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(a.pixels * cb * int(sizeof(T))));
  float* gsum = red + lanes * cb;
  float* gm2 = gsum + gb;
  float* gmean = gm2 + gb;
  float* gaux = gmean + gb;  // the cluster's mean - pilot, then (resident) rstd

  const T* ximg = static_cast<const T*>(a.x) + size_t(img) * a.hw * a.c;
  const T* xcol = ximg + size_t(p0) * a.c + c0 + col * V;
  T* scol = sx + col * V;
  for (int p = lane; p < np; p += lanes) cp_async16(scol + p * cb, xcol + size_t(p) * a.c);

  // while the copies fly: this thread's weights, groups (one division each)
  // and pilots
  const uint4 wraw = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.w) + c0 + col * V);
  const uint4 braw = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.b) + c0 + col * V);
  int lg[V];
  float pilot[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    lg[j] = (col * V + j) / cpg;
    pilot[j] = P::one(ximg + c0 + lg[j] * cpg);
  }
  cp_async_wait_all();  // this thread reads only what it copied

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int p = lane; p < np; p += lanes) {
    float f[V];
    P::unpack(*reinterpret_cast<const uint4*>(scol + p * cb), f);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += f[j] - pilot[j];
  }
  group_sums<V>(acc, red, gsum, cb, cpg, lanes, col, lane);
  // a cluster of one CTA reads its own shared memory and needs no cluster
  // barrier: group_sums ends with __syncthreads
  if (ranks > 1) cluster.sync();  // every CTA's sums are written
  for (int g = threadIdx.x; g < gb; g += blockDim.x) {
    gaux[g] = cluster_sum(cluster, gsum, g, ranks) / count;
    gmean[g] = P::one(ximg + c0 + g * cpg) + gaux[g];
  }
  __syncthreads();

  float mean[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = gmean[lg[j]];
    acc[j] = 0.f;
  }
  for (int p = lane; p < np; p += lanes) {
    float f[V];
    P::unpack(*reinterpret_cast<const uint4*>(scol + p * cb), f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = f[j] - mean[j];
      acc[j] += d * d;
    }
  }
  group_sums<V>(acc, red, gm2, cb, cpg, lanes, col, lane);
  if (ranks > 1) cluster.sync();  // every CTA's centred sums are written
  if (MODE == kPartials) {
    if (rank == 0) {
      float2* out = a.part + (size_t(img) * (gridDim.x / ranks) + sp) * (a.c / cpg) + c0 / cpg;
      for (int g = threadIdx.x; g < gb; g += blockDim.x)
        out[g] = make_float2(gaux[g], cluster_sum(cluster, gm2, g, ranks));
    }
    if (ranks > 1) cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
    return;
  }
  for (int g = threadIdx.x; g < gb; g += blockDim.x)
    gaux[g] = rsqrtf(cluster_sum(cluster, gm2, g, ranks) / count + a.eps);
  // the last reads of the peers' shared memory are done: arrive now, wait
  // before exiting, so no CTA leaves while a peer may still read it
  if (ranks > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  float rstd[V], wj[V], bj[V];
  P::unpack(wraw, wj);
  P::unpack(braw, bj);
#pragma unroll
  for (int j = 0; j < V; ++j) rstd[j] = gaux[lg[j]];
  T* ycol = static_cast<T*>(a.y) + size_t(img) * a.hw * a.c + size_t(p0) * a.c + c0 + col * V;
  for (int p = lane; p < np; p += lanes) {
    float f[V];
    P::unpack(*reinterpret_cast<const uint4*>(scol + p * cb), f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = (f[j] - mean[j]) * rstd[j] * wj[j] + bj[j];
      if (a.silu) v = __fdividef(v, 1.f + __expf(-v));
      f[j] = v;
    }
    *reinterpret_cast<uint4*>(ycol + size_t(p) * a.c) = P::pack(f);
  }
  if (ranks > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Chan's combination of (n, mean, M2) with (nb, mb, M2b)
__device__ __forceinline__ void chan(float& n, float& m, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb, m = mb, m2 = m2b;
    return;
  }
  const float nn = n + nb, d = mb - m;
  m = m + d * (nb / nn);
  m2 = m2 + m2b + d * d * (n * nb / nn);
  n = nn;
}

// grid (ceil(HW / apply_pixels), B); whole rows, `lanes` pixels at a time.
// `spans` partials an image, one a span of `span` pixels (the last shorter).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) gn_apply_kernel(Args a, int spans, int span) {
  using P = Pack<T>;
  constexpr int V = P::N;
  __shared__ float4 chunk[kMaxThreads];
  __shared__ float smean[kMaxGroups], srstd[kMaxGroups];
  const int img = blockIdx.y, groups = a.c / a.cpg;
  const T* ximg = static_cast<const T*>(a.x) + size_t(img) * a.hw * a.c;

  // the image's statistics: chunk k folds spans [k S / K, (k+1) S / K) in
  // order, then one thread a group folds the chunks in order
  const int chunks = blockDim.x / groups;
  if (int(threadIdx.x) < chunks * groups) {
    const int g = threadIdx.x % groups, k = threadIdx.x / groups;
    float n = 0.f, m = 0.f, m2 = 0.f;
    const float2* part = a.part + size_t(img) * spans * groups + g;
    for (int s = k * spans / chunks; s < (k + 1) * spans / chunks; ++s) {
      const float2 v = part[size_t(s) * groups];
      chan(n, m, m2, float(min(span, a.hw - s * span)) * float(a.cpg), v.x, v.y);
    }
    chunk[threadIdx.x] = make_float4(n, m, m2, 0.f);
  }
  __syncthreads();
  if (int(threadIdx.x) < groups) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float4 v = chunk[k * groups + threadIdx.x];
      chan(n, m, m2, v.x, v.y, v.z);
    }
    smean[threadIdx.x] = P::one(ximg + threadIdx.x * a.cpg) + m;
    srstd[threadIdx.x] = rsqrtf(m2 / n + a.eps);
  }
  __syncthreads();

  const int vc = a.c / V, lanes = blockDim.x / vc;
  const int col = threadIdx.x % vc, lane = threadIdx.x / vc;
  float mean[V], rstd[V], wj[V], bj[V];
  P::unpack(*reinterpret_cast<const uint4*>(static_cast<const T*>(a.w) + col * V), wj);
  P::unpack(*reinterpret_cast<const uint4*>(static_cast<const T*>(a.b) + col * V), bj);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int g = (col * V + j) / a.cpg;
    mean[j] = smean[g];
    rstd[j] = srstd[g];
  }
  const int p0 = blockIdx.x * a.apply_pixels;
  const int np = max(0, min(a.apply_pixels, a.hw - p0));
  const uint4* xcol = reinterpret_cast<const uint4*>(ximg + size_t(p0) * a.c + col * V);
  uint4* ycol = reinterpret_cast<uint4*>(static_cast<T*>(a.y) + size_t(img) * a.hw * a.c +
                                         size_t(p0) * a.c + col * V);
  const size_t row = size_t(a.c) / V;  // a pixel's row in 16-byte units
  constexpr int kUnroll = 4;
  for (int p = lane; p < np; p += kUnroll * lanes) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * lanes < np) r[u] = __ldcs(xcol + size_t(p + u * lanes) * row);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * lanes < np) {
        float f[V];
        P::unpack(r[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = (f[j] - mean[j]) * rstd[j] * wj[j] + bj[j];
          if (a.silu) v = __fdividef(v, 1.f + __expf(-v));
          f[j] = v;
        }
        __stcs(ycol + size_t(p + u * lanes) * row, P::pack(f));
      }
    }
  }
}

template <typename T>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaSuccess;
  for (const void* k : {(const void*)gn_slice_kernel<T, kResident>,
                        (const void*)gn_slice_kernel<T, kPartials>}) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  done = e == cudaSuccess;
  return e;
}

// The shared memory of a slice CTA of this tile, or -1 for a tile the
// kernels do not take.
int check_tile(int hw, int c, int groups, int cb, int pixels, int threads, int elt) {
  if (hw < 1 || c < 1 || groups < 1 || c % groups || cb < 1 || c % cb || pixels < 1) return -1;
  const int cpg = c / groups, vc = cb * elt / 16;
  if (cb % cpg || (cb * elt) % 16 || threads < 1 || threads > kMaxThreads || threads % vc)
    return -1;
  if ((long long)pixels * cb * elt > kSmemLimit) return -1;
  const int smem = slice_smem(pixels, cb, elt, threads / vc, cpg);
  return smem > kSmemLimit ? -1 : smem;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem, int cluster,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t launch(const Args& a, int batch, int groups, int cluster, int threads,
                   int apply_threads, cudaStream_t stream) {
  const int elt = int(sizeof(T));
  const int smem = check_tile(a.hw, a.c, groups, a.cb, a.pixels, threads, elt);
  if (smem < 0 || batch < 1 || batch > 65535 || cluster < 1 || cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  cudaError_t e = configure<T>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  if (a.apply_pixels == 0) {  // resident: one cluster an (image, group block)
    if ((long long)cluster * a.pixels < a.hw) return cudaErrorInvalidValue;
    const cudaLaunchConfig_t cfg = cluster_config(dim3(cluster, a.c / a.cb, batch), threads,
                                                  smem, cluster, stream, &attr);
    e = cudaLaunchKernelEx(&cfg, gn_slice_kernel<T, kResident>, a);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  // streamed: whole rows, one partial a cluster's span
  const int span = cluster * a.pixels, spans = (a.hw + span - 1) / span;
  if (a.cb != a.c || groups > kMaxGroups || a.part == nullptr || a.apply_pixels < 1 ||
      apply_threads < groups || apply_threads > kMaxThreads || apply_threads % (a.c * elt / 16))
    return cudaErrorInvalidValue;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(spans * cluster, 1, batch), threads, smem,
                                                cluster, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, gn_slice_kernel<T, kPartials>, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int ctas = (a.hw + a.apply_pixels - 1) / a.apply_pixels;
  gn_apply_kernel<T><<<dim3(ctas, batch), apply_threads, 0, stream>>>(a, spans, span);
  return cudaGetLastError();
}

}  // namespace

// x, w, b, y: x and y [B, HW, C] (channels last), w and b [C], all of one
// dtype (0 float32, 1 bfloat16), 16-byte aligned.  The tile (cb, cluster,
// pixels, threads) comes from ops/groupnorm.py:plan.  apply_pixels 0: the
// resident regime; else the streamed one, whose partials `part` are float32
// [B, ceil(HW / (cluster * pixels)), groups, 2] and whose apply kernel takes
// apply_pixels pixels with apply_threads threads a CTA.  Returns a
// cudaError_t (0 on success).
extern "C" int hedit_group_norm_nhwc(const void* x, const void* w, const void* b, void* y,
                                     void* part, int batch, int hw, int c, int groups, int cb,
                                     int cluster, int pixels, int threads, int apply_pixels,
                                     int apply_threads, float eps, int silu, int dtype,
                                     void* stream) {
  if (groups < 1 || c % groups || apply_pixels < 0) return int(cudaErrorInvalidValue);
  const Args a{x, w, b, y, static_cast<float2*>(part), hw, c, c / groups, cb, pixels,
               apply_pixels, eps, silu};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch<float>(a, batch, groups, cluster, threads, apply_threads, s));
  if (dtype == 1)
    return int(launch<__nv_bfloat16>(a, batch, groups, cluster, threads, apply_threads, s));
  return int(cudaErrorInvalidValue);
}

// How many clusters of the slice kernel the card runs at once for one tile
// (cudaOccupancyMaxActiveClusters), into *out; returns a cudaError_t.
extern "C" int hedit_group_norm_active_clusters(int hw, int c, int groups, int cb, int cluster,
                                                int pixels, int threads, int dtype, int* out) {
  const int elt = dtype == 0 ? 4 : 2;
  const int smem = check_tile(hw, c, groups, cb, pixels, threads, elt);
  if (smem < 0 || cluster < 1 || cluster > kMaxCluster || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaError_t e = dtype == 0 ? configure<float>() : configure<__nv_bfloat16>();
  if (e != cudaSuccess) return int(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cluster), threads, smem, cluster, nullptr,
                                                &attr);
  return int(dtype == 0
                 ? cudaOccupancyMaxActiveClusters(out, gn_slice_kernel<float, kResident>, &cfg)
                 : cudaOccupancyMaxActiveClusters(out, gn_slice_kernel<__nv_bfloat16, kResident>,
                                                  &cfg));
}
