// The backward of the grouped product y[r] = x[r] @ w[g(r)] (grouped_matmul.cu)
// for Hopper (sm_90a), bf16 operands, float32 sums, bf16 results:
//   grouped_matmul_dgrad: dx[r, :] = dy[r, :] @ w[g(r)]^T        dx [R, K]
//   grouped_matmul_wgrad: dw[g]    = x[rows of g]^T @ dy[rows of g]  dw [G, K, N]
// x [R, K] with rows sorted by group, dy [R, N], w [G, K, N], offsets [G + 1]
// int32 on the device (group g holds rows [offsets[g], offsets[g + 1])).
//
// Replaces no Pallas kernel: these are the two products of the transpose of
// `jax.lax.ragged_dot(x, w, group_sizes, preferred_element_type=float32)`
// that XLA derives for the JAX package's MoE training step
// (maxtext_indextts2_tpu/models/moe.py:268-281, RoutedMoE._sparse_experts
// under jax.value_and_grad). Its jaxpr rounds both results to bf16 after
// float32 sums of exact products, which is what these kernels do. Without
// them the port would loop over the experts with a product each (the group
// sizes read back to the host) or train through the dense einsum route (E / k
// times the products).
//
// What bounds them on this card: at the training shapes (tens of thousands of
// rows over up to 128 experts, a few hundred rows a group) each is 2 R K N
// operations on the tensor cores against the bytes of the experts: dgrad
// reads every touched w[g], wgrad writes all of dw (G K N bf16, empty experts
// as zeros). qwen3-30b-a3b's wi product (R 32,768, K 2048, N 768, 128
// experts): 103 GFLOP (0.104 ms at 989 TFLOP/s) against 587 MB (0.175 ms at
// 3.35 TB/s), so bytes by a little, and the L2 traffic of re-reading a
// group's rows for every output tile close behind.
//
// What the designs do about it (both kernels): one persistent CTA an SM walks
// output tiles in a fixed order (item = blockIdx.x + i gridDim.x).
// Warp-specialised: warpgroup 0 is the producer, whose first warp keeps TMA
// loads in flight into a ring of kStages stages guarded by mbarriers (full:
// the bytes landed; empty: both consumers are done with it); warpgroups 1 and
// 2 are consumers, each running `wgmma.mma_async` m64n256k16 (bf16 ->
// float32) on 64 rows of a 128 x 256 tile of the result from
// 128-byte-swizzled shared memory, with one product group in flight.
// `setmaxnreg` gives the consumers 232 registers (128 of them the float32
// tile) and the producer 40. Since the producer runs ahead of the consumers,
// the next tile's first stages load while the consumers round the current
// tile to bf16, write it to shared memory in the swizzle of the output's
// tensor map and store it with TMA (a [64][128] half at a time; the elected
// thread waits for the previous store to have read its buffer).
// The tensor maps are built on the host per call from the pointers
// (cuTensorMapEncodeTiled from libcuda, looked up with dlsym) and passed
// as __grid_constant__ parameters; TMA fills zeros past R, K and N.
//
// dgrad: an item is (row tile of a group, 256 columns of dx); items run group
// by group and, within a group, column tile by column tile with the group's
// row tiles together, so that the CTAs at work read each 256-row slice of
// w[g] from device memory once and share it in the L2 (an expert of
// mixtral's wo, 117 MB, is larger than the L2: with the columns inner, all of
// w[g] would stream once a row tile). A stage holds dy's rows
// [64 | 128][64 of N] (K-major A) and w[g]'s rows [256 of K][64 of N], loaded
// through a 3-d map over [G, K, N]: N is contiguous in a row of w, so this is
// already wgmma's K-major B operand (no transposed copy of the experts). The
// (group, row tile) of an item comes from `offsets` on the device by a warp
// scan that resumes where the previous item was found. Group edges: a tile
// of 128 rows is two warpgroups of 64; a warpgroup whose 64 rows hold none of
// the group's rows is not loaded, runs no product and stores nothing, so a
// group of a few rows pays for 64 rows (the rule: rows a tile = 128, halved
// where the group's rest is 64 or fewer). A half whose rows run past the
// group's end computes the next group's rows too (TMA loads whatever lies
// there, zeros past R) and does not store them: it goes out with masked
// 16-byte stores from the staged tile, since a TMA store would overwrite the
// next group's dx; a full half goes out by TMA.
//
// wgrad: an item is (group, 128 rows of K, 256 columns of N), items group by
// group, so x's and dy's rows of a group are read from the L2 by all of its
// items after the first: x N/256 times, dy K/128 times. The reduction walks
// the group's rows 64 at a time: a stage holds x's [64 rows][128 of K] and
// dy's [64 rows][256 of N], both MN-major, which wgmma reads with its
// transpose bits (bf16 allows them). The rows of a group's last, partial step
// belong to the next group (or are TMA's zeros past R): the consumer zeroes
// them in its own x box in shared memory (a generic-proxy write, so a
// fence.proxy.async comes before the wgmma reads it). An empty group's items
// run no step and store zeros. Every output goes out by TMA (it clips at K
// and N). Splitting a large group's rows over CTAs is not done: it needs a
// float32 workspace of the partial tiles and a second pass in fixed order
// (no atomics, for the same bits on every launch), and the training shapes'
// groups hold a few hundred rows each, so their items already fill the card
// (6,144 items for qwen3's wi); a group holding all rows still runs its
// K/128 x N/256 items, each over all of its rows.
//
// Every sum runs in a fixed order: two launches give the same bits. Nothing
// is read back to the host.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace gmm_bwd {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kWM = 64;                         // rows of the result a consumer (wgmma's M)
constexpr int kBN = 256;                        // columns of the result a tile (wgmma's N)
constexpr int kBK = 64;                         // the reduction a stage: a 128-byte row
constexpr int kStages = 4;
constexpr int kBox = 64 * 64 * 2;               // one [64][64] bf16 TMA box, 8 KB
constexpr int kABytes = kConsumers * kBox;      // A: a [64][64] box for each consumer
constexpr int kBBytes = kBN * kBK * 2;          // B: 256 x 64
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB
constexpr int kOutBytes = 2 * kBox;             // a consumer's staged [64][128] half tile
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + kConsumers * kOutBytes + 2 * kStages * 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr unsigned kFull = 0xffffffffu;

// ---- PTX wrappers: shared memory, mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0) : "memory");
}
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory (it may be written again)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to the async proxy (TMA, wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of one consumer warpgroup (barrier 1 + consumer)
__device__ __forceinline__ void consumer_sync(int consumer) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + consumer) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across a
// wgmma fence or wait (the hardware writes them asynchronously)
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's shared-memory operand descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all in 16-byte units). K-major
// (a row of 64 bf16 of the reduction, 8-row groups 1024 bytes apart): the
// leading offset is unused, the stride 1024; a step of 16 along the reduction
// adds 32 bytes. MN-major (a row of 64 bf16 of M or N, one row of the
// reduction): the leading offset is the distance between 64-wide blocks of M
// or N (one TMA box, 8 KB), the stride the distance between groups of 8 rows
// of the reduction (1024); a step of 16 along the reduction adds 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
constexpr uint32_t kKMajorLbo = 16, kKMajorSbo = 1024;
constexpr uint32_t kMNMajorLbo = kBox, kMNMajorSbo = 1024;

// d += A B over 16 of the reduction: m64n256k16, bf16 operands from shared
// memory (descriptors), float32 sums in 128 registers a thread; TA / TB: the
// operand is MN-major (transposed) in shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ---- the tile walk and the epilogue

// 128-row tiles of group g
__device__ __forceinline__ int row_tiles(const int* __restrict__ offsets, int g) {
  return (max(0, offsets[g + 1] - offsets[g]) + 2 * kWM - 1) / (2 * kWM);
}

// dgrad's items: group by group, each group's (row tile, column tile) pairs
// with the row tiles inner. The group of item `t` and its index within the
// group, or group -1 past the last; warp-wide (every lane gets the answer).
// `base` and `carry` (32-group chunk, items before it) resume the scan where
// the previous, smaller `t` was found.
__device__ __forceinline__ int find_item(const int* __restrict__ offsets, int groups, int ncol,
                                         int t, int& base, int& carry, int& local) {
  const int lane = threadIdx.x % 32;
  for (; base < groups; base += 32) {
    const int g = base + lane;
    int cnt = 0;
    if (g < groups) cnt = row_tiles(offsets, g) * ncol;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = incl - cnt;
    const unsigned hit = __ballot_sync(kFull, t >= carry + excl && t < carry + incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      local = t - carry - __shfl_sync(kFull, excl, src);
      return base + src;
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  return -1;
}

// columns [128 H, 128 H + 128) of a consumer's [64][256] float32 tile, rounded
// to bf16, into `out`: two [64][64] boxes in the 128-byte swizzle of the
// output's tensor map (16-byte chunk c of row r at chunk c ^ (r % 8)). wgmma's
// accumulator: element 4 j + 2 h + e of a thread is row 16 warp + lane / 4 +
// 8 h, column 8 j + 2 (lane % 4) + e.
template <int H>
__device__ __forceinline__ void stage_half(const float (&d)[128], uint32_t out, int ctid) {
  const int warp = ctid / 32, lane = ctid % 32;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 16 * H + jj;
      const int r = 16 * warp + lane / 4 + 8 * h;
      const int box = jj / 8, chunk = jj % 8;
      st_shared_b32(out + box * kBox + r * 128 + ((chunk ^ (r % 8)) << 4) + (lane % 4) * 4,
                    pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
    }
}

// ---- dgrad

__global__ void __launch_bounds__(kThreads, 1)
dgrad_kernel(const __grid_constant__ CUtensorMap dy_map, const __grid_constant__ CUtensorMap w_map,
             const __grid_constant__ CUtensorMap dx_map, const int* __restrict__ offsets,
             __nv_bfloat16* __restrict__ dx, int rows, int k, int n, int groups) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle wants 1024
  const uint32_t out_base = base + kStages * kStageBytes;
  const uint32_t full_bar = out_base + kConsumers * kOutBytes, empty_bar = full_bar + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ncol = (k + kBN - 1) / kBN, nsteps = (n + kBK - 1) / kBK;
  int stage = 0, phase = 0, scan_base = 0, scan_carry = 0;

  if (threadIdx.x < 128) {  // the producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    const bool elected = threadIdx.x == 0;
    for (int item = blockIdx.x;; item += gridDim.x) {
      int local;
      const int g = find_item(offsets, groups, ncol, item, scan_base, scan_carry, local);
      if (g < 0) break;
      const int tiles = row_tiles(offsets, g);
      const int row0 = offsets[g] + 2 * kWM * (local % tiles), row_end = min(offsets[g + 1], rows);
      const int c0 = (local / tiles) * kBN;
      const bool both = row_end - row0 > kWM;  // the second consumer's 64 rows hold some
      const uint32_t bytes = (both ? 2 : 1) * kBox + kBBytes;
      for (int s = 0; s < nsteps; ++s) {
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
        if (elected) {
          const uint32_t a = base + stage * kStageBytes, bar = full_bar + 8 * stage;
          mbar_expect_tx(bar, bytes);
          tma_load_2d(a, &dy_map, bar, s * kBK, row0);
          if (both) tma_load_2d(a + kBox, &dy_map, bar, s * kBK, row0 + kWM);
          tma_load_3d(a + kABytes, &w_map, bar, s * kBK, c0, g);
        }
        __syncwarp();
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int consumer = threadIdx.x / 128 - 1, ctid = threadIdx.x % 128;
  const uint32_t out = out_base + consumer * kOutBytes;
  float acc[128];
  for (int item = blockIdx.x;; item += gridDim.x) {
    int local;
    const int g = find_item(offsets, groups, ncol, item, scan_base, scan_carry, local);
    if (g < 0) break;
    const int tiles = row_tiles(offsets, g);
    const int row0 = offsets[g] + 2 * kWM * (local % tiles) + kWM * consumer;  // its rows
    const int row_end = min(offsets[g + 1], rows);
    const int c0 = (local / tiles) * kBN;
    const bool active = row0 < row_end;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int s = 0; s < nsteps; ++s) {
      mbar_wait(full_bar + 8 * stage, phase);
      if (active) {
        const uint32_t a = base + stage * kStageBytes + consumer * kBox;
        const uint32_t b = base + stage * kStageBytes + kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16<0, 0>(acc, sw128_desc(a + 32 * kk, kKMajorLbo, kKMajorSbo),
                                 sw128_desc(b + 32 * kk, kKMajorLbo, kKMajorSbo));
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its stage
        fence_acc(acc);
      }
      if (prev >= 0) mbar_arrive(empty_bar + 8 * prev);
      prev = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();  // on every path: the next tile zeroes the accumulators
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(empty_bar + 8 * prev);
    if (!active) continue;

    const bool whole = row0 + kWM <= row_end;  // all 64 rows are the group's
#pragma unroll
    for (int half = 0; half < kBN / 128; ++half) {
      const int col = c0 + 128 * half;
      if (col >= k) break;
      if (ctid == 0) bulk_wait_read();  // the previous store has read `out`
      consumer_sync(consumer);
      if (half == 0) stage_half<0>(acc, out, ctid);
      else stage_half<1>(acc, out, ctid);
      if (whole) {
        fence_proxy_async();
        consumer_sync(consumer);
        if (ctid == 0) {
          tma_store_2d(&dx_map, out, col, row0);
          if (col + 64 < k) tma_store_2d(&dx_map, out + kBox, col + 64, row0);
          bulk_commit();
        }
      } else {  // the group ends inside these rows: 16-byte stores of its rows only
        consumer_sync(consumer);
        for (int i = ctid; i < kWM * 16; i += 128) {
          const int r = i / 16, ch = i % 16, chunk = ch % 8;
          const int row = row0 + r, cl = col + 8 * ch;
          if (row < row_end && cl < k) {
            const uint4 v =
                ld_shared_v4(out + (ch / 8) * kBox + r * 128 + ((chunk ^ (r % 8)) << 4));
            *reinterpret_cast<uint4*>(dx + static_cast<long long>(row) * k + cl) = v;
          }
        }
      }
    }
  }
  if (ctid == 0) bulk_wait();
}

// ---- wgrad

__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap dy_map,
             const __grid_constant__ CUtensorMap dw_map, const int* __restrict__ offsets,
             int rows, int k, int n, int groups) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out_base = base + kStages * kStageBytes;
  const uint32_t full_bar = out_base + kConsumers * kOutBytes, empty_bar = full_bar + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  constexpr int kTM = kConsumers * kWM;  // rows of K an item
  const int nkt = (k + kTM - 1) / kTM, nnt = (n + kBN - 1) / kBN;
  const int per_group = nkt * nnt, items = groups * per_group;
  int stage = 0, phase = 0;

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0) return;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int g = item / per_group, k0 = ((item % per_group) / nnt) * kTM;
      const int n0 = (item % nnt) * kBN;
      const int r_begin = min(max(offsets[g], 0), rows);
      const int r_end = min(max(offsets[g + 1], r_begin), rows);
      const int kboxes = min(kConsumers, (k - k0 + 63) / 64);  // boxes inside K
      const int nboxes = min(kBN / 64, (n - n0 + 63) / 64);    // and inside N
      const uint32_t bytes = (kboxes + nboxes) * kBox;
      for (int r = r_begin; r < r_end; r += kBK) {
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
        const uint32_t a = base + stage * kStageBytes, bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, bytes);
        for (int c = 0; c < kboxes; ++c) tma_load_2d(a + c * kBox, &x_map, bar, k0 + 64 * c, r);
        for (int j = 0; j < nboxes; ++j)
          tma_load_2d(a + kABytes + j * kBox, &dy_map, bar, n0 + 64 * j, r);
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int consumer = threadIdx.x / 128 - 1, ctid = threadIdx.x % 128;
  const uint32_t out = out_base + consumer * kOutBytes;
  float acc[128];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item / per_group, k0 = ((item % per_group) / nnt) * kTM + kWM * consumer;
    const int n0 = (item % nnt) * kBN;
    const int r_begin = min(max(offsets[g], 0), rows);
    const int r_end = min(max(offsets[g + 1], r_begin), rows);
    const bool active = k0 < k;  // this consumer's 64 rows of K hold some
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int r = r_begin; r < r_end; r += kBK) {
      mbar_wait(full_bar + 8 * stage, phase);
      if (active) {
        const uint32_t a = base + stage * kStageBytes + consumer * kBox;
        const uint32_t b = base + stage * kStageBytes + kABytes;
        const int valid = min(kBK, r_end - r);
        if (valid < kBK) {  // rows past the group's end: zeros in this consumer's x box
          for (int i = ctid; i < (kBK - valid) * 8; i += 128)
            st_shared_zero16(a + valid * 128 + 16 * i);
          fence_proxy_async();
          consumer_sync(consumer);
        }
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16<1, 1>(acc, sw128_desc(a + 2048 * kk, kMNMajorLbo, kMNMajorSbo),
                                 sw128_desc(b + 2048 * kk, kMNMajorLbo, kMNMajorSbo));
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
      }
      if (prev >= 0) mbar_arrive(empty_bar + 8 * prev);
      prev = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();  // on every path: the next tile zeroes the accumulators
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(empty_bar + 8 * prev);
    if (!active) continue;

#pragma unroll
    for (int half = 0; half < kBN / 128; ++half) {
      const int col = n0 + 128 * half;
      if (col >= n) break;
      if (ctid == 0) bulk_wait_read();
      consumer_sync(consumer);
      if (half == 0) stage_half<0>(acc, out, ctid);
      else stage_half<1>(acc, out, ctid);
      fence_proxy_async();
      consumer_sync(consumer);
      if (ctid == 0) {
        tma_store_3d(&dw_map, out, col, k0, g);
        if (col + 64 < n) tma_store_3d(&dw_map, out + kBox, col + 64, k0, g);
        bulk_commit();
      }
    }
  }
  if (ctid == 0) bulk_wait();
}

// ---- host: tensor maps and launches

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (a host
// function: no link against libcuda, whatever the toolkit's version)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a bf16 map of `rank` dims (innermost first; `strides`: bytes between the
// rows of dims 1..) read and written in [64][64] boxes (x 1 in dim 2) with
// the 128-byte swizzle; zeros past the edges
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, cuuint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[3] = {64, box_rows, 1}, unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
int prepare(Kernel kernel, bool& configured, int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && !configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    configured = err == cudaSuccess;
  }
  return static_cast<int>(err);
}

}  // namespace gmm_bwd

// dy [rows, n] bf16 (rows sorted by group), w [groups, k, n] bf16, offsets
// [groups + 1] int32, dx [rows, k] bf16; k and n multiples of 8, every
// pointer 16-byte aligned.
extern "C" int grouped_matmul_dgrad(const void* dy, const void* w, const void* offsets,
                                    void* dx, int rows, int k, int n, int groups,
                                    void* stream) {
  using namespace gmm_bwd;
  if (rows <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  int sms = 0;
  if (int err = prepare(dgrad_kernel, configured, sms)) return err;
  CUtensorMap dy_map, w_map, dx_map;
  const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(rows)};
  const cuuint64_t dy_strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(groups)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                   static_cast<cuuint64_t>(n) * k * 2};
  const cuuint64_t dx_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t dx_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  if (!make_map(&dy_map, dy, 2, dy_dims, dy_strides, kWM) ||
      !make_map(&w_map, w, 3, w_dims, w_strides, kBN) ||
      !make_map(&dx_map, dx, 2, dx_dims, dx_strides, kWM))
    return static_cast<int>(cudaErrorInvalidValue);
  // at most ceil(rows / 128) + groups row tiles, each ceil(k / 256) items
  const long long items =
      (static_cast<long long>(rows + 2 * kWM - 1) / (2 * kWM) + groups) * ((k + kBN - 1) / kBN);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  dgrad_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      dy_map, w_map, dx_map, static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(dx),
      rows, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, k] bf16 (rows sorted by group), dy [rows, n] bf16, offsets
// [groups + 1] int32, dw [groups, k, n] bf16 (every group written, an empty
// one as zeros); k and n multiples of 8, every pointer 16-byte aligned.
extern "C" int grouped_matmul_wgrad(const void* x, const void* dy, const void* offsets,
                                    void* dw, int rows, int k, int n, int groups,
                                    void* stream) {
  using namespace gmm_bwd;
  if (rows < 0 || k <= 0 || n <= 0 || groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0)  // every group is empty
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, static_cast<size_t>(groups) * k * n * 2, st));
  static bool configured = false;
  int sms = 0;
  if (int err = prepare(wgrad_kernel, configured, sms)) return err;
  CUtensorMap x_map, dy_map, dw_map;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(rows)};
  const cuuint64_t dy_strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint64_t dw_dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k),
                                 static_cast<cuuint64_t>(groups)};
  const cuuint64_t dw_strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                    static_cast<cuuint64_t>(n) * k * 2};
  if (!make_map(&x_map, x, 2, x_dims, x_strides, kBK) ||
      !make_map(&dy_map, dy, 2, dy_dims, dy_strides, kBK) ||
      !make_map(&dw_map, dw, 3, dw_dims, dw_strides, kWM))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(groups) * ((k + 2 * kWM - 1) / (2 * kWM)) *
                          ((n + kBN - 1) / kBN);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  wgrad_kernel<<<grid, kThreads, kSmemBytes, st>>>(x_map, dy_map, dw_map,
                                                   static_cast<const int*>(offsets), rows, k, n,
                                                   groups);
  return static_cast<int>(cudaGetLastError());
}
