// The machinery that the grouped products on `wgmma` share (sm_90a): the
// forward y[r] = x[r] @ w[g(r)] (grouped_matmul.cu, where the groups hold many
// rows) and its two gradients dgrad and wgrad (grouped_matmul_bwd.cu). bf16
// operands, float32 sums, bf16 results; x [R, K] with rows sorted by group,
// w [G, K, N], offsets [G + 1] int32 on the device (group g holds rows
// [offsets[g], offsets[g + 1])).
//
// Here: the PTX of shared memory, mbarriers, TMA and `wgmma`; the operand
// descriptors for the 128-byte swizzle; the device-side scan that finds an
// item's group; the epilogue that stages a bf16 tile for a TMA store; the
// host's tensor maps and launch set-up; and `rows_kernel`, the persistent
// kernel of the two products whose items are row tiles of a group:
//
//   dgrad (kFwd false): dx[r, :] = dy[r, :] @ w[g(r)]^T   A = dy [R, N], B = w[g] K-major
//   forward (kFwd true): y[r, :] = x[r, :] @ w[g(r)]      A = x [R, K],  B = w[g] MN-major
//
// The design (what bounds these products and why, in grouped_matmul_bwd.cu):
// one persistent CTA an SM walks output tiles in a fixed order (item =
// blockIdx.x + i gridDim.x). Warp-specialised: warpgroup 0 is the producer,
// whose first warp keeps TMA loads in flight into a ring of kStages stages
// guarded by mbarriers (full: the bytes landed; empty: both consumers are done
// with it); warpgroups 1 and 2 are consumers, each running
// `wgmma.mma_async` m64n256k16 (bf16 -> float32) on 64 rows of a 128 x 256
// tile of the result from 128-byte-swizzled shared memory, with one product
// group in flight. `setmaxnreg` gives the consumers 232 registers (128 of them
// the float32 tile) and the producer 40. Since the producer runs ahead of the
// consumers, the next tile's first stages load while the consumers round the
// current tile to bf16, write it to shared memory in the swizzle of the
// output's tensor map and store it with TMA (a [64][128] half at a time; the
// elected thread waits for the previous store to have read its buffer). The
// tensor maps are built on the host per call from the pointers
// (cuTensorMapEncodeTiled from libcuda, looked up with dlsym) and passed as
// __grid_constant__ parameters; TMA fills zeros past R and the edges of the
// operands.
//
// rows_kernel's items: (row tile of a group, 256 columns of the result);
// items run group by group and, within a group, column tile by column tile
// with the group's row tiles together, so that the CTAs at work read each
// slice of w[g] from device memory once and share it in the L2. A stage holds
// A's rows [64 | 128][64 of the reduction] (K-major) and w[g]'s [256 columns
// of the result][64 of the reduction] through a 3-d map over [G, K, N]:
// dgrad's columns are K and its reduction N, which is contiguous in a row of
// w, so one [256 of K][64 of N] box is already the K-major B operand; the
// forward's columns are N, so its B is four [64 of K][64 of N] boxes, the
// MN-major operand that `wgmma` reads through its transpose bit (no transposed
// copy of the experts). The (group, row tile) of an item comes from `offsets`
// on the device by a warp scan that resumes where the previous item was found.
// Group edges: a tile of 128 rows is two warpgroups of 64; a warpgroup whose
// 64 rows hold none of the group's rows is not loaded, runs no product and
// stores nothing, so a group of a few rows pays for 64 rows (the rule: rows a
// tile = 128, halved where the group's rest is 64 or fewer). A half whose rows
// run past the group's end computes the next group's rows too (TMA loads
// whatever lies there, zeros past R) and does not store them: it goes out
// with masked 16-byte stores from the staged tile, since a TMA store would
// overwrite the next group's rows; a full half goes out by TMA. Every sum runs
// in a fixed order: two launches give the same bits. Nothing is read back to
// the host.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace gmm_wg {

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

// ---- the ring: barriers at the end of the dynamic shared memory

// the 1024-aligned base of the stages, the staged outputs after them, then
// kStages full and kStages empty mbarriers (initialised by thread 0)
struct Ring {
  uint32_t base, out_base, full_bar, empty_bar;
};
__device__ __forceinline__ Ring init_ring(unsigned char* smem_raw) {
  Ring r;
  r.base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle wants 1024
  r.out_base = r.base + kStages * kStageBytes;
  r.full_bar = r.out_base + kConsumers * kOutBytes;
  r.empty_bar = r.full_bar + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full_bar + 8 * s, 1);
      mbar_init(r.empty_bar + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// ---- the tile walk and the epilogue

// TILE-row tiles of group g (rows_kernel's: 128)
template <int TILE = 2 * kWM>
__device__ __forceinline__ int row_tiles(const int* __restrict__ offsets, int g) {
  return (max(0, offsets[g + 1] - offsets[g]) + TILE - 1) / TILE;
}

// rows_kernel's items (and grouped_matmul.cu's int8 persistent kernel's, of
// 64-row tiles): group by group, each group's (row tile, column tile) pairs
// with the row tiles inner. The group of item `t` and its index within the
// group, or group -1 past the last; warp-wide (every lane gets the answer).
// `base` and `carry` (32-group chunk, items before it) resume the scan where
// the previous, smaller `t` was found.
template <int TILE = 2 * kWM>
__device__ __forceinline__ int find_item(const int* __restrict__ offsets, int groups, int ncol,
                                         int t, int& base, int& carry, int& local) {
  const int lane = threadIdx.x % 32;
  for (; base < groups; base += 32) {
    const int g = base + lane;
    int cnt = 0;
    if (g < groups) cnt = row_tiles<TILE>(offsets, g) * ncol;
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

// ---- the products whose items are a group's row tiles: dgrad and the forward

// out [rows, cols] = A [rows, depth] @ B(g): dgrad's B is w[g]^T (w [G, cols,
// depth], a [256][64] box, K-major); the forward's is w[g] (w [G, depth,
// cols], four [64][64] boxes, MN-major)
template <bool kFwd>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
            const __grid_constant__ CUtensorMap out_map, const int* __restrict__ offsets,
            __nv_bfloat16* __restrict__ out, int rows, int cols, int depth, int groups) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = init_ring(smem_raw);
  const int ncol = (cols + kBN - 1) / kBN, nsteps = (depth + kBK - 1) / kBK;
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
      // the forward's B boxes that hold columns (one past the edge would load nothing)
      const int bboxes = kFwd ? min(kBN / 64, (cols - c0 + 63) / 64) : 0;
      const uint32_t bytes = (both ? 2 : 1) * kBox + (kFwd ? bboxes * kBox : kBBytes);
      for (int s = 0; s < nsteps; ++s) {
        mbar_wait(ring.empty_bar + 8 * stage, phase ^ 1);
        if (elected) {
          const uint32_t a = ring.base + stage * kStageBytes, bar = ring.full_bar + 8 * stage;
          mbar_expect_tx(bar, bytes);
          tma_load_2d(a, &a_map, bar, s * kBK, row0);
          if (both) tma_load_2d(a + kBox, &a_map, bar, s * kBK, row0 + kWM);
          if (kFwd) {
            for (int j = 0; j < bboxes; ++j)
              tma_load_3d(a + kABytes + j * kBox, &b_map, bar, c0 + 64 * j, s * kBK, g);
          } else {
            tma_load_3d(a + kABytes, &b_map, bar, s * kBK, c0, g);
          }
        }
        __syncwarp();
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int consumer = threadIdx.x / 128 - 1, ctid = threadIdx.x % 128;
  const uint32_t staged = ring.out_base + consumer * kOutBytes;
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
      mbar_wait(ring.full_bar + 8 * stage, phase);
      if (active) {
        const uint32_t a = ring.base + stage * kStageBytes + consumer * kBox;
        const uint32_t b = ring.base + stage * kStageBytes + kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = sw128_desc(a + 32 * kk, kKMajorLbo, kKMajorSbo);
          if (kFwd)
            wgmma_m64n256k16<0, 1>(acc, da, sw128_desc(b + 2048 * kk, kMNMajorLbo, kMNMajorSbo));
          else
            wgmma_m64n256k16<0, 0>(acc, da, sw128_desc(b + 32 * kk, kKMajorLbo, kKMajorSbo));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its stage
        fence_acc(acc);
      }
      if (prev >= 0) mbar_arrive(ring.empty_bar + 8 * prev);
      prev = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();  // on every path: the next tile zeroes the accumulators
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(ring.empty_bar + 8 * prev);
    if (!active) continue;

    const bool whole = row0 + kWM <= row_end;  // all 64 rows are the group's
#pragma unroll
    for (int half = 0; half < kBN / 128; ++half) {
      const int col = c0 + 128 * half;
      if (col >= cols) break;
      if (ctid == 0) bulk_wait_read();  // the previous store has read `staged`
      consumer_sync(consumer);
      if (half == 0) stage_half<0>(acc, staged, ctid);
      else stage_half<1>(acc, staged, ctid);
      if (whole) {
        fence_proxy_async();
        consumer_sync(consumer);
        if (ctid == 0) {
          tma_store_2d(&out_map, staged, col, row0);
          if (col + 64 < cols) tma_store_2d(&out_map, staged + kBox, col + 64, row0);
          bulk_commit();
        }
      } else {  // the group ends inside these rows: 16-byte stores of its rows only
        consumer_sync(consumer);
        for (int i = ctid; i < kWM * 16; i += 128) {
          const int r = i / 16, ch = i % 16, chunk = ch % 8;
          const int row = row0 + r, cl = col + 8 * ch;
          if (row < row_end && cl < cols) {
            const uint4 v =
                ld_shared_v4(staged + (ch / 8) * kBox + r * 128 + ((chunk ^ (r % 8)) << 4));
            *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * cols + cl) = v;
          }
        }
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
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a bf16 map of `rank` dims (innermost first; `strides`: bytes between the
// rows of dims 1..) read and written in [box_rows][64] boxes (x 1 in dim 2)
// with the 128-byte swizzle; zeros past the edges
inline bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, cuuint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[3] = {64, box_rows, 1}, unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a [rows][cols] bf16 matrix read or written in [box_rows][64] boxes
inline bool make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                        cuuint32_t box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  return make_map(map, ptr, 2, dims, strides, box_rows);
}

// the experts w [groups, k, n] bf16 read in [box_rows of K][64 of N] boxes
inline bool make_map_experts(CUtensorMap* map, const void* w, int groups, int k, int n,
                             cuuint32_t box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                 static_cast<cuuint64_t>(n) * k * 2};
  return make_map(map, w, 3, dims, strides, box_rows);
}

// the SMs of the current device, and the kernel's shared memory allowed once
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

// rows_kernel on a [rows, depth] A, the experts w and offsets, into out [rows,
// cols]: a persistent grid of at most one CTA an SM
template <bool kFwd>
int launch_rows(const void* a, const void* w, const void* offsets, void* out, int rows, int cols,
                int depth, int groups, cudaStream_t st) {
  static bool configured = false;
  int sms = 0;
  if (int err = prepare(rows_kernel<kFwd>, configured, sms)) return err;
  CUtensorMap a_map, b_map, out_map;
  const bool ok = make_map_2d(&a_map, a, rows, depth, kWM) &&
                  (kFwd ? make_map_experts(&b_map, w, groups, depth, cols, kBK)
                        : make_map_experts(&b_map, w, groups, cols, depth, kBN)) &&
                  make_map_2d(&out_map, out, rows, cols, kWM);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // at most ceil(rows / 128) + groups row tiles, each ceil(cols / 256) items
  const long long items = (static_cast<long long>(rows + 2 * kWM - 1) / (2 * kWM) + groups) *
                          ((cols + kBN - 1) / kBN);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  rows_kernel<kFwd><<<grid, kThreads, kSmemBytes, st>>>(a_map, b_map, out_map,
                                                      static_cast<const int*>(offsets),
                                                      static_cast<__nv_bfloat16*>(out), rows,
                                                      cols, depth, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmm_wg
