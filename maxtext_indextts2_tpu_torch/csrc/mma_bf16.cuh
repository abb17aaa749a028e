// Warp-level building blocks of the bf16 tensor-core kernels (sm_90a): the
// flash-attention kernels K9-K11 (flash_attention.cuh) and the S2A attention K12
// (s2a_attention.cu). `cp.async` copies global memory to shared memory 16 bytes
// at a time without a register, `ldmatrix` reads 8 x 8 bf16 fragments from shared
// memory, and `mma.sync.m16n8k16` multiplies bf16 fragments exactly and sums in
// float32. The C fragment of an m16n8k16 product has the layout of its A fragment,
// so a float32 result can be rounded to bf16 in registers and fed to the next
// product without a trip through shared memory (`pack_bf16`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes global -> shared without a register; where !ok, zeros and no read
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i; `_t` transposes each
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: A 16 x 16 (row), B 16 x 8 (col), bf16, exact products, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, a sum from zero: the float32 result covers only these 16 products
__device__ __forceinline__ void mma_bf16_from_zero(float (&d)[4], const unsigned (&a)[4],
                                                   unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// two floats -> one register of two bf16 (the first in the low half), rounded
// to nearest even
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<unsigned*>(&v);
}

// the float32 C fragments of a 16 x (16 KT) product, 8 columns a fragment, as
// the bf16 A fragments of the next product, one per 16 columns: the rounding
// point of the kernels that round a float32 result before a product
template <int KT>
__device__ __forceinline__ void c_to_a(const float (&c)[2 * KT][4], unsigned (&a)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile. The chunks
// are XOR-swizzled so that the 8 rows of one `ldmatrix` hit 8 different 16-byte
// bank groups: by r % 8 where a row has 8 chunks or more (D >= 64); by (r / 2) % 4
// at D = 32, where two rows share one 128-byte line
template <int D>
__device__ __forceinline__ unsigned swz(int r, int c) {
  static_assert(D == 32 || D % 64 == 0, "rows of 4 or a multiple of 8 chunks");
  const int x = D >= 64 ? (r & 7) : ((r >> 1) & 3);
  return static_cast<unsigned>(r * (D * 2) + ((c ^ x) << 4));
}

// rows [r0, r0 + ROWS) of one (batch, head) slice into a swizzled tile by the
// THREADS threads of a block, rows at or past `rows` as zeros
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(unsigned dst, const bf16* base, long long s_stride,
                                                int r0, int rows) {
  constexpr int CH = D / 8, COPIES = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (COPIES + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS, r = i / CH, c = i % CH, row = r0 + r;
    if (COPIES % THREADS != 0 && i >= COPIES) break;  // a tile smaller than a copy a thread
    const bool ok = row < rows;
    cp_async16(dst + swz<D>(r, c), base + (long long)(ok ? row : 0) * s_stride + c * 8, ok);
  }
}

// S[16 rows x 8 NT cols] = A[16 x D] B^T: A's fragments `a` (one per 16 of D),
// B a swizzled [rows][D] tile whose rows [0, 8 NT) are the columns of S; this
// thread's element e of fragment j is (row lane / 4 + 8 (e / 2),
// col 8 j + 2 (lane % 4) + e % 2)
template <int D, int NT>
__device__ __forceinline__ void product_abt(float (&s)[NT][4], const unsigned (&a)[D / 16][4],
                                            unsigned bt, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldsm_x4(bt + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)),
              b);
      mma_bf16(s[2 * np], a[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// product_abt for rows [r0, r0 + 16) of a swizzled [rows][D] tile A, with a
// float32 sum rounded to nearest over D: each 16-product partial is summed on the
// tensor cores from zero and the partials are added on the CUDA cores. The tensor
// cores align the addends of a product to the largest (in a chain, the
// accumulator) and truncate, so a chain of D / 16 products loses low bits against
// a large accumulator; where a result is rounded to bf16 next (K10's ds from s),
// those bits decide which way it rounds. A's fragments are read one 16-column
// step at a time, so only one is live
template <int D, int NT>
__device__ __forceinline__ void product_abt_rn(float (&s)[NT][4], unsigned at, int r0,
                                               unsigned bt, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(at + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)), a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldsm_x4(bt + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)),
              b);
      float t0[4], t1[4];
      mma_bf16_from_zero(t0, a, b[0], b[1]);
      mma_bf16_from_zero(t1, a, b[2], b[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * np][e] = kk == 0 ? t0[e] : s[2 * np][e] + t0[e];
        s[2 * np + 1][e] = kk == 0 ? t1[e] : s[2 * np + 1][e] + t1[e];
      }
    }
  }
}

// acc[16 rows x D] += A[16 x 16 KT] M[16 KT x D]: A's fragments `a`, M a
// swizzled [16 KT][D] tile read by ldmatrix.trans (nothing is transposed in memory)
template <int D, int KT>
__device__ __forceinline__ void product_am(float (&acc)[D / 8][4], const unsigned (&a)[KT][4],
                                           unsigned m, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned b[4];
      ldsm_x4_t(m + swz<D>(kk * 16 + (lane & 15), 2 * np + (lane >> 4)), b);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// the A fragments of rows [r0, r0 + 16) of a swizzled [rows][D] tile, one per 16 of D
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4], unsigned tile, int r0,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(tile + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)), a[kk]);
}

}  // namespace hopper
