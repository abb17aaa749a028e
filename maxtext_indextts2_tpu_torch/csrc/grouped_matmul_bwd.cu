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
// What the designs do about it: both run on the machinery of
// grouped_wgmma.cuh (a persistent CTA an SM, a TMA producer warp feeding a
// 4-stage mbarrier ring, two `wgmma` consumer warpgroups on 128 x 256 tiles of
// the result, TMA stores). dgrad is that header's `rows_kernel<false>`: its
// items are a group's row tiles, group by group with a group's row tiles
// together (an expert of mixtral's wo, 117 MB, is larger than the L2: with
// the columns inner, all of w[g] would stream once a row tile), B the K-major
// [256 of K][64 of N] box of w[g].
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
#include "grouped_wgmma.cuh"

namespace gmm_bwd {

using namespace gmm_wg;

// ---- wgrad

__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap dy_map,
             const __grid_constant__ CUtensorMap dw_map, const int* __restrict__ offsets,
             int rows, int k, int n, int groups) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = init_ring(smem_raw);
  const uint32_t base = ring.base, full_bar = ring.full_bar, empty_bar = ring.empty_bar;
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
  const uint32_t out = ring.out_base + consumer * kOutBytes;
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

}  // namespace gmm_bwd

// dy [rows, n] bf16 (rows sorted by group), w [groups, k, n] bf16, offsets
// [groups + 1] int32, dx [rows, k] bf16; k and n multiples of 8, every
// pointer 16-byte aligned.
extern "C" int grouped_matmul_dgrad(const void* dy, const void* w, const void* offsets,
                                    void* dx, int rows, int k, int n, int groups,
                                    void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return gmm_wg::launch_rows<false>(dy, w, offsets, dx, rows, k, n, groups,
                                    static_cast<cudaStream_t>(stream));
}

// x [rows, k] bf16 (rows sorted by group), dy [rows, n] bf16, offsets
// [groups + 1] int32, dw [groups, k, n] bf16 (every group written, an empty
// one as zeros); k and n multiples of 8, every pointer 16-byte aligned.
extern "C" int grouped_matmul_wgrad(const void* x, const void* dy, const void* offsets,
                                    void* dw, int rows, int k, int n, int groups,
                                    void* stream) {
  using namespace gmm_wg;
  if (rows < 0 || k <= 0 || n <= 0 || groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0)  // every group is empty
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, static_cast<size_t>(groups) * k * n * 2, st));
  static bool configured = false;
  int sms = 0;
  if (int err = prepare(gmm_bwd::wgrad_kernel, configured, sms)) return err;
  CUtensorMap x_map, dy_map, dw_map;
  if (!make_map_2d(&x_map, x, rows, k, kBK) || !make_map_2d(&dy_map, dy, rows, n, kBK) ||
      !make_map_experts(&dw_map, dw, groups, k, n, kWM))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(groups) * ((k + 2 * kWM - 1) / (2 * kWM)) *
                          ((n + kBN - 1) / kBN);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  gmm_bwd::wgrad_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      x_map, dy_map, dw_map, static_cast<const int*>(offsets), rows, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}
