// The device matcher of the training losses: Bertsekas' auction, one CTA a
// problem with the whole round loop inside it.
//
// Replaces: toc3d_tpu/core/auction.py :: hungarian_match_auction (:103),
//   auction_assign (:72) and _auction_phase (:23), plain jnp under vmap (no
//   pallas_call): one cold phase at eps = spread / eps_div, Jacobi bids,
//   stopping once every valid person owns an object or after max_iters
//   rounds. Persons are the GT slots (P = G), objects the queries (O = Q).
//
// Why one CTA a problem: the JAX while_loop ported as eager torch ops costs
// ~10 launches and one host read a round, and the rounds run into the
// hundreds. Here a cost tensor (B, Q, G) is one launch of B CTAs and the
// host never waits on a round.
//
// Design, per CTA (problem b):
//   prologue  benefit[p][o] = -cost[b][o][p] for the valid persons, into a
//             global scratch in (P, O) order (each bidding warp then reads
//             its row coalesced; the problem stays in L2), and the spread
//             max(1, max |cost| over valid persons), so eps = spread /
//             eps_div, an IEEE division;
//   shared    the prices, owners, per-object best bid (ordered-int encoded
//             for atomicMax) and winner (atomicMin) of the O objects, and
//             the per-person flags: 16 B an object, 12 B a person;
//   a round   (1) mark each person that owns an object; stop when no valid
//             person is left unassigned (__syncthreads_or); reset the
//             objects' bids; (2) each warp takes bidding persons: a (value,
//             index) reduction gives the best object (lowest index on ties,
//             as jnp.argmax) and the second-best value (the row's maximum
//             with the best entry set to NEG), and the bid
//             (price[best] + (best - second)) + eps goes to the object by
//             atomicMax; (3) the bidders whose bid equals their object's top
//             bid take atomicMin of their id into its winner; (4) every
//             object with a winner takes its top bid as price and the winner
//             as owner.
// The arithmetic is the plain version's in the same float32 order, with no
// multiply to contract (adds and subtracts by __fadd_rn / __fsub_rn), so the
// assignment equals it exactly.
//
// Bound: each input read once and the output written once, B * Q * G * 4 +
// B * G * 4 bytes over 3.35 TB/s; the rounds depend on the data.
#include <climits>

#include "common.cuh"

constexpr int AUCTION_THREADS = 512;
constexpr int AUCTION_WARPS = AUCTION_THREADS / 32;
constexpr float AUCTION_NEG = -1e9f;

// float -> int with the order of the floats (atomicMax on floats of both
// signs), and back
__device__ __forceinline__ int ordered(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// merge (best value, its index, second value) of two sets: the best is the
// larger value, the lower index on a tie; the second is the largest of the
// rest
__device__ __forceinline__ void top2_merge(float& v1, int& i1, float& v2,
                                           float b1, int bi, float b2) {
  if (b1 > v1 || (b1 == v1 && bi < i1)) {
    v2 = fmaxf(v1, b2);
    v1 = b1;
    i1 = bi;
  } else {
    v2 = fmaxf(v2, b1);
  }
}

__global__ void __launch_bounds__(AUCTION_THREADS)
    auction_kernel(const float* __restrict__ cost,
                   const int* __restrict__ n_valid, float* benefit,
                   int* __restrict__ out, int Q, int G, int max_iters,
                   float eps_div) {
  extern __shared__ int smem[];
  const int O = Q, P = G;
  float* price = reinterpret_cast<float*>(smem);          // [O]
  int* owner = smem + O;                                  // [O]
  int* obj_bid = smem + 2 * O;                            // [O] ordered
  int* winner = smem + 3 * O;                             // [O]
  int* assigned = smem + 4 * O;                           // [P]
  int* p_best = smem + 4 * O + P;                         // [P]
  float* p_bid = reinterpret_cast<float*>(smem + 4 * O + 2 * P);  // [P]
  __shared__ float warp_max[AUCTION_WARPS];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* c = cost + (long long)b * Q * G;
  float* ben = benefit + (long long)b * G * Q;
  const int nv = min(max(n_valid[b], 0), P);

  // prologue: benefit rows of the valid persons, the spread, the state
  float m = 0.0f;
  for (int k = tid; k < O * nv; k += AUCTION_THREADS) {
    const int o = k / nv, p = k - o * nv;
    const float x = c[(long long)o * G + p];
    ben[(long long)p * O + o] = -x;
    m = fmaxf(m, fabsf(x));
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  for (int o = tid; o < O; o += AUCTION_THREADS) {
    price[o] = 0.0f;
    owner[o] = -1;
  }
  __syncthreads();
  float spread = warp_max[0];
  for (int w = 1; w < AUCTION_WARPS; ++w) spread = fmaxf(spread, warp_max[w]);
  spread = fmaxf(spread, 1.0f);
  const float eps = __fdiv_rn(spread, eps_div);

  for (int it = 0; it < max_iters; ++it) {
    // (1) who owns an object; reset the round's bids
    for (int p = tid; p < P; p += AUCTION_THREADS) assigned[p] = 0;
    __syncthreads();
    for (int o = tid; o < O; o += AUCTION_THREADS) {
      const int w = owner[o];
      if (w >= 0) assigned[w] = 1;
      obj_bid[o] = ordered(AUCTION_NEG);
      winner[o] = P;
    }
    __syncthreads();
    int pending = 0;
    for (int p = tid; p < nv; p += AUCTION_THREADS) pending |= !assigned[p];
    if (!__syncthreads_or(pending)) break;

    // (2) bids, a warp a bidding person
    for (int p = warp; p < nv; p += AUCTION_WARPS) {
      if (assigned[p]) continue;
      const float* row = ben + (long long)p * O;
      float v1 = -INFINITY, v2 = -INFINITY;
      int i1 = INT_MAX;
      for (int o = lane; o < O; o += 32) {
        const float v = __fsub_rn(row[o], price[o]);
        if (v > v1) {
          v2 = v1;
          v1 = v;
          i1 = o;
        } else {
          v2 = fmaxf(v2, v);
        }
      }
      for (int s = 16; s > 0; s >>= 1) {
        const float b1 = __shfl_xor_sync(0xffffffffu, v1, s);
        const int bi = __shfl_xor_sync(0xffffffffu, i1, s);
        const float b2 = __shfl_xor_sync(0xffffffffu, v2, s);
        top2_merge(v1, i1, v2, b1, bi, b2);
      }
      if (lane == 0) {
        const float second = fmaxf(v2, AUCTION_NEG);
        const float bid =
            __fadd_rn(__fadd_rn(price[i1], __fsub_rn(v1, second)), eps);
        p_best[p] = i1;
        p_bid[p] = bid;
        atomicMax(&obj_bid[i1], ordered(bid));
      }
    }
    __syncthreads();

    // (3) the lowest person id among an object's top bidders wins it
    for (int p = tid; p < nv; p += AUCTION_THREADS) {
      if (assigned[p]) continue;
      const int o = p_best[p];
      if (p_bid[p] >= unordered(obj_bid[o])) atomicMin(&winner[o], p);
    }
    __syncthreads();

    // (4) prices and owners of the objects that got a bid
    for (int o = tid; o < O; o += AUCTION_THREADS) {
      const int w = winner[o];
      if (w < P) {
        price[o] = unordered(obj_bid[o]);
        owner[o] = w;
      }
    }
    __syncthreads();
  }

  // each valid person's first owned object, else -1
  for (int p = tid; p < P; p += AUCTION_THREADS) assigned[p] = INT_MAX;
  __syncthreads();
  for (int o = tid; o < O; o += AUCTION_THREADS) {
    const int w = owner[o];
    if (w >= 0) atomicMin(&assigned[w], o);
  }
  __syncthreads();
  for (int p = tid; p < P; p += AUCTION_THREADS) {
    const int o = assigned[p];
    out[(long long)b * G + p] = (p < nv && o != INT_MAX) ? o : -1;
  }
}

static size_t auction_smem(int Q, int G) {
  return (size_t)(4 * Q + 3 * G) * sizeof(int);
}

// cost (B, Q, G) f32, n_valid (B,) int32 (the valid persons of a problem
// are its first n_valid GT slots), benefit a (B, G, Q) f32 scratch, out
// (B, G) int32: the query matched to each GT slot, -1 past n_valid or when
// max_iters rounds ended first
TOC3D_EXPORT int toc3d_auction(const void* cost, const void* n_valid,
                               void* benefit, void* out, int B, int Q, int G,
                               int max_iters, float eps_div, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  const size_t smem = auction_smem(Q, G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auction_kernel<<<B, AUCTION_THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_valid),
      static_cast<float*>(benefit), static_cast<int*>(out), Q, G, max_iters,
      eps_div);
  return static_cast<int>(cudaGetLastError());
}
