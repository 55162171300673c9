// K1: batched COS pricing of (surface, option) rows, float and double.
//
// Replaces option_pricing_ffn_lbfgs_tpu/ops/cos_pallas.py::
// price_surfaces_pallas (kernel body _kernel/_price_tile), which was float32
// only. On the calibration path K1<double> prices every LM polish residual
// and the generator's surfaces, K1<float> reprices the search winner.
//
// What bounds it on the H100: arithmetic, chiefly the transcendentals of
// the characteristic function (CF): two Heston factors (csqrt, two cdiv,
// cexp, clog) and the jump factor, about 26 special-function calls a term,
// against 60 bytes of input and 4-8 bytes of output per row. At float64
// these run on the FP64 units, which is what the polish pays for its
// precision. Nothing in it is a matrix product, so tensor cores, wgmma and
// TMA do not apply.
//
// A row depends on its strike only through the range [a, b], and only where
// the widening to log(K/S0) -/+ 0.1 binds; the rows of one maturity share
// phi(u_k) otherwise. So (the layout of K2/K3, cos_vg.cu):
//   * One block per surface (per chunk of kMaxRows rows of it). The block
//     loads the 13 parameters, each row's maturity and log(K/S0) into
//     shared memory and finds the maturity groups itself, by exact equality
//     of tau: no host-side grouping, no extra argument.
//   * Each maturity's cumulant range once (cumulant_range); each row's
//     widening is tested as the plain pricer tests it, and a row where it
//     binds on either side is an effective group of its own with its own
//     [a, b]. Nothing is approximated.
//   * All effective groups' CF items item_k = Re[phi(u_k) exp(-i u_k a)]
//     at once, not group after group: kThreads / n_groups threads a group
//     stride over its k and store the items in shared memory (192
//     threads: one item each for 3 maturities at N = 64).
//   * Then each warp takes a row; its lanes stride over k by 32 as the
//     old one-warp-per-row kernel did, multiply the payoff V_k by the
//     shared item, and a shuffle tree sums the lanes. A row's terms keep
//     that kernel's order, per lane and in the tree.
//   * Same bits as that kernel, float and double. The order alone is not
//     enough: nvcc contracts a multiply and an add into an FMA only where
//     both land in one basic block, so the code around the formulas
//     matters. The ranges are computed with the parameters loaded into
//     registers first, the items in a loop over k with the group's
//     invariants in registers, as that kernel's lanes did; placed
//     otherwise, the same formulas gave double prices that differed from
//     it in their last bits.
//   * With fewer surfaces than SMs a surface's rows are split over blocks
//     (Plan below), which shortens the chain where the card is idle.
//   * Shared memory grows with the rows and N (15 options at N = 128 in
//     double: 15 KB of items at worst). Above 48 KB the launch raises the
//     block's limit; where all groups' items would pass 227 KB, the groups
//     are processed in passes that fit, and where even one group's items
//     would not, the terms in chunks of a multiple of 32 (a row then adds
//     its chunks' sums, the only case whose bits differ from a row priced
//     in one piece). Surfaces of more than kMaxRows options are split over
//     blocks. Every n_opt and N is accepted.
//   * Sums in a fixed order and no atomics: two launches give identical
//     bits. No --use_fast_math: the double kernel needs the accurate libm.
#include "cos_price_terms.cuh"

namespace {

using namespace cosk1;

constexpr int kParams = 13;
constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 256;            // rows of one block
constexpr size_t kMaxSmem = 232448;      // 227 KB, the H100's block limit

// Blocks an SM must hold: 2 x 6 warps for double, 4 x 6 for float.
template <typename T> struct MinBlocks { static constexpr int value = 4; };
template <> struct MinBlocks<double> { static constexpr int value = 2; };

// Shared memory of one block, in T then int units; host and device agree.
// `rows` rows, item room for `groups` effective groups x `kc` terms.
struct Layout {
  int logk, tau, ga, gb, ea, eb, etau, sum, item, n_t;
  int first, shared, eff, count, n_i;
  __host__ __device__ Layout(int rows, int groups, int kc) {
    logk = kParams;                       // params occupy [0, 13)
    tau = logk + rows;
    ga = tau + rows;                      // by a maturity's first row
    gb = ga + rows;
    ea = gb + rows;                       // by effective group
    eb = ea + rows;
    etau = eb + rows;
    sum = etau + rows;                    // a row's sum of earlier chunks
    item = sum + rows;
    n_t = item + groups * kc;
    first = 0;                            // a row's maturity's first row
    shared = first + rows;                // by first row: its shared group
    eff = shared + rows;                  // a row's effective group
    count = eff + rows;
    n_i = count + 1;
  }
  template <typename T> size_t bytes() const {
    return sizeof(T) * n_t + sizeof(int) * n_i;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
cos_price_kernel(const T* __restrict__ params, const T* __restrict__ spots,
                 const T* __restrict__ strikes, const T* __restrict__ mats,
                 const unsigned char* __restrict__ is_call,
                 T* __restrict__ out, T rate, T q, T L, int n_opt,
                 int n_terms, int rows, int groups, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(rows, groups, kc);
  T* st = reinterpret_cast<T*>(smem);
  int* si = reinterpret_cast<int*>(st + lay.n_t);
  const int chunks = (n_opt + rows - 1) / rows;
  const int surf = blockIdx.x / chunks;
  const int r0 = (blockIdx.x - surf * chunks) * rows;
  const int n = min(rows, n_opt - r0);
  const int row0 = surf * n_opt + r0;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const T spot = spots[surf];
  const T* p = st;                        // the surface's parameters
  // The parameters also in registers, loaded first as the old kernel's
  // lanes loaded them: the range below is then compiled, FMA contractions
  // included, as it was there.
  T pr[kParams];
#pragma unroll
  for (int j = 0; j < kParams; ++j) pr[j] = params[surf * kParams + j];

  if (tid < kParams) st[tid] = params[surf * kParams + tid];
  // Each row's log(K/S0) and maturity group, found by exact equality of
  // tau and named by the group's first row, which computes its cumulant
  // range.
  for (int r = tid; r < n; r += kThreads) {
    const T tau = mats[row0 + r];
    const T log_k = s_log(strikes[row0 + r] / spot);
    st[lay.tau + r] = tau;
    st[lay.logk + r] = log_k;
    si[lay.shared + r] = -1;
    int f = r;
    for (int r2 = 0; r2 < r; ++r2)
      if (mats[row0 + r2] == tau) { f = r2; break; }
    si[lay.first + r] = f;
    if (f == r) {
      T a, b;
      cumulant_range(pr, tau, rate, L, a, b);
      st[lay.ga + r] = a;
      st[lay.gb + r] = b;
    }
  }
  __syncthreads();
  if (tid == 0) {
    // Effective groups: the rows of a maturity whose widening does not
    // bind share its range; every other row is a group of its own.
    int ne = 0;
    for (int r = 0; r < n; ++r) {
      const int g = si[lay.first + r];
      T a, b;
      const bool share = widen(st[lay.ga + g], st[lay.gb + g],
                               st[lay.logk + r], a, b);
      int e = share ? si[lay.shared + g] : -1;
      if (e < 0) {
        e = ne++;
        if (share) si[lay.shared + g] = e;
        st[lay.ea + e] = a;
        st[lay.eb + e] = b;
        st[lay.etau + e] = st[lay.tau + r];
      }
      si[lay.eff + r] = e;
    }
    si[lay.count] = ne;
  }
  __syncthreads();
  const int n_eff = si[lay.count];

  for (int e0 = 0; e0 < n_eff; e0 += groups) {       // passes of groups
    const int ng = min(groups, n_eff - e0);
    for (int k0 = 0; k0 == 0 || k0 < n_terms; k0 += kc) {   // term chunks
      const int nk = max(0, min(kc, n_terms - k0));
      const bool last = k0 + kc >= n_terms;
      // kThreads / ng threads a group, each striding over its k with the
      // group's parameters, tau and range in registers, as a lane of the
      // old kernel strode over its row's terms (the same loop-invariant
      // code, hence the same contractions).
      const int tpg = ng < kThreads ? kThreads / ng : 1;
      for (int g = tid / tpg; g < ng; g += kThreads / tpg) {
        const int e = e0 + g;
        T gp[kParams];
#pragma unroll
        for (int j = 0; j < kParams; ++j) gp[j] = p[j];
        const T tau = st[lay.etau + e], a = st[lay.ea + e],
                b = st[lay.eb + e];
        T* item = st + lay.item + g * kc;   // item[k - k0]
        for (int k = tid - (tid / tpg) * tpg; k < nk; k += tpg)
          item[k] = cf_item(gp, tau, rate, q, a, b, k0 + k);
      }
      __syncthreads();
      for (int r = warp; r < n; r += kWarps) {
        const int g = si[lay.eff + r] - e0;
        if (g < 0 || g >= ng) continue;               // whole warp skips
        const int row = row0 + r;
        const PayoffRow<T> pay(st[lay.ea + e0 + g], st[lay.eb + e0 + g],
                               st[lay.logk + r], spot, strikes[row],
                               is_call[row] != 0);
        const T* item = st + lay.item + g * kc;   // item[k - k0]
        T part = T(0);
        for (int k = k0 + wl; k < k0 + nk; k += 32)
          part = add_term(part, item[k - k0], pay.v(k), k);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_down_sync(0xffffffffu, part, off);
        if (wl == 0) {
          const T sum = k0 == 0 ? part : st[lay.sum + r] + part;
          if (last)
            out[row] = discounted(sum, rate, mats[row]);
          else
            st[lay.sum + r] = sum;
        }
      }
      __syncthreads();
    }
  }
}

// Rows per block, effective groups per pass and terms per chunk: as many
// groups as the block has rows, as far as 227 KB of items allow. With
// fewer surfaces than SMs (one surface's lanes, price_single) a surface's
// rows are split over blocks until the SMs are busy: each block then finds
// and computes the groups of its own rows, more CF work on SMs that would
// idle, and a shorter chain in each.
struct Plan {
  int rows, groups, kc;
};

template <typename T>
Plan plan(int n_surf, int n_opt, int n_terms, int n_sm) {
  Plan pl;
  const int split = n_surf < n_sm ? (n_sm + n_surf - 1) / n_surf : 1;
  pl.rows = (n_opt + split - 1) / split;
  if (pl.rows > kMaxRows) pl.rows = kMaxRows;
  const size_t room =
      (kMaxSmem - Layout(pl.rows, 0, 0).bytes<T>()) / sizeof(T);
  const size_t per_group = n_terms > 0 ? static_cast<size_t>(n_terms) : 1;
  if (room >= per_group) {
    pl.kc = static_cast<int>(per_group);
    pl.groups = static_cast<int>(
        room / per_group < static_cast<size_t>(pl.rows) ? room / per_group
                                                        : pl.rows);
  } else {
    pl.kc = static_cast<int>(room / 32 * 32);
    pl.groups = 1;
  }
  return pl;
}

template <typename T>
int launch(const void* params, const void* spots, const void* strikes,
           const void* mats, const void* is_call, void* out, double rate,
           double q, double L, int n_rows, int n_opt, int n_terms,
           void* stream) {
  if (n_rows <= 0 || n_opt <= 0 || n_rows % n_opt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan<T>(n_rows / n_opt, n_opt, n_terms, n_sm);
  const size_t bytes = Layout(pl.rows, pl.groups, pl.kc).bytes<T>();
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        cos_price_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = n_rows / n_opt * ((n_opt + pl.rows - 1) / pl.rows);
  cos_price_kernel<T><<<blocks, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(params), static_cast<const T*>(spots),
      static_cast<const T*>(strikes), static_cast<const T*>(mats),
      static_cast<const unsigned char*>(is_call), static_cast<T*>(out),
      static_cast<T>(rate), static_cast<T>(q), static_cast<T>(L), n_opt,
      n_terms, pl.rows, pl.groups, pl.kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params [B,13], spots [B], strikes/mats/is_call/out [B*n_opt] row-major;
// n_rows = B * n_opt. Returns the cudaError_t of the launch.
extern "C" int cos_price_f32(const void* params, const void* spots,
                             const void* strikes, const void* mats,
                             const void* is_call, void* out, double rate,
                             double q, double L, int n_rows, int n_opt,
                             int n_terms, void* stream) {
  return launch<float>(params, spots, strikes, mats, is_call, out, rate, q, L,
                       n_rows, n_opt, n_terms, stream);
}

extern "C" int cos_price_f64(const void* params, const void* spots,
                             const void* strikes, const void* mats,
                             const void* is_call, void* out, double rate,
                             double q, double L, int n_rows, int n_opt,
                             int n_terms, void* stream) {
  return launch<double>(params, spots, strikes, mats, is_call, out, rate, q,
                        L, n_rows, n_opt, n_terms, stream);
}
