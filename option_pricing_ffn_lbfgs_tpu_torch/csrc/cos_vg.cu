// K2/K3: per-row COS price and weighted parameter gradient, float and double.
//
// Replaces option_pricing_ffn_lbfgs_tpu/ops/loss_pallas.py::
// _rows_price_and_grad (kernel body _kernel_vg), where the gradient was a
// jax.vjp traced inside the Pallas kernel. For each (lane, option) row it
// computes the price P and w * dP/dtheta for the 13 constrained parameters,
// the dependence of the truncation range [a, b] on theta included:
//   mode 0 (K2, the search's value-and-grad): w = 2 (P - mkt) / (mkt^2 n_opt),
//     the exact dLoss/dP of the relative-MSE loss; the kernel writes the
//     prices and each lane's sum over its rows, [L, 13];
//   mode 1 (K3, the LM Jacobian):             w = 1 / (mkt sqrt(n_opt)),
//     so the rows [L, n_opt, 13] are the residual Jacobian d r_j / dtheta.
// The host (ops/loss_kernel.py) adds the Feller terms, the transform chain
// rule and the sentinel. Two instantiations: float (cos_vg_f32: the float32
// search, the hybrid refine and the polish Jacobian) and double (cos_vg_f64:
// the float64 value-and-grad of calibrate_surface and hybrid_calibrate).
//
// What bounds it on the H100: arithmetic, chiefly the transcendentals of the
// characteristic function (CF): two Heston factors (csqrt, three cdiv,
// cexp, clog) and the jump factor, each term. Its inputs and outputs are
// about 90 B a row, so memory traffic is negligible; nothing in it is a
// matrix product, so tensor cores, wgmma and TMA do not apply. The first
// design carried all 13 tangents through every operation (Dual<T, 13>):
// 14x the primal arithmetic, 255 registers and spills, at most 8 warps an SM.
//
// This design:
//   * Structured derivatives. log phi = A1 + A2 + B1 v1 + B2 v2 + i drift u
//     tau + jump(u). Each Heston factor is evaluated in Dual<T, 5> over
//     (kappa_i, theta_i, sigma_i, rho_i, u); d log phi / d v0_i = B_i is the
//     factor's own primal; the jump factor and the drift run in Dual<T, 4>
//     over (lambda, mu_J, sigma_J, u). Then d phi = phi d log phi.
//   * Range chain rule. With E_k = exp(-i u_k a), term_k = Re[phi E_k] V_k
//     and u_k = k pi / (b - a), so
//       dP/dtheta_j = e^{-r tau} sum_k { Re[dphi/dtheta_j E_k] V_k
//                     + dterm_k/da da/dtheta_j + dterm_k/db db/dtheta_j },
//     where the total derivatives in (a, b) take u_k's dependence through
//     dphi/du; the payoff V_k runs in Dual<T, 2> over (a, b). A row keeps 16
//     running sums (P, d/da, d/db, 13 CF terms) and applies da/dtheta and
//     db/dtheta once at the end.
//   * Shared CF. One block per lane. phi(u_k) depends on the row only
//     through tau and [a, b], so rows of one maturity share it: the block
//     computes each maturity group's cumulant range and its 13-wide
//     derivative once; a row whose widening to log(K/S0) -/+ 0.1 binds gets
//     its own range and becomes its own group, so the result stays exact.
//     The threads evaluate the groups' N CF items (phi, its derivatives,
//     E_k) into shared memory, one slice of kScratch * N values a group;
//     then each warp takes a row, its lanes stride over k for the payoff
//     (k = lane + 32 j), and a shuffle tree reduces the 16 sums. Every sum
//     runs in a fixed order without atomics, so two launches give
//     identical bits. Shared memory is the card feature this design uses.
//   * The block's width. W, the warps of a lane's block, is a template
//     parameter, and `slices` the groups whose items the block holds at
//     once. The CF round deals the items of `slices` groups, as one range,
//     over the block's threads; then all their rows, in group order, go to
//     the W warps, a row a warp; further groups go in further chunks.
//       - W = 2 (double only), one slice: group after group, for
//         launches that fill the card, 4 blocks an SM.
//       - W = 4 or 8: as many slices as the SM's shared memory gives each
//         of its 16 / W resident blocks (8 / W for double). At 3
//         maturities and N = 64, W = 8 takes one CF round and 2 row rounds
//         where W = 2 took 3 and 9: one lane's path, what a launch costs
//         when its lanes do not fill the card, falls from 0.10 to 0.04 ms.
//         Float takes W = 4 where the card is full (it beat W = 2 there
//         by 14 %), double W = 2 (W = 4 lost 12 %).
//     The host (ops/loss_kernel.py::launch_warps) takes the widest W whose
//     resident lanes, SMs x occupancy at its shared memory
//     (cos_vg_slots_*), hold the lanes the launch prices, else the
//     narrowest. Each CF item, payoff term, shuffle tree and epilogue is
//     the same code on the same inputs at every width, only run by
//     another thread, and the set-up is integer work and comparisons, so
//     every width gives the same bits, those of the group-after-group
//     schedule at any width. As in K1 (cos_price.cu), where the code sits
//     matters: nvcc contracts a multiply and an add into an FMA only
//     within a basic block. With a group's invariants (a, b, tau, the
//     step) loaded inside the item loop, the float gradients moved in
//     their last bits; loaded once a group, the double ones did (by
//     1e-13). So the CF round has one form for each type, the one that
//     keeps that type's bits.
//   * __launch_bounds__(32 W, 16 / W) keeps the float kernel at 16
//     resident warps an SM (at most 128 registers a thread) at every
//     width; the double kernel at 8.
//   * Done lanes. Inside a bound trip (the fused L-BFGS trip K4, K2, K5;
//     the fused LM trip K6, K1<double>, K3, K7) the kernel takes the
//     state's done flags, done [L]: K5 or K7 of the previous trip wrote
//     them on the same stream, and K4 and K6 leave them as they are. The
//     block of a done lane returns before its first shared-memory write
//     and its first __syncthreads (the test is uniform across the block),
//     so its price and gradient rows keep what they held: nothing reads
//     them, since K5 and K7 of the same trip touch only lanes that are not
//     done. A lane that is not done runs the same code in the same order,
//     so its bits are those of the unmasked launch. done = nullptr (the
//     one-shot wrappers, the unfused trips) prices every lane.
// Branches select on the primal (cos_math.cuh), and there is no
// --use_fast_math: the double kernel needs the accurate libm.
#include "cos_vg_terms.cuh"

namespace {

using namespace cosvg;

constexpr int kMaxDevices = 64;

// Warps an SM must hold at every width: 16 for float (8 blocks of 2
// warps, 4 of 4, 2 of 8), 8 for double.
template <typename T> struct ResidentWarps {
  static constexpr int value = 16;
};
template <> struct ResidentWarps<double> {
  static constexpr int value = 8;
};

// Shared memory of one block, in T then int units; host and device agree.
// `slices` groups' CF items are held at once.
struct Layout {
  int logk, ga, gb, gda, gdb, ea, eb, etau, item, rowg, n_t;
  int first, gidx, grow, eff, erows, estart, flags, count, n_i;
  __host__ __device__ Layout(int n, int n_terms, int slices) {
    logk = kParams;                       // params occupy [0, 13)
    ga = logk + n;
    gb = ga + n;
    gda = gb + n;
    gdb = gda + n * kParams;
    ea = gdb + n * kParams;
    eb = ea + n;
    etau = eb + n;
    item = etau + n;
    rowg = item + kScratch * n_terms * slices;
    n_t = rowg + n * kParams;
    first = 0;
    gidx = first + n;
    grow = gidx + n;
    eff = grow + n;
    erows = eff + n;
    estart = erows + n;
    flags = estart + n + 1;
    count = flags + n;
    n_i = count + 2;
  }
  template <typename T> size_t bytes() const {
    return sizeof(T) * n_t + sizeof(int) * n_i;
  }
};

template <typename T, int W>
__global__ void __launch_bounds__(32 * W, ResidentWarps<T>::value / W)
cos_vg_kernel(const T* __restrict__ params, const T* __restrict__ spots,
              const T* __restrict__ strikes, const T* __restrict__ mats,
              const unsigned char* __restrict__ is_call,
              const T* __restrict__ mkt, const int* __restrict__ groups,
              const unsigned char* __restrict__ done,
              T* __restrict__ price_out, T* __restrict__ grad_out, T rate,
              T q, T L, int n_opt, int n_terms, int mode, int slices) {
  constexpr int kThreads = 32 * W;
  const int lane = blockIdx.x;
  if (done != nullptr && done[lane]) return;   // its rows are never read
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(n_opt, n_terms, slices);
  T* st = reinterpret_cast<T*>(smem);
  int* si = reinterpret_cast<int*>(st + lay.n_t);
  T* s_item = st + lay.item;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int row0 = lane * n_opt;
  const T spot = spots[lane];

  // The set-up: integer work and comparisons, a row a thread, each
  // result the one a serial pass over the rows gives.
  // Parameters, log-moneyness, the rows' group labels.
  int* label = si + lay.erows;            // reused until the rows' order
  if (tid < kParams) st[tid] = params[lane * kParams + tid];
  for (int r = tid; r < n_opt; r += kThreads) {
    st[lay.logk + r] = cosm::s_log(strikes[row0 + r] / spot);
    label[r] = groups[row0 + r];
  }
  __syncthreads();
  for (int r = tid; r < n_opt; r += kThreads) {   // first row of its label
    int f = r;
    for (int r2 = 0; r2 < r; ++r2)
      if (label[r2] == label[r]) { f = r2; break; }
    si[lay.first + r] = f;
  }
  __syncthreads();
  // Dense maturity-group ids, in order of their first rows.
  for (int r = tid; r < n_opt; r += kThreads) {
    const int f = si[lay.first + r];
    int id = 0;
    for (int r2 = 0; r2 < f; ++r2) id += si[lay.first + r2] == r2;
    si[lay.gidx + r] = id;
    if (f == r) si[lay.grow + id] = r;
    if (r == n_opt - 1) {
      int ng = id;
      for (int r2 = f; r2 < n_opt; ++r2) ng += si[lay.first + r2] == r2;
      si[lay.count] = ng;
    }
  }
  __syncthreads();
  const T* p = st;                        // the lane's parameters
  const int n_groups = si[lay.count];
  int* shared_of = si + lay.first;        // reused: maturity -> first row
  for (int g = tid; g < n_groups; g += kThreads) {
    group_range(p, mats[row0 + si[lay.grow + g]], rate, L, st + lay.ga + g,
                st + lay.gb + g, st + lay.gda + g * kParams,
                st + lay.gdb + g * kParams);
    shared_of[g] = n_opt;
  }
  __syncthreads();
  // Effective groups: the rows of a maturity whose widening does not
  // bind share its range, from its first such row on; every other row is
  // a group of its own. Groups are numbered in order of their first rows.
  for (int r = tid; r < n_opt; r += kThreads) {
    const int g = si[lay.gidx + r];
    const T ga = st[lay.ga + g], gb = st[lay.gb + g];
    const T log_k = st[lay.logk + r];
    const T lo = log_k - T(0.1), hi = log_k + T(0.1);
    const bool a_on = ga < lo, b_on = gb > hi;
    si[lay.flags + r] = (a_on ? 1 : 0) | (b_on ? 2 : 0);
    if (a_on && b_on) atomicMin(shared_of + g, r);
  }
  __syncthreads();
  auto starts = [&](int r) {              // the first row of its group
    return si[lay.flags + r] != 3 || shared_of[si[lay.gidx + r]] == r;
  };
  for (int r = tid; r < n_opt; r += kThreads) {
    int e = 0;
    for (int r2 = 0; r2 < r; ++r2) e += starts(r2);
    if (starts(r)) {
      const int g = si[lay.gidx + r], flags = si[lay.flags + r];
      const T log_k = st[lay.logk + r];
      st[lay.ea + e] = (flags & 1) ? st[lay.ga + g] : log_k - T(0.1);
      st[lay.eb + e] = (flags & 2) ? st[lay.gb + g] : log_k + T(0.1);
      st[lay.etau + e] = mats[row0 + r];
      si[lay.eff + r] = e;
    }
    if (r == n_opt - 1) si[lay.count + 1] = e + starts(r);
  }
  __syncthreads();
  for (int r = tid; r < n_opt; r += kThreads)
    if (!starts(r)) si[lay.eff + r] = si[lay.eff + shared_of[si[lay.gidx + r]]];
  __syncthreads();
  // Rows ordered by group, ascending within a group.
  for (int r = tid; r < n_opt; r += kThreads) {
    const int e = si[lay.eff + r];
    int pos = 0;
    for (int r2 = 0; r2 < n_opt; ++r2) {
      const int e2 = si[lay.eff + r2];
      pos += e2 < e || (e2 == e && r2 < r);
    }
    si[lay.erows + pos] = r;
    if (starts(r)) si[lay.estart + e] = pos;
  }
  if (tid == 0) si[lay.estart + si[lay.count + 1]] = n_opt;
  __syncthreads();
  const int n_eff = si[lay.count + 1];
  const int slice = kScratch * n_terms;

  for (int e0 = 0; e0 < n_eff; e0 += slices) {
    const int ne = n_eff - e0 < slices ? n_eff - e0 : slices;
    // The CF round: the chunk's (group, k) items as one range, item
    // c N + k to thread (c N + k) mod threads. Float loads a group's
    // invariants once a group, double once an item: in these forms nvcc
    // contracts cf_item's multiply-adds as in the group-after-group
    // schedule (the design note above).
    if constexpr (sizeof(T) == sizeof(float)) {
      for (int c = 0; c < ne; ++c) {
        const T a = st[lay.ea + e0 + c], b = st[lay.eb + e0 + c];
        const T tau = st[lay.etau + e0 + c];
        const T width = b - a;
        const T step = T(3.141592653589793) / width;
        int k0 = (tid - c * n_terms) % kThreads;
        if (k0 < 0) k0 += kThreads;
        for (int k = k0; k < n_terms; k += kThreads)
          cf_item(p, tau, rate, q, a, width, step, k, n_terms,
                  s_item + c * slice);
      }
    } else {
      for (int i = tid; i < ne * n_terms; i += kThreads) {
        const int c = i / n_terms, k = i - c * n_terms;
        const T a = st[lay.ea + e0 + c], b = st[lay.eb + e0 + c];
        const T tau = st[lay.etau + e0 + c];
        const T width = b - a;
        const T step = T(3.141592653589793) / width;
        cf_item(p, tau, rate, q, a, width, step, k, n_terms,
                s_item + c * slice);
      }
    }
    __syncthreads();

    // The row rounds: the chunk's rows, in group order, a warp each.
    const int end = si[lay.estart + e0 + ne];
    for (int i = si[lay.estart + e0] + warp; i < end; i += W) {
      const int r = si[lay.erows + i];
      const int row = row0 + r;
      const int e = si[lay.eff + r];
      const T* item = s_item + (e - e0) * slice;
      const PayoffRow<T> pay(st[lay.ea + e], st[lay.eb + e], st[lay.logk + r],
                             spot, strikes[row], is_call[row] != 0);
      T acc[kItem];
#pragma unroll
      for (int f = 0; f < kItem; ++f) acc[f] = T(0);
      for (int k = wl; k < n_terms; k += 32)
        add_row_term(acc, item, n_terms, k, pay.v(k));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int f = 0; f < kItem; ++f)
          acc[f] += __shfl_down_sync(0xffffffffu, acc[f], off);
      }
      if (wl == 0) {
        const T disc = cosm::s_exp(-rate * mats[row]);
        const T price = disc * acc[0];
        const T m = mkt[row];
        const T w = mode == 0
            ? T(2) * (price - m) / (m * m * static_cast<T>(n_opt))
            : static_cast<T>(1.0 / sqrt(static_cast<double>(n_opt))) / m;
        const T wd = w * disc;
        const int flags = si[lay.flags + r];
        const T sa = (flags & 1) ? acc[1] : T(0);
        const T sb = (flags & 2) ? acc[2] : T(0);
        const T* gda = st + lay.gda + si[lay.gidx + r] * kParams;
        const T* gdb = st + lay.gdb + si[lay.gidx + r] * kParams;
        T* out = mode == 0 ? st + lay.rowg + r * kParams
                           : grad_out + static_cast<size_t>(row) * kParams;
#pragma unroll
        for (int j = 0; j < kParams; ++j)
          out[j] = wd * (acc[3 + j] + sa * gda[j] + sb * gdb[j]);
        price_out[row] = price;
      }
    }
    __syncthreads();
  }
  if (mode == 0 && tid < kParams) {        // the lane's sum, in row order
    T s = T(0);
    for (int r = 0; r < n_opt; ++r) s += st[lay.rowg + r * kParams + tid];
    grad_out[lane * kParams + tid] = s;
  }
}

// What a launch at width W uses: the kernel, its slices and shared bytes.
struct Shape {
  const void* kernel;
  int threads, slices;
  size_t bytes;
};

// The current device and its shared memory: a block's opt-in limit, an
// SM's, and what each resident block reserves; read once a device.
struct Device {
  int id, optin, per_sm, reserved;
};

cudaError_t current_device(Device* d) {
  static Device known[kMaxDevices];
  static bool seen[kMaxDevices] = {};
  int id = 0;
  cudaError_t err = cudaGetDevice(&id);
  if (err != cudaSuccess) return err;
  if (id < 0 || id >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!seen[id]) {
    Device got = {id, 0, 0, 0};
    err = cudaDeviceGetAttribute(&got.optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, id);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &got.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, id);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &got.reserved, cudaDevAttrReservedSharedMemoryPerBlock, id);
    if (err != cudaSuccess) return err;
    known[id] = got;
    seen[id] = true;
  }
  *d = known[id];
  return cudaSuccess;
}

// The shape of a launch of n_opt rows at N = n_terms and width W on the
// current device, the kernel's limit on dynamic shared memory raised to
// the device's once for each instantiation.
template <typename T, int W>
cudaError_t shape_at(int n_opt, int n_terms, Shape* sh) {
  static bool raised[kMaxDevices] = {};
  Device d;
  cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return err;
  if (!raised[d.id]) {
    err = cudaFuncSetAttribute(cos_vg_kernel<T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.optin);
    if (err != cudaSuccess) return err;
    raised[d.id] = true;
  }
  int slices = 1;
  if (W > 2) {
    // As many groups as fit the shared memory each of the SM's resident
    // blocks has, and no more than the rows; at 2 warps, one.
    size_t room = static_cast<size_t>(d.per_sm)
        / (ResidentWarps<T>::value / W) - d.reserved;
    if (room > static_cast<size_t>(d.optin)) room = d.optin;
    const size_t base = Layout(n_opt, n_terms, 0).bytes<T>();
    const size_t per = sizeof(T) * kScratch * n_terms;
    if (room > base + per) slices = static_cast<int>((room - base) / per);
    if (slices > n_opt) slices = n_opt;
  }
  *sh = {reinterpret_cast<const void*>(cos_vg_kernel<T, W>), 32 * W, slices,
         Layout(n_opt, n_terms, slices).bytes<T>()};
  return cudaSuccess;
}

// The widths instantiated: 4 and 8 warps for float, which is faster at 4
// than at 2 at every load; 2, 4 and 8 for double, at 2 where it fills the
// card.
template <typename T>
cudaError_t shape(int warps, int n_opt, int n_terms, Shape* sh) {
  switch (warps) {
    case 2:
      if constexpr (sizeof(T) == sizeof(double))
        return shape_at<T, 2>(n_opt, n_terms, sh);
      return cudaErrorInvalidValue;
    case 4: return shape_at<T, 4>(n_opt, n_terms, sh);
    case 8: return shape_at<T, 8>(n_opt, n_terms, sh);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* params, const void* spots, const void* strikes,
           const void* mats, const void* is_call, const void* mkt,
           const void* groups, const void* done, void* price_out,
           void* grad_out, double rate, double q, double L, int n_lanes,
           int n_opt, int n_terms, int mode, int warps, void* stream) {
  if (n_lanes <= 0 || n_opt <= 0 || n_terms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  const cudaError_t err = shape<T>(warps, n_opt, n_terms, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* t_params = static_cast<const T*>(params);
  const T* t_spots = static_cast<const T*>(spots);
  const T* t_strikes = static_cast<const T*>(strikes);
  const T* t_mats = static_cast<const T*>(mats);
  const unsigned char* t_call = static_cast<const unsigned char*>(is_call);
  const T* t_mkt = static_cast<const T*>(mkt);
  const int* t_groups = static_cast<const int*>(groups);
  const unsigned char* t_done = static_cast<const unsigned char*>(done);
  T* t_price = static_cast<T*>(price_out);
  T* t_grad = static_cast<T*>(grad_out);
  T t_rate = static_cast<T>(rate), t_q = static_cast<T>(q);
  T t_L = static_cast<T>(L);
  void* args[] = {&t_params, &t_spots, &t_strikes, &t_mats, &t_call,
                  &t_mkt, &t_groups, &t_done, &t_price, &t_grad, &t_rate,
                  &t_q, &t_L, &n_opt, &n_terms, &mode, &sh.slices};
  return static_cast<int>(cudaLaunchKernel(
      sh.kernel, dim3(n_lanes), dim3(sh.threads), args, sh.bytes,
      static_cast<cudaStream_t>(stream)));
}

// Lanes the card holds at once at width W: SMs x resident blocks at the
// launch's shared memory; a negative cudaError_t on failure.
template <typename T>
int slots(int n_opt, int n_terms, int warps) {
  if (n_opt <= 0 || n_terms <= 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  int dev = 0, n_sm = 0, blocks = 0;
  cudaError_t err = shape<T>(warps, n_opt, n_terms, &sh);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sh.kernel, sh.threads, sh.bytes);
  return err == cudaSuccess ? n_sm * blocks : -static_cast<int>(err);
}

}  // namespace

// params [L,13], spots [L], strikes/mats/is_call/mkt/price_out [L*n_opt],
// groups [L*n_opt] int32 labels (rows of a lane with equal labels must have
// equal maturities; ops/loss_kernel.py::maturity_groups), all row-major;
// done [L] bytes or nullptr: a lane whose byte is set is skipped, its rows
// left as they are; grad_out [L, 13] (mode 0, the lane's row sum: K2) or
// [L*n_opt, 13] (mode 1, every row: K3); warps 2, 4 or 8, the block's
// width (same bits at each). Returns the launch's cudaError_t.
extern "C" int cos_vg_f32(const void* params, const void* spots,
                          const void* strikes, const void* mats,
                          const void* is_call, const void* mkt,
                          const void* groups, const void* done,
                          void* price_out, void* grad_out, double rate,
                          double q, double L, int n_lanes, int n_opt,
                          int n_terms, int mode, int warps, void* stream) {
  return launch<float>(params, spots, strikes, mats, is_call, mkt, groups,
                       done, price_out, grad_out, rate, q, L, n_lanes, n_opt,
                       n_terms, mode, warps, stream);
}

extern "C" int cos_vg_f64(const void* params, const void* spots,
                          const void* strikes, const void* mats,
                          const void* is_call, const void* mkt,
                          const void* groups, const void* done,
                          void* price_out, void* grad_out, double rate,
                          double q, double L, int n_lanes, int n_opt,
                          int n_terms, int mode, int warps, void* stream) {
  return launch<double>(params, spots, strikes, mats, is_call, mkt, groups,
                        done, price_out, grad_out, rate, q, L, n_lanes, n_opt,
                        n_terms, mode, warps, stream);
}

// Lanes a launch of n_opt rows at N = n_terms and `warps` holds resident on
// the current device, or a negative cudaError_t.
extern "C" int cos_vg_slots_f32(int n_opt, int n_terms, int warps) {
  return slots<float>(n_opt, n_terms, warps);
}

extern "C" int cos_vg_slots_f64(int n_opt, int n_terms, int warps) {
  return slots<double>(n_opt, n_terms, warps);
}
