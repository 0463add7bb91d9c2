// The codec's CDF rows for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package builds these rows on the host, in
// float64 numpy and scipy (contextgs_tpu/compression/codec.py::
// _windowed_cdf_rows, then compression/coder.py::quantize_cdf), and so does
// the port's plain version, its copy of the two
// (contextgs_tpu_torch/compression/codec.py::_windowed_cdf_rows and
// compression/coder.py::quantize_cdf). This kernel builds the same rows on
// the card: for element i (mu, sigma, Q float32, base int64) and the window
// w, the uint16 row of w + 1 entries that the range coder codes element i
// with, and, where asked, the float64 row it was quantized from.
//
// Equal to the host rows bit for bit. Every float64 product, sum and
// quotient is rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn,
// __ddiv_rn): nvcc would otherwise contract a*b + c into a fused
// multiply-add, which rounds once where numpy rounds twice.
//   - edge_k = (base + k - 0.5) * Q and z = (edge_k - mu) / sigma', where
//     sigma' = max(sigma, 1e-9) is taken in float32 (numpy's promotion in
//     np.maximum(scale, 1e-9), NaN kept) and then widened.
//   - ndtr(z) is Cephes' ndtr, erf and erfc, the algorithm scipy.special.ndtr
//     runs for a real argument: the same coefficients, the same branches and
//     the same order of operations (erf's branch for |z / sqrt 2| < 1; Cephes'
//     own test is against sqrt(1/2), and the two give the same value in
//     between, since 1 - erf(x) is exact there).
//   - Cephes' erfc calls the C library's exp. That is glibc's table-driven
//     exp (glibc 2.28 on; 128-entry table, degree-5 polynomial), which
//     x86-64 runs in its FMA build: exp_glibc below is that algorithm with
//     the fused multiply-adds where that build fuses them (__fma_rn) and
//     every other operation rounded alone, so exp, and with it ndtr, give the
//     host's bits. kExpTab holds, for k in 0..127, the bits of
//     tail_k = RN(2^(k/128) / H_k - 1) and of H_k = RN(2^(k/128)) less
//     k << 45.
//   - For w > 128 the host evaluates ndtr only where |z| < 6 and takes 1
//     where z > 0 and 0 elsewhere (NaN too); so does the kernel. Entry 0 is
//     then pinned to 0, entry w to 1, and the value clipped to [0, 1] with
//     NaN kept (np.clip).
//   - Quantization copies quantize_cdf: q_k = rint(cdf_k * (65536 - w)) + k
//     (half to even), a running maximum along the row, q_0 = 0, q_w = 65536;
//     then, while some q_k - q_(k-1) < 1 and at most twice, the repair with
//     numpy's one-step semantics (each right-hand side read whole before it
//     is written): q[1:] = max(q[1:], q[:-1] + 1), q[w] = 65536,
//     q[:-1] = min(q[:-1], 65536 - (w - k)). The host repairs a whole call's
//     array whenever any row of it fails; that equals repairing each row on
//     its own, since the repair leaves a valid row unchanged (its steps are
//     at least one apart and end at 65536, so no max or min moves them). A
//     NaN entry, int64's minimum after numpy's cast, becomes the running
//     maximum before it; any negative number does the same here. A row still
//     failing after two passes marks its block's word in `bad`, and the
//     wrapper raises as quantize_cdf does. The rows are stored modulo 2^16.
//
// Design. One 256-thread block builds a run of consecutive rows: at w <= 128
// (the decode's 64-symbol window: 65 entries) each warp builds rows in turn,
// 64 a block; at wider windows, up to 2048, the block builds each of 4 rows
// together. A row's threads compute its entries k = t, t + G, ... (G = 32 or
// 256), keep the int32 q in shared memory, scan the running maximum over runs
// of consecutive entries (a warp-shuffle max-scan, and the warps' totals at
// G = 256), test and repair the row there, and store entry k of the uint16
// row (and of the float64 row, where asked) from lane k mod G: consecutive
// lanes write consecutive entries, so the stores coalesce.
//
// Bound, a symbol at the decode's w = 64: 20 bytes read (mu, sigma, Q, base)
// and 130 written (the uint16 row), about 150; and 65 float64 ndtr
// evaluations, about 60 float64 operations each on the erfc branch (exp,
// two degree-8 polynomials, a quotient), fewer on erf's. At 3.35 TB/s and
// 34 TFLOP/s (FP64, no tensor cores) the operations bound it: about 0.05 ns
// of bytes and 0.1 ns of arithmetic a symbol, well under a millisecond for
// a decode's 1.5M symbols. The copy of the rows back to the host, which
// the range coder reads there, costs more than the kernel.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrow = 128;          // widest window a warp builds a row of
constexpr int kMaxWindow = 2048;
constexpr int kRowsNarrow = 64;       // rows a block, w <= kNarrow (8 a warp)
constexpr int kRowsWide = 4;          // rows a block, w > kNarrow
constexpr int kTop = 1 << 16;
constexpr int kNanQ = -1;             // a NaN entry's q before the running max

// Cephes (ndtr.c): erfc's P/Q for 1 <= |x| < 8 and R/S beyond, erf's T/U;
// Q, S and U lead with an implied 1.
__constant__ double kP[9] = {
    2.46196981473530512524E-10, 5.64189564831068821977E-1,
    7.46321056442269912687E0,   4.86371970985681366614E1,
    1.96520832956077098242E2,   5.26445194995477358631E2,
    9.34528527171957607540E2,   1.02755188689515710272E3,
    5.57535335369399327526E2};
__constant__ double kQ[8] = {
    1.32281951154744992508E1, 8.67072140885989742329E1,
    3.54937778887819891062E2, 9.75708501743205489753E2,
    1.82390916687909736289E3, 2.24633760818710981792E3,
    1.65666309194161350182E3, 5.57535340817727675546E2};
__constant__ double kR[6] = {
    5.64189583547755073984E-1, 1.27536670759978104416E0,
    5.01905042251180477414E0,  6.16021097993053585195E0,
    7.40974269950448939160E0,  2.97886665372100240670E0};
__constant__ double kS[6] = {
    2.26052863220117276590E0, 9.39603524938001434673E0,
    1.20489539808096656605E1, 1.70814450747565897222E1,
    9.60896809063285878198E0, 3.36907645100081516050E0};
__constant__ double kT[5] = {
    9.60497373987051638749E0, 9.00260197203842689217E1,
    2.23200534594684319226E3, 7.00332514112805075014E3,
    5.55923013010394962768E4};
__constant__ double kU[5] = {
    3.35617141647503099647E1, 5.21357949780152679795E2,
    4.59432382970980127987E3, 2.26290000613890934246E4,
    4.92673942608635921086E4};
constexpr double kSqrtH = 7.07106781186547524401E-1;   // sqrt(1/2)
constexpr double kMaxLog = 7.09782712893383996843E2;   // log(2^1024)

// glibc's exp: N / ln 2 with N = 128, -ln 2 / N in two parts, the shift
// that rounds to an integer, and the polynomial's C2..C5.
constexpr double kInvLn2N = 184.6649652337873;
constexpr double kNegLn2hiN = -0.005415212348111709;
constexpr double kNegLn2loN = -1.2864023111638346e-14;
constexpr double kShift = 6755399441055744.0;           // 0x1.8p52
constexpr double kC2 = 0.49999999999996786;
constexpr double kC3 = 0.16666666666665886;
constexpr double kC4 = 0.0416666808410674;
constexpr double kC5 = 0.008333335853059549;
constexpr double kTwoM1022 = 2.2250738585072014e-308;   // 0x1p-1022

__device__ const unsigned long long kExpTab[256] = {
    0x0000000000000000ull, 0x3ff0000000000000ull, 0x3c9b3b4f1a88bf6eull, 0x3feff63da9fb3335ull,
    0xbc7160139cd8dc5dull, 0x3fefec9a3e778061ull, 0xbc905e7a108766d1ull, 0x3fefe315e86e7f85ull,
    0x3c8cd2523567f613ull, 0x3fefd9b0d3158574ull, 0xbc8bce8023f98efaull, 0x3fefd06b29ddf6deull,
    0x3c60f74e61e6c861ull, 0x3fefc74518759bc8ull, 0x3c90a3e45b33d399ull, 0x3fefbe3ecac6f383ull,
    0x3c979aa65d837b6dull, 0x3fefb5586cf9890full, 0x3c8eb51a92fdeffcull, 0x3fefac922b7247f7ull,
    0x3c3ebe3d702f9cd1ull, 0x3fefa3ec32d3d1a2ull, 0xbc6a033489906e0bull, 0x3fef9b66affed31bull,
    0xbc9556522a2fbd0eull, 0x3fef9301d0125b51ull, 0xbc5080ef8c4eea55ull, 0x3fef8abdc06c31ccull,
    0xbc91c923b9d5f416ull, 0x3fef829aaea92de0ull, 0x3c80d3e3e95c55afull, 0x3fef7a98c8a58e51ull,
    0xbc801b15eaa59348ull, 0x3fef72b83c7d517bull, 0xbc8f1ff055de323dull, 0x3fef6af9388c8deaull,
    0x3c8b898c3f1353bfull, 0x3fef635beb6fcb75ull, 0xbc96d99c7611eb26ull, 0x3fef5be084045cd4ull,
    0x3c9aecf73e3a2f60ull, 0x3fef54873168b9aaull, 0xbc8fe782cb86389dull, 0x3fef4d5022fcd91dull,
    0x3c8a6f4144a6c38dull, 0x3fef463b88628cd6ull, 0x3c807a05b0e4047dull, 0x3fef3f49917ddc96ull,
    0x3c968efde3a8a894ull, 0x3fef387a6e756238ull, 0x3c875e18f274487dull, 0x3fef31ce4fb2a63full,
    0x3c80472b981fe7f2ull, 0x3fef2b4565e27cddull, 0xbc96b87b3f71085eull, 0x3fef24dfe1f56381ull,
    0x3c82f7e16d09ab31ull, 0x3fef1e9df51fdee1ull, 0xbc3d219b1a6fbffaull, 0x3fef187fd0dad990ull,
    0x3c8b3782720c0ab4ull, 0x3fef1285a6e4030bull, 0x3c6e149289cecb8full, 0x3fef0cafa93e2f56ull,
    0x3c834d754db0abb6ull, 0x3fef06fe0a31b715ull, 0x3c864201e2ac744cull, 0x3fef0170fc4cd831ull,
    0x3c8fdd395dd3f84aull, 0x3feefc08b26416ffull, 0xbc86a3803b8e5b04ull, 0x3feef6c55f929ff1ull,
    0xbc924aedcc4b5068ull, 0x3feef1a7373aa9cbull, 0xbc9907f81b512d8eull, 0x3feeecae6d05d866ull,
    0xbc71d1e83e9436d2ull, 0x3feee7db34e59ff7ull, 0xbc991919b3ce1b15ull, 0x3feee32dc313a8e5ull,
    0x3c859f48a72a4c6dull, 0x3feedea64c123422ull, 0xbc9312607a28698aull, 0x3feeda4504ac801cull,
    0xbc58a78f4817895bull, 0x3feed60a21f72e2aull, 0xbc7c2c9b67499a1bull, 0x3feed1f5d950a897ull,
    0x3c4363ed60c2ac11ull, 0x3feece086061892dull, 0x3c9666093b0664efull, 0x3feeca41ed1d0057ull,
    0x3c6ecce1daa10379ull, 0x3feec6a2b5c13cd0ull, 0x3c93ff8e3f0f1230ull, 0x3feec32af0d7d3deull,
    0x3c7690cebb7aafb0ull, 0x3feebfdad5362a27ull, 0x3c931dbdeb54e077ull, 0x3feebcb299fddd0dull,
    0xbc8f94340071a38eull, 0x3feeb9b2769d2ca7ull, 0xbc87deccdc93a349ull, 0x3feeb6daa2cf6642ull,
    0xbc78dec6bd0f385full, 0x3feeb42b569d4f82ull, 0xbc861246ec7b5cf6ull, 0x3feeb1a4ca5d920full,
    0x3c93350518fdd78eull, 0x3feeaf4736b527daull, 0x3c7b98b72f8a9b05ull, 0x3feead12d497c7fdull,
    0x3c9063e1e21c5409ull, 0x3feeab07dd485429ull, 0x3c34c7855019c6eaull, 0x3feea9268a5946b7ull,
    0x3c9432e62b64c035ull, 0x3feea76f15ad2148ull, 0xbc8ce44a6199769full, 0x3feea5e1b976dc09ull,
    0xbc8c33c53bef4da8ull, 0x3feea47eb03a5585ull, 0xbc845378892be9aeull, 0x3feea34634ccc320ull,
    0xbc93cedd78565858ull, 0x3feea23882552225ull, 0x3c5710aa807e1964ull, 0x3feea155d44ca973ull,
    0xbc93b3efbf5e2228ull, 0x3feea09e667f3bcdull, 0xbc6a12ad8734b982ull, 0x3feea012750bdabfull,
    0xbc6367efb86da9eeull, 0x3fee9fb23c651a2full, 0xbc80dc3d54e08851ull, 0x3fee9f7df9519484ull,
    0xbc781f647e5a3ecfull, 0x3fee9f75e8ec5f74ull, 0xbc86ee4ac08b7db0ull, 0x3fee9f9a48a58174ull,
    0xbc8619321e55e68aull, 0x3fee9feb564267c9ull, 0x3c909ccb5e09d4d3ull, 0x3feea0694fde5d3full,
    0xbc7b32dcb94da51dull, 0x3feea11473eb0187ull, 0x3c94ecfd5467c06bull, 0x3feea1ed0130c132ull,
    0x3c65ebe1abd66c55ull, 0x3feea2f336cf4e62ull, 0xbc88a1c52fb3cf42ull, 0x3feea427543e1a12ull,
    0xbc9369b6f13b3734ull, 0x3feea589994cce13ull, 0xbc805e843a19ff1eull, 0x3feea71a4623c7adull,
    0xbc94d450d872576eull, 0x3feea8d99b4492edull, 0x3c90ad675b0e8a00ull, 0x3feeaac7d98a6699ull,
    0x3c8db72fc1f0eab4ull, 0x3feeace5422aa0dbull, 0xbc65b6609cc5e7ffull, 0x3feeaf3216b5448cull,
    0x3c7bf68359f35f44ull, 0x3feeb1ae99157736ull, 0xbc93091fa71e3d83ull, 0x3feeb45b0b91ffc6ull,
    0xbc5da9b88b6c1e29ull, 0x3feeb737b0cdc5e5ull, 0xbc6c23f97c90b959ull, 0x3feeba44cbc8520full,
    0xbc92434322f4f9aaull, 0x3feebd829fde4e50ull, 0xbc85ca6cd7668e4bull, 0x3feec0f170ca07baull,
    0x3c71affc2b91ce27ull, 0x3feec49182a3f090ull, 0x3c6dd235e10a73bbull, 0x3feec86319e32323ull,
    0xbc87c50422622263ull, 0x3feecc667b5de565ull, 0x3c8b1c86e3e231d5ull, 0x3feed09bec4a2d33ull,
    0xbc91bbd1d3bcbb15ull, 0x3feed503b23e255dull, 0x3c90cc319cee31d2ull, 0x3feed99e1330b358ull,
    0x3c8469846e735ab3ull, 0x3feede6b5579fdbfull, 0xbc82dfcd978e9db4ull, 0x3feee36bbfd3f37aull,
    0x3c8c1a7792cb3387ull, 0x3feee89f995ad3adull, 0xbc907b8f4ad1d9faull, 0x3feeee07298db666ull,
    0xbc55c3d956dcaebaull, 0x3feef3a2b84f15fbull, 0xbc90a40e3da6f640ull, 0x3feef9728de5593aull,
    0xbc68d6f438ad9334ull, 0x3feeff76f2fb5e47ull, 0xbc91eee26b588a35ull, 0x3fef05b030a1064aull,
    0x3c74ffd70a5fddcdull, 0x3fef0c1e904bc1d2ull, 0xbc91bdfbfa9298acull, 0x3fef12c25bd71e09ull,
    0x3c736eae30af0cb3ull, 0x3fef199bdd85529cull, 0x3c8ee3325c9ffd94ull, 0x3fef20ab5fffd07aull,
    0x3c84e08fd10959acull, 0x3fef27f12e57d14bull, 0x3c63cdaf384e1a67ull, 0x3fef2f6d9406e7b5ull,
    0x3c676b2c6c921968ull, 0x3fef3720dcef9069ull, 0xbc808a1883ccb5d2ull, 0x3fef3f0b555dc3faull,
    0xbc8fad5d3ffffa6full, 0x3fef472d4a07897cull, 0xbc900dae3875a949ull, 0x3fef4f87080d89f2ull,
    0x3c74a385a63d07a7ull, 0x3fef5818dcfba487ull, 0xbc82919e2040220full, 0x3fef60e316c98398ull,
    0x3c8e5a50d5c192acull, 0x3fef69e603db3285ull, 0x3c843a59ac016b4bull, 0x3fef7321f301b460ull,
    0xbc82d52107b43e1full, 0x3fef7c97337b9b5full, 0xbc892ab93b470dc9ull, 0x3fef864614f5a129ull,
    0x3c74b604603a88d3ull, 0x3fef902ee78b3ff6ull, 0x3c83c5ec519d7271ull, 0x3fef9a51fbc74c83ull,
    0xbc8ff7128fd391f0ull, 0x3fefa4afa2a490daull, 0xbc8dae98e223747dull, 0x3fefaf482d8e67f1ull,
    0x3c8ec3bc41aa2008ull, 0x3fefba1bee615a27ull, 0x3c842b94c3a9eb32ull, 0x3fefc52b376bba97ull,
    0x3c8a64a931d185eeull, 0x3fefd0765b6e4540ull, 0xbc8e37bae43be3edull, 0x3fefdbfdad9cbe14ull,
    0x3c77893b4d91cd9dull, 0x3fefe7c1819e90d8ull, 0x3c5305c14160cc89ull, 0x3feff3c22b8f71f1ull,
};

// exp(x) for the x that erfc passes, -kMaxLog <= x <= -1, as glibc computes
// it (its fast path for |x| < 512, its special case for k < 0 beyond).
__device__ __forceinline__ double exp_glibc(double x) {
  const double z = __dmul_rn(kInvLn2N, x);
  double kd = __dadd_rn(z, kShift);
  const unsigned long long ki =
      static_cast<unsigned long long>(__double_as_longlong(kd));
  kd = __dsub_rn(kd, kShift);
  const double r = __fma_rn(kd, kNegLn2loN, __fma_rn(kd, kNegLn2hiN, x));
  const int idx = 2 * static_cast<int>(ki & 127);
  const double tail = __longlong_as_double(
      static_cast<long long>(__ldg(kExpTab + idx)));
  unsigned long long sbits = __ldg(kExpTab + idx + 1) + (ki << 45);
  const double r2 = __dmul_rn(r, r);
  const double tmp =
      __fma_rn(__dmul_rn(r2, r2), __fma_rn(r, kC5, kC4),
               __fma_rn(r2, __fma_rn(r, kC3, kC2), __dadd_rn(tail, r)));
  if (fabs(x) < 512.0) {
    const double scale = __longlong_as_double(static_cast<long long>(sbits));
    return __fma_rn(scale, tmp, scale);
  }
  sbits += 1022ull << 52;
  const double scale = __longlong_as_double(static_cast<long long>(sbits));
  double y = __dadd_rn(scale, __dmul_rn(scale, tmp));
  if (y < 1.0) {           // a subnormal result, rounded once
    double lo = __dadd_rn(__dsub_rn(scale, y), __dmul_rn(scale, tmp));
    const double hi = __dadd_rn(1.0, y);
    lo = __dadd_rn(__dadd_rn(__dsub_rn(1.0, hi), y), lo);
    y = __dsub_rn(__dadd_rn(hi, lo), 1.0);
    if (y == 0.0) y = 0.0;
  }
  return __dmul_rn(kTwoM1022, y);
}

// Cephes' polevl (c[0] x^n + ... + c[n]) and p1evl (the same with an
// implied leading 1), each step rounded twice as in C without contraction.
template <int N>
__device__ __forceinline__ double polevl(double x, const double* c) {
  double a = c[0];
#pragma unroll
  for (int i = 1; i <= N; ++i) a = __dadd_rn(__dmul_rn(a, x), c[i]);
  return a;
}

template <int N>
__device__ __forceinline__ double p1evl(double x, const double* c) {
  double a = __dadd_rn(x, c[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) a = __dadd_rn(__dmul_rn(a, x), c[i]);
  return a;
}

// Cephes' erf for |x| < 1, the only arguments ndtr gives it.
__device__ __forceinline__ double erf_cephes(double x) {
  const double z = __dmul_rn(x, x);
  return __ddiv_rn(__dmul_rn(x, polevl<4>(z, kT)), p1evl<5>(z, kU));
}

// Cephes' erfc for a >= 1, the only arguments ndtr gives it.
__device__ __forceinline__ double erfc_cephes(double a) {
  const double z = -__dmul_rn(a, a);
  if (z < -kMaxLog) return 0.0;                  // underflow
  const double e = exp_glibc(z);
  double p, q;
  if (a < 8.0) {
    p = polevl<8>(a, kP);
    q = p1evl<8>(a, kQ);
  } else {
    p = polevl<5>(a, kR);
    q = p1evl<6>(a, kS);
  }
  return __ddiv_rn(__dmul_rn(e, p), q);
}

__device__ __forceinline__ double ndtr(double a) {
  if (isnan(a)) return a;
  const double x = __dmul_rn(a, kSqrtH);
  const double z = fabs(x);
  if (z < 1.0) return __dadd_rn(0.5, __dmul_rn(0.5, erf_cephes(x)));
  const double y = __dmul_rn(0.5, erfc_cephes(z));
  return x > 0.0 ? __dsub_rn(1.0, y) : y;
}

// The float64 CDF value of entry k of a row (codec._windowed_cdf_rows).
__device__ __forceinline__ double cdf_entry(double mu, double sig, double qd,
                                            double base, int k, int w) {
  if (k == 0) return 0.0;
  if (k == w) return 1.0;
  const double edge = __dmul_rn(__dadd_rn(base, static_cast<double>(k) - 0.5),
                                qd);
  const double z = __ddiv_rn(__dsub_rn(edge, mu), sig);
  double c;
  if (w > kNarrow && !(fabs(z) < 6.0)) {
    c = z > 0.0 ? 1.0 : 0.0;
  } else {
    c = ndtr(z);
  }
  return c < 0.0 ? 0.0 : (c > 1.0 ? 1.0 : c);    // np.clip keeps NaN
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if (G == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int G>
__device__ __forceinline__ bool group_any(bool p) {
  if (G == 32) return __any_sync(kFull, p);
  return __syncthreads_or(p) != 0;
}

// The maximum of `v` over the group's threads before this one (INT_MIN for
// the first). `warp_max` holds kWarps values (G = kThreads only).
template <int G>
__device__ __forceinline__ int group_exclusive_max(int v, int* warp_max) {
  const int lane = threadIdx.x & 31;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = max(inc, up);
  }
  int exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = INT_MIN;
  if (G == 32) return exc;
  const int warp = threadIdx.x >> 5;
  if (lane == 31) warp_max[warp] = inc;
  __syncthreads();
  for (int i = 0; i < warp; ++i) exc = max(exc, warp_max[i]);
  __syncthreads();
  return exc;
}

// Is every step of the row at least 1?
template <int G>
__device__ __forceinline__ bool row_valid(const int* sq, int w, int t) {
  bool bad = false;
  for (int k = t + 1; k <= w; k += G) bad |= sq[k] - sq[k - 1] < 1;
  return !group_any<G>(bad);
}

// Rows [r0, r0 + rows) of the call, G threads a row; see the note above.
template <int G>
__global__ void __launch_bounds__(kThreads)
cdf_rows_kernel(const long long* __restrict__ base,
                const float* __restrict__ mu, const float* __restrict__ sigma,
                const float* __restrict__ q, long long n, int w, int rows,
                unsigned short* __restrict__ out, double* __restrict__ fout,
                int* __restrict__ bad) {
  constexpr int kGroups = kThreads / G;
  constexpr int kMaxW1 = (G == 32 ? kNarrow : kMaxWindow) + 1;
  constexpr int kPer = (kMaxW1 + G - 1) / G;    // most entries a thread
  extern __shared__ int smem[];
  const int w1 = w + 1;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(min(static_cast<long long>(rows),
                                         n - r0));
  int* warp_max = smem + kGroups * w1;
  const int group = threadIdx.x / G;
  const int t = threadIdx.x % G;
  int* sq = smem + group * w1;
  const int per = (w1 + G - 1) / G;             // a thread's run in the scan
  const int lo = t * per;
  const int hi = min(lo + per, w1);
  const double span = static_cast<double>(kTop - w);
  bool failed = false;

  for (int lr = group; lr < nrows; lr += kGroups) {
    const long long i = r0 + lr;
    const float s = sigma[i];
    const float sp = s < 1e-9f ? 1e-9f : s;      // np.maximum: NaN kept
    const double sig = static_cast<double>(sp);
    const double m = static_cast<double>(mu[i]);
    const double qd = static_cast<double>(q[i]);
    const double b = static_cast<double>(base[i]);
    for (int k = t; k <= w; k += G) {
      const double c = cdf_entry(m, sig, qd, b, k, w);
      if (fout != nullptr) fout[i * w1 + k] = c;
      sq[k] = isnan(c) ? kNanQ : __double2int_rn(__dmul_rn(c, span)) + k;
    }
    group_sync<G>();
    // running maximum: each thread's run, then the runs before it
    int run = INT_MIN;
    for (int k = lo; k < hi; ++k) run = max(run, sq[k]);
    run = group_exclusive_max<G>(run, warp_max);
    for (int k = lo; k < hi; ++k) {
      run = max(run, sq[k]);
      sq[k] = run;
    }
    group_sync<G>();
    if (t == 0) {
      sq[0] = 0;
      sq[w] = kTop;
    }
    group_sync<G>();
    bool ok = row_valid<G>(sq, w, t);
    for (int pass = 0; pass < 2 && !ok; ++pass) {
      int v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = t + j * G;
        if (k <= w) v[j] = k == 0 ? sq[0] : max(sq[k], sq[k - 1] + 1);
      }
      group_sync<G>();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = t + j * G;
        if (k < w) {
          sq[k] = min(v[j], kTop - (w - k));
        } else if (k == w) {
          sq[k] = kTop;
        }
      }
      group_sync<G>();
      ok = row_valid<G>(sq, w, t);
    }
    if (!ok) failed = true;
    unsigned short* row = out + i * w1;
    for (int k = t; k <= w; k += G) {
      row[k] = static_cast<unsigned short>(sq[k] & 0xFFFF);
    }
    group_sync<G>();
  }
  const int any_failed = __syncthreads_or(failed);
  if (threadIdx.x == 0) bad[blockIdx.x] = any_failed;
}

int rows_a_block(int w) { return w <= kNarrow ? kRowsNarrow : kRowsWide; }

}  // namespace

// The number of blocks, and of words in `bad`, for n rows of window w.
extern "C" int cdf_rows_blocks(long long n, int w) {
  return static_cast<int>((n + rows_a_block(w) - 1) / rows_a_block(w));
}

// base: [n] int64; mu, sigma, q: [n] float32; out: [n, w + 1] uint16;
// fout: [n, w + 1] float64 or null; bad: one int32 a block
// (cdf_rows_blocks), each set to 1 where a row of the block is degenerate
// and to 0 elsewhere. 1 <= w <= 2048. Returns the CUDA error of the launch
// (0 on success; cudaErrorInvalidValue for arguments it does not take).
extern "C" int cdf_rows(const void* base, const void* mu, const void* sigma,
                        const void* q, long long n, int w, void* out,
                        void* fout, void* bad, void* stream) {
  if (w < 1 || w > kMaxWindow || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = rows_a_block(w);
  const int groups = w <= kNarrow ? kWarps : 1;
  const size_t smem = (groups * (w + 1) + kWarps) * sizeof(int);
  const unsigned blocks = static_cast<unsigned>(cdf_rows_blocks(n, w));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* b = static_cast<const long long*>(base);
  const float* m = static_cast<const float*>(mu);
  const float* sg = static_cast<const float*>(sigma);
  const float* qq = static_cast<const float*>(q);
  unsigned short* o = static_cast<unsigned short*>(out);
  double* f = static_cast<double*>(fout);
  int* bd = static_cast<int*>(bad);
  if (w <= kNarrow) {
    cdf_rows_kernel<32><<<blocks, kThreads, smem, s>>>(b, m, sg, qq, n, w,
                                                       rows, o, f, bd);
  } else {
    cdf_rows_kernel<kThreads><<<blocks, kThreads, smem, s>>>(
        b, m, sg, qq, n, w, rows, o, f, bd);
  }
  return static_cast<int>(cudaGetLastError());
}
