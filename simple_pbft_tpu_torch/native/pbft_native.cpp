// Native host-prep kernels for the TPU verifier's batch pipeline.
//
// The consensus plane drains thousands of pending votes per sweep; before
// the device can verify them, each item needs its challenge scalar
// k = SHA-512(R || A || M) mod L. In Python that is ~3 us/item of
// GIL-bound work (hashlib releases the GIL only for large buffers), which
// caps end-to-end throughput far below the device's verify rate
// (BASELINE.md: >= 1M verifies/s = 1 us/item total). This library computes
// the whole challenge batch in C++ with OpenMP — one call per batch, no
// Python loop, all cores.
//
// Contents:
//   - SHA-512 (FIPS 180-4; constants generated from integer cube/square
//     roots of the first 80 primes, validated against hashlib in
//     tests/test_native.py)
//   - sc_reduce: 512-bit little-endian digest -> canonical scalar mod
//     L = 2^252 + 27742317777372353535851937790883648493 (signed fold at
//     the 2^252 boundary: n = hi*2^252 + lo == lo - hi*C (mod L), C 125
//     bits, so magnitudes shrink ~127 bits per fold)
//   - challenge_batch / sha512_batch: OpenMP-parallel batch drivers over
//     flat numpy buffers (no per-item allocation).
//
// The reference implements none of this (it has no signatures at all —
// reference utils/utils.go:13-17 is its entire crypto surface); this
// is new TPU-framework infrastructure, not a port.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// SHA-512
// ---------------------------------------------------------------------------

constexpr uint64_t kInitH[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

constexpr uint64_t kK[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

inline uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
  return v;
}

inline void store_be64(uint8_t* p, uint64_t v) {
  for (int i = 7; i >= 0; --i) {
    p[i] = static_cast<uint8_t>(v & 0xff);
    v >>= 8;
  }
}

struct Sha512Ctx {
  uint64_t h[8];
  uint8_t buf[128];
  uint64_t total;  // bytes fed so far (messages here are << 2^61)
  unsigned fill;
};

void sha512_compress(uint64_t h[8], const uint8_t* block) {
  uint64_t w[80];
  for (int i = 0; i < 16; ++i) w[i] = load_be64(block + 8 * i);
  for (int i = 16; i < 80; ++i) {
    uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
    uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int i = 0; i < 80; ++i) {
    uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = hh + S1 + ch + kK[i] + w[i];
    uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
    uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + maj;
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

void sha512_init(Sha512Ctx* c) {
  std::memcpy(c->h, kInitH, sizeof(kInitH));
  c->total = 0;
  c->fill = 0;
}

void sha512_update(Sha512Ctx* c, const uint8_t* data, uint64_t len) {
  c->total += len;
  if (c->fill) {
    unsigned take = 128 - c->fill;
    if (take > len) take = static_cast<unsigned>(len);
    std::memcpy(c->buf + c->fill, data, take);
    c->fill += take;
    data += take;
    len -= take;
    if (c->fill == 128) {
      sha512_compress(c->h, c->buf);
      c->fill = 0;
    }
  }
  while (len >= 128) {
    sha512_compress(c->h, data);
    data += 128;
    len -= 128;
  }
  if (len) {
    std::memcpy(c->buf, data, len);
    c->fill = static_cast<unsigned>(len);
  }
}

void sha512_final(Sha512Ctx* c, uint8_t out[64]) {
  uint64_t bits = c->total * 8;
  uint8_t pad = 0x80;
  sha512_update(c, &pad, 1);
  uint8_t zero = 0;
  while (c->fill != 112) sha512_update(c, &zero, 1);
  uint8_t lenbuf[16] = {0};
  store_be64(lenbuf + 8, bits);  // bits was captured before padding
  sha512_update(c, lenbuf, 16);
  for (int i = 0; i < 8; ++i) store_be64(out + 8 * i, c->h[i]);
}

// ---------------------------------------------------------------------------
// Scalar reduction mod L (Ed25519 group order)
// ---------------------------------------------------------------------------

// L = 2^252 + C, C = 0x14def9dea2f79cd6'5812631a5cf5d3ed (125 bits)
constexpr uint64_t kC0 = 0x5812631a5cf5d3edULL;
constexpr uint64_t kC1 = 0x14def9dea2f79cd6ULL;
constexpr uint64_t kL[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0ULL,
                            0x1000000000000000ULL};

// Fixed-width little-endian bignum, 9 x 64-bit limbs (enough for 512-bit
// inputs and every intermediate below).
struct Big {
  uint64_t v[9];
};

int big_cmp(const Big& a, const Big& b) {
  for (int i = 8; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i] ? 1 : -1;
  }
  return 0;
}

// a -= b, requires a >= b
void big_sub(Big& a, const Big& b) {
  unsigned __int128 borrow = 0;
  for (int i = 0; i < 9; ++i) {
    unsigned __int128 d =
        (unsigned __int128)a.v[i] - b.v[i] - (uint64_t)borrow;
    a.v[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

bool big_is_zero(const Big& a) {
  for (int i = 0; i < 9; ++i)
    if (a.v[i]) return false;
  return true;
}

// out = hi * C where hi has up to 5 limbs; out fits 7 limbs.
void mul_by_c(const uint64_t hi[5], Big& out) {
  std::memset(out.v, 0, sizeof(out.v));
  unsigned __int128 carry = 0;
  for (int i = 0; i < 6; ++i) {
    unsigned __int128 acc = carry;
    carry = 0;
    if (i < 5) acc += (unsigned __int128)hi[i] * kC0;
    if (i >= 1 && i - 1 < 5) acc += (unsigned __int128)hi[i - 1] * kC1;
    // acc can overflow 128 bits only if both products near max — they
    // can't: kC1 < 2^61 and kC0 < 2^63, so acc < 2^127 + carry.
    out.v[i] = (uint64_t)acc;
    carry = acc >> 64;
  }
  out.v[6] = (uint64_t)carry;
}

// digest (64 bytes little-endian) -> canonical scalar mod L (32 bytes LE)
void sc_reduce(const uint8_t in[64], uint8_t out[32]) {
  Big m;
  std::memset(m.v, 0, sizeof(m.v));
  for (int i = 0; i < 8; ++i) {
    uint64_t w = 0;
    for (int j = 7; j >= 0; --j) w = (w << 8) | in[8 * i + j];
    m.v[i] = w;
  }
  int sign = 1;  // value == sign * m (mod L)
  for (;;) {
    // split at 2^252: hi = m >> 252 (<= 260 bits), lo = m mod 2^252
    uint64_t hi[5];
    for (int i = 0; i < 5; ++i) {
      uint64_t lo_part = (i + 3 < 9) ? (m.v[i + 3] >> 60) : 0;
      uint64_t hi_part = (i + 4 < 9) ? (m.v[i + 4] << 4) : 0;
      hi[i] = lo_part | hi_part;
    }
    bool hi_zero = !(hi[0] | hi[1] | hi[2] | hi[3] | hi[4]);
    if (hi_zero) break;
    Big lo;
    std::memset(lo.v, 0, sizeof(lo.v));
    for (int i = 0; i < 3; ++i) lo.v[i] = m.v[i];
    lo.v[3] = m.v[3] & 0x0fffffffffffffffULL;
    Big prod;
    mul_by_c(hi, prod);  // m == sign*(lo - prod) (mod L)
    if (big_cmp(lo, prod) >= 0) {
      m = lo;
      big_sub(m, prod);
    } else {
      m = prod;
      big_sub(m, lo);
      sign = -sign;
    }
  }
  // m < 2^252 < L
  if (sign < 0 && !big_is_zero(m)) {
    Big l;
    std::memset(l.v, 0, sizeof(l.v));
    for (int i = 0; i < 4; ++i) l.v[i] = kL[i];
    big_sub(l, m);
    m = l;
  }
  for (int i = 0; i < 4; ++i) {
    uint64_t w = m.v[i];
    for (int j = 0; j < 8; ++j) {
      out[8 * i + j] = (uint8_t)(w & 0xff);
      w >>= 8;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Exported batch entry points (ctypes ABI: flat buffers + offsets)
// ---------------------------------------------------------------------------

extern "C" {

// k[i] = SHA-512(r[i] || a[i] || msg[i]) mod L, little-endian 32 bytes.
// r, a: n*32 bytes. msgs: concatenated message bytes; offs: n+1 int64
// prefix offsets into msgs. out: n*32 bytes.
void challenge_batch(const uint8_t* r, const uint8_t* a, const uint8_t* msgs,
                     const int64_t* offs, int64_t n, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    Sha512Ctx c;
    sha512_init(&c);
    sha512_update(&c, r + 32 * i, 32);
    sha512_update(&c, a + 32 * i, 32);
    sha512_update(&c, msgs + offs[i], (uint64_t)(offs[i + 1] - offs[i]));
    uint8_t digest[64];
    sha512_final(&c, digest);
    sc_reduce(digest, out + 32 * i);
  }
}

// digests[i] = SHA-512(msgs[offs[i]:offs[i+1]]) — generic batch hasher.
void sha512_batch(const uint8_t* msgs, const int64_t* offs, int64_t n,
                  uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    Sha512Ctx c;
    sha512_init(&c);
    sha512_update(&c, msgs + offs[i], (uint64_t)(offs[i + 1] - offs[i]));
    sha512_final(&c, out + 64 * i);
  }
}

// out[i] = in[i] mod L for 64-byte little-endian digests — exported so the
// reduction's boundary behavior (sign flips, m == 0, values straddling L
// and 2^252) is directly testable, not only through SHA-512 outputs.
void sc_reduce_batch(const uint8_t* in, int64_t n, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) sc_reduce(in + 64 * i, out + 32 * i);
}

int native_num_threads(void) {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}
}
