// Batch Ed25519 verification for the consensus plane's CPU verifier.
//
// Design mirrors the TPU fused-comb kernel (ops/comb.py) rather than a
// textbook verify: the host (Python) decompresses each committee pubkey
// ONCE with exact bigint math and passes affine (x, y); the challenge
// scalars k = SHA-512(R||A||M) mod L arrive precomputed (pbft_native.cpp
// challenge_batch). This library evaluates P = [S]B + [k](-A) per item,
// normalizes the whole batch with ONE field inversion (Montgomery batch
// trick), and byte-compares P's canonical encoding against the wire R.
// A non-canonical or off-curve R simply never matches — the same
// (strictest) semantics as the TPU kernel, so the two accelerated
// backends agree bit-for-bit.
//
// NOT constant-time, deliberately: verification consumes public data
// (wire messages, public keys, signatures). Field arithmetic: 5x51-bit
// limbs with unsigned __int128 products — portable g++, no asm.
//
// Reference for parity: crypto/ed25519_cpu.py (RFC 8032 oracle);
// SURVEY.md §7 (crypto plane), BASELINE configs 1-3 (CPU verifier).

#include <cstdint>
#include <cstring>
#include <mutex>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef int64_t i64;

static const u64 MASK51 = ((u64)1 << 51) - 1;

// ---------------------------------------------------------------------------
// fe51: GF(2^255 - 19) as 5 x 51-bit limbs
// ---------------------------------------------------------------------------

struct fe {
    u64 v[5];
};

static inline fe fe_zero() { fe r{}; return r; }
static inline fe fe_one() { fe r{}; r.v[0] = 1; return r; }

static inline fe fe_add(const fe &a, const fe &b) {
    fe r;
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
    return r;
}

// a - b + 4p: the bias must dominate b's limbs, which after an fe_add of
// two carried elements reach 2^52 + eps (> 2p's limb0 of 2^52 - 38, the
// classic underflow trap) — 4p's limbs are ~2^53 and keep every term
// positive while products still fit u128 comfortably
static inline fe fe_sub(const fe &a, const fe &b) {
    fe r;
    r.v[0] = a.v[0] + 0x1FFFFFFFFFFFB4ull - b.v[0];  // 4*(2^51-19)
    r.v[1] = a.v[1] + 0x1FFFFFFFFFFFFCull - b.v[1];  // 4*(2^51-1)
    r.v[2] = a.v[2] + 0x1FFFFFFFFFFFFCull - b.v[2];
    r.v[3] = a.v[3] + 0x1FFFFFFFFFFFFCull - b.v[3];
    r.v[4] = a.v[4] + 0x1FFFFFFFFFFFFCull - b.v[4];
    return r;
}

// weak carry: brings limbs under ~2^52 (enough headroom for adds/subs
// before the next multiply)
static inline fe fe_carry(const fe &a) {
    fe r = a;
    u64 c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
    c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
    c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
    c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
    c = r.v[4] >> 51; r.v[4] &= MASK51; r.v[0] += c * 19;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
    return r;
}

static fe fe_mul(const fe &a, const fe &b) {
    u128 t0, t1, t2, t3, t4;
    u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
    u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
    u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19, b4_19 = b4 * 19;

    t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 +
         (u128)a3 * b2_19 + (u128)a4 * b1_19;
    t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 +
         (u128)a3 * b3_19 + (u128)a4 * b2_19;
    t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
         (u128)a3 * b4_19 + (u128)a4 * b3_19;
    t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 +
         (u128)a3 * b0 + (u128)a4 * b4_19;
    t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 +
         (u128)a3 * b1 + (u128)a4 * b0;

    fe r;
    u64 c;
    r.v[0] = (u64)t0 & MASK51; c = (u64)(t0 >> 51);
    t1 += c;
    r.v[1] = (u64)t1 & MASK51; c = (u64)(t1 >> 51);
    t2 += c;
    r.v[2] = (u64)t2 & MASK51; c = (u64)(t2 >> 51);
    t3 += c;
    r.v[3] = (u64)t3 & MASK51; c = (u64)(t3 >> 51);
    t4 += c;
    r.v[4] = (u64)t4 & MASK51; c = (u64)(t4 >> 51);
    r.v[0] += c * 19;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
    return r;
}

static inline fe fe_sq(const fe &a) { return fe_mul(a, a); }

static fe fe_invert(const fe &z) {
    // z^(p-2) via the standard 254-squaring addition chain
    fe z2 = fe_sq(z);                       // 2
    fe z8 = fe_sq(fe_sq(z2));               // 8
    fe z9 = fe_mul(z8, z);                  // 9
    fe z11 = fe_mul(z9, z2);                // 11
    fe z22 = fe_sq(z11);                    // 22
    fe z_5_0 = fe_mul(z22, z9);             // 2^5 - 2^0
    fe t = z_5_0;
    for (int i = 0; i < 5; i++) t = fe_sq(t);
    fe z_10_0 = fe_mul(t, z_5_0);           // 2^10 - 2^0
    t = z_10_0;
    for (int i = 0; i < 10; i++) t = fe_sq(t);
    fe z_20_0 = fe_mul(t, z_10_0);
    t = z_20_0;
    for (int i = 0; i < 20; i++) t = fe_sq(t);
    fe z_40_0 = fe_mul(t, z_20_0);
    t = z_40_0;
    for (int i = 0; i < 10; i++) t = fe_sq(t);
    fe z_50_0 = fe_mul(t, z_10_0);
    t = z_50_0;
    for (int i = 0; i < 50; i++) t = fe_sq(t);
    fe z_100_0 = fe_mul(t, z_50_0);
    t = z_100_0;
    for (int i = 0; i < 100; i++) t = fe_sq(t);
    fe z_200_0 = fe_mul(t, z_100_0);
    t = z_200_0;
    for (int i = 0; i < 50; i++) t = fe_sq(t);
    fe z_250_0 = fe_mul(t, z_50_0);
    t = z_250_0;
    for (int i = 0; i < 5; i++) t = fe_sq(t);
    return fe_mul(t, z11);                  // 2^255 - 21
}

static fe fe_frombytes(const uint8_t s[32]) {
    u64 lo0, lo1, lo2, lo3;
    memcpy(&lo0, s, 8);
    memcpy(&lo1, s + 8, 8);
    memcpy(&lo2, s + 16, 8);
    memcpy(&lo3, s + 24, 8);
    fe r;
    r.v[0] = lo0 & MASK51;
    r.v[1] = ((lo0 >> 51) | (lo1 << 13)) & MASK51;
    r.v[2] = ((lo1 >> 38) | (lo2 << 26)) & MASK51;
    r.v[3] = ((lo2 >> 25) | (lo3 << 39)) & MASK51;
    r.v[4] = (lo3 >> 12) & MASK51;  // drops the sign bit (bit 255)
    return r;
}

// full reduction to [0, p) then serialize little-endian
static void fe_tobytes(uint8_t out[32], const fe &a) {
    fe t = fe_carry(fe_carry(a));
    // add 19 and see if it overflows 2^255 => t >= p
    u64 q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;
    t.v[0] += 19 * q;
    u64 c;
    c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
    c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
    c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
    c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
    t.v[4] &= MASK51;
    u64 lo0 = t.v[0] | (t.v[1] << 51);
    u64 lo1 = (t.v[1] >> 13) | (t.v[2] << 38);
    u64 lo2 = (t.v[2] >> 26) | (t.v[3] << 25);
    u64 lo3 = (t.v[3] >> 39) | (t.v[4] << 12);
    memcpy(out, &lo0, 8);
    memcpy(out + 8, &lo1, 8);
    memcpy(out + 16, &lo2, 8);
    memcpy(out + 24, &lo3, 8);
}

static inline bool fe_isodd(const fe &a) {
    uint8_t b[32];
    fe_tobytes(b, a);
    return b[0] & 1;
}

// ---------------------------------------------------------------------------
// Group: extended coordinates (X, Y, Z, T), a = -1 twisted Edwards
// ---------------------------------------------------------------------------

struct ge {
    fe X, Y, Z, T;
};

// precomputed point in affine Niels form: (y+x, y-x, 2dxy)
struct ge_aff {
    fe ypx, ymx, xy2d;
};

// precomputed point in projective Niels form: (Y+X, Y-X, Z, 2dT)
struct ge_proj {
    fe YpX, YmX, Z, T2d;
};

// 2d mod p
static fe fe_d2() {
    static const uint8_t D2[32] = {
        0x59, 0xf1, 0xb2, 0x26, 0x94, 0x9b, 0xd6, 0xeb, 0x56, 0xb1, 0x83,
        0x82, 0x9a, 0x14, 0xe0, 0x00, 0x30, 0xd1, 0xf3, 0xee, 0xf2, 0x80,
        0x8e, 0x19, 0xe7, 0xfc, 0xdf, 0x56, 0xdc, 0xd9, 0x06, 0x24};
    return fe_frombytes(D2);
}

static ge ge_identity() {
    ge r;
    r.X = fe_zero();
    r.Y = fe_one();
    r.Z = fe_one();
    r.T = fe_zero();
    return r;
}

// dbl-2008-hwcd with a = -1 (so D = -A):
//   E = (X+Y)^2 - (A+B); G = D + B = B - A; F = G - C; H = D - B = -(A+B)
static ge ge_dbl(const ge &p) {
    fe A = fe_sq(p.X);
    fe B = fe_sq(p.Y);
    fe C = fe_mul(fe_sq(p.Z), fe_add(fe_one(), fe_one()));
    fe AB = fe_add(A, B);
    fe H = fe_sub(fe_zero(), AB);
    fe E = fe_sub(fe_sq(fe_add(p.X, p.Y)), AB);
    fe G = fe_sub(B, A);
    fe F = fe_sub(G, C);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

// mixed add with affine Niels: 7M
static ge ge_madd(const ge &p, const ge_aff &q) {
    fe A = fe_mul(fe_add(p.Y, p.X), q.ypx);
    fe B = fe_mul(fe_sub(p.Y, p.X), q.ymx);
    fe C = fe_mul(q.xy2d, p.T);
    fe D = fe_add(p.Z, p.Z);
    fe E = fe_sub(A, B);
    fe F = fe_sub(D, C);
    fe G = fe_add(D, C);
    fe H = fe_add(A, B);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

// full add with projective Niels: 8M
static ge ge_padd(const ge &p, const ge_proj &q) {
    fe A = fe_mul(fe_add(p.Y, p.X), q.YpX);
    fe B = fe_mul(fe_sub(p.Y, p.X), q.YmX);
    fe C = fe_mul(q.T2d, p.T);
    fe D = fe_mul(p.Z, q.Z);
    fe D2 = fe_add(D, D);
    fe E = fe_sub(A, B);
    fe F = fe_sub(D2, C);
    fe G = fe_add(D2, C);
    fe H = fe_add(A, B);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

static ge ge_psub(const ge &p, const ge_proj &q) {
    fe A = fe_mul(fe_add(p.Y, p.X), q.YmX);
    fe B = fe_mul(fe_sub(p.Y, p.X), q.YpX);
    fe C = fe_mul(q.T2d, p.T);
    fe D = fe_mul(p.Z, q.Z);
    fe D2 = fe_add(D, D);
    fe E = fe_sub(A, B);
    fe F = fe_add(D2, C);
    fe G = fe_sub(D2, C);
    fe H = fe_add(A, B);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

static ge_proj ge_to_proj(const ge &p) {
    ge_proj r;
    r.YpX = fe_carry(fe_add(p.Y, p.X));
    r.YmX = fe_carry(fe_sub(p.Y, p.X));
    r.Z = p.Z;
    r.T2d = fe_mul(p.T, fe_d2());
    return r;
}

// ---------------------------------------------------------------------------
// Fixed-base comb table for B: 64 positions x 16 nibble entries, affine
// Niels — built once at first use (exactly the ops/comb.py layout).
// ---------------------------------------------------------------------------

static ge_aff BASE_TABLE[64][16];
static std::once_flag base_once;

// B's standard affine coordinates (single definition — both the comb
// table and the fused-table builder start from these)
static const uint8_t BX[32] = {
    0x1a, 0xd5, 0x25, 0x8f, 0x60, 0x2d, 0x56, 0xc9, 0xb2, 0xa7, 0x25,
    0x95, 0x60, 0xc7, 0x2c, 0x69, 0x5c, 0xdc, 0xd6, 0xfd, 0x31, 0xe2,
    0xa4, 0xc0, 0xfe, 0x53, 0x6e, 0xcd, 0xd3, 0x36, 0x69, 0x21};
static const uint8_t BY[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66};

static ge ge_basepoint() {
    ge base;
    base.X = fe_frombytes(BX);
    base.Y = fe_frombytes(BY);
    base.Z = fe_one();
    base.T = fe_mul(base.X, base.Y);
    return base;
}

static void build_base_table() {
    ge base = ge_basepoint();

    // entries in extended coords first, batch-normalize at the end
    static ge ext[64][16];
    ge cur = base;  // 16^pos * B
    for (int pos = 0; pos < 64; pos++) {
        ge_proj curp = ge_to_proj(cur);
        ge acc = ge_identity();
        for (int w = 0; w < 16; w++) {
            ext[pos][w] = acc;
            acc = ge_padd(acc, curp);
        }
        cur = acc;  // 16 * (16^pos * B)
    }
    // batch inversion of all 1024 Z's
    static fe zs[1024], pre[1025];
    pre[0] = fe_one();
    for (int i = 0; i < 1024; i++) {
        zs[i] = ext[i / 16][i % 16].Z;
        pre[i + 1] = fe_mul(pre[i], zs[i]);
    }
    fe inv = fe_invert(pre[1024]);
    for (int i = 1023; i >= 0; i--) {
        fe zinv = fe_mul(pre[i], inv);
        inv = fe_mul(inv, zs[i]);
        ge &e = ext[i / 16][i % 16];
        fe x = fe_mul(e.X, zinv);
        fe y = fe_mul(e.Y, zinv);
        ge_aff &a = BASE_TABLE[i / 16][i % 16];
        a.ypx = fe_carry(fe_add(y, x));
        a.ymx = fe_carry(fe_sub(y, x));
        a.xy2d = fe_mul(fe_mul(x, y), fe_d2());
    }
}

// ---------------------------------------------------------------------------
// w-NAF (w=5) recoding: scalar (little-endian 32B, < L so < 2^253)
// -> digits[256], each 0 or odd in [-15, 15]
// ---------------------------------------------------------------------------

static int scalar_wnaf(const uint8_t s[32], int8_t naf[257]) {
    int bits[257];
    for (int i = 0; i < 256; i++) bits[i] = (s[i >> 3] >> (i & 7)) & 1;
    bits[256] = 0;
    memset(naf, 0, 257);
    int top = -1;
    int i = 0;
    while (i < 257) {
        if (!bits[i]) { i++; continue; }
        // gather 5 bits
        int val = 0;
        for (int j = 0; j < 5 && i + j < 257; j++) val |= bits[i + j] << j;
        if (val > 16) {
            val -= 32;
            // propagate carry
            int j = i + 5;
            while (j < 257) {
                if (!bits[j]) { bits[j] = 1; break; }
                bits[j] = 0;
                j++;
            }
        }
        naf[i] = (int8_t)val;
        top = i;
        for (int j = 1; j < 5 && i + j < 257; j++) bits[i + j] = 0;
        i += 5;
    }
    return top;
}

// ---------------------------------------------------------------------------
// Entry point
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Fused dual-scalar comb table construction (KeyBank cold-start path).
//
// Mirrors ops/comb.py fused_table_np: row[i*4^w + ws*2^w + wk] =
// (ws * 2^(w*i)) B + (wk * 2^(w*i)) (-A), emitted as affine Niels
// (y+x, y-x, 2dxy) 32-byte LE field elements (96 B/entry) — Python
// converts to the TPU limb packing with its existing vectorized path.
// The Python bigint build costs ~0.2 s/key at w=4 (~2 s at w=6); this
// native build is ~milliseconds, making a cold n=64 committee bank a
// sub-second affair instead of tens of seconds.
// ---------------------------------------------------------------------------

static ge ge_neg(const ge &p) {
    ge r = p;
    r.X = fe_carry(fe_sub(fe_zero(), p.X));
    r.T = fe_carry(fe_sub(fe_zero(), p.T));
    return r;
}

extern "C" int ed25519_fused_table(
    const uint8_t a_xy[64],  // pubkey affine x||y (32B LE each)
    int wbits,               // window bits (4..6)
    uint8_t *out)            // npos * 4^wbits * 96 bytes
{
    if (wbits < 1 || wbits > 8) return -1;
    const int window = 1 << wbits;
    const int fw = window * window;
    const int npos = (256 + wbits - 1) / wbits;
    const int n = npos * fw;

    ge base_b = ge_basepoint();
    ge A;
    A.X = fe_frombytes(a_xy);
    A.Y = fe_frombytes(a_xy + 32);
    A.Z = fe_one();
    A.T = fe_mul(A.X, A.Y);
    ge base_a = ge_neg(A);

    ge *ext = new ge[n];
    int idx = 0;
    for (int pos = 0; pos < npos; pos++) {
        ge_proj bp = ge_to_proj(base_b);
        ge_proj ap = ge_to_proj(base_a);
        ge row_b = ge_identity();
        for (int ws = 0; ws < window; ws++) {
            ge acc = row_b;
            for (int wk = 0; wk < window; wk++) {
                ext[idx++] = acc;
                acc = ge_padd(acc, ap);
            }
            row_b = ge_padd(row_b, bp);
        }
        for (int d = 0; d < wbits; d++) {
            base_b = ge_dbl(base_b);
            base_a = ge_dbl(base_a);
        }
    }

    // batch-invert all Z's, emit affine Niels bytes (ext stays live
    // through the backward pass, so Z is read in place)
    fe *prefix = new fe[n + 1];
    prefix[0] = fe_one();
    for (int i = 0; i < n; i++) {
        prefix[i + 1] = fe_mul(prefix[i], ext[i].Z);
    }
    fe inv = fe_invert(prefix[n]);
    fe d2 = fe_d2();
    for (int i = n - 1; i >= 0; i--) {
        fe zinv = fe_mul(prefix[i], inv);
        inv = fe_mul(inv, ext[i].Z);
        fe x = fe_mul(ext[i].X, zinv);
        fe y = fe_mul(ext[i].Y, zinv);
        uint8_t *o = out + (size_t)i * 96;
        fe_tobytes(o, fe_add(y, x));
        fe_tobytes(o + 32, fe_sub(y, x));
        fe_tobytes(o + 64, fe_mul(fe_mul(x, y), d2));
    }
    delete[] prefix;
    delete[] ext;
    return 0;
}

extern "C" int ed25519_batch_verify(
    const uint8_t *a_xy,       // n_keys * 64: affine x||y (32B LE each)
    int n_keys,
    const int32_t *key_idx,    // batch
    const uint8_t *s_scalars,  // batch * 32 (already checked < L)
    const uint8_t *k_scalars,  // batch * 32 (SHA-512(R||A||M) mod L)
    const uint8_t *r_wire,     // batch * 32 (signature R, raw wire bytes)
    const uint8_t *precheck,   // batch (0 = already invalid)
    uint8_t *out,              // batch (written 0/1)
    int batch)
{
    std::call_once(base_once, build_base_table);
    if (n_keys < 0 || batch < 0) return -1;

    // per-key projective-Niels tables of odd multiples 1A,3A,...,15A
    ge_proj (*ktab)[8] = new ge_proj[n_keys > 0 ? n_keys : 1][8];
    for (int kk = 0; kk < n_keys; kk++) {
        ge A;
        A.X = fe_frombytes(a_xy + kk * 64);
        A.Y = fe_frombytes(a_xy + kk * 64 + 32);
        A.Z = fe_one();
        A.T = fe_mul(A.X, A.Y);
        ge A2 = ge_dbl(A);
        ge_proj A2p = ge_to_proj(A2);
        ge cur = A;
        for (int m = 0; m < 8; m++) {
            ktab[kk][m] = ge_to_proj(cur);      // (2m+1) A
            cur = ge_padd(cur, A2p);
        }
    }

    fe *zs = new fe[batch];
    fe *xs = new fe[batch];
    fe *ys = new fe[batch];
    uint8_t *alive = new uint8_t[batch];

    for (int b = 0; b < batch; b++) {
        alive[b] = 0;
        out[b] = 0;
        if (!precheck[b]) continue;
        int kk = key_idx[b];
        if (kk < 0 || kk >= n_keys) continue;

        // acc = [S]B via the base comb (64 madds, no doublings)
        const uint8_t *s = s_scalars + b * 32;
        ge acc = ge_identity();
        for (int pos = 0; pos < 64; pos++) {
            int nib = (s[pos >> 1] >> ((pos & 1) * 4)) & 0xF;
            if (nib) acc = ge_madd(acc, BASE_TABLE[pos][nib]);
        }

        // acc += [k](-A): w-NAF ladder over k, SUBTRACTING multiples of A
        int8_t naf[257];
        int top = scalar_wnaf(k_scalars + b * 32, naf);
        if (top >= 0) {
            ge t = ge_identity();
            bool started = false;
            for (int i = top; i >= 0; i--) {
                if (started) t = ge_dbl(t);
                int8_t d = naf[i];
                if (d > 0) {
                    t = ge_psub(t, ktab[kk][(d - 1) >> 1]);   // -= dA
                    started = true;
                } else if (d < 0) {
                    t = ge_padd(t, ktab[kk][(-d - 1) >> 1]);  // += |d|A
                    started = true;
                }
            }
            // acc += t  (t = [k](-A), extended + extended via proj Niels)
            acc = ge_padd(acc, ge_to_proj(t));
        }
        xs[b] = acc.X;
        ys[b] = acc.Y;
        zs[b] = acc.Z;
        alive[b] = 1;
    }

    // Montgomery batch inversion over the live Z's
    fe run = fe_one();
    fe *prefix = new fe[batch + 1];
    prefix[0] = run;
    for (int b = 0; b < batch; b++) {
        if (alive[b]) run = fe_mul(run, zs[b]);
        prefix[b + 1] = run;
    }
    fe inv = fe_invert(run);
    for (int b = batch - 1; b >= 0; b--) {
        if (!alive[b]) continue;
        fe zinv = fe_mul(prefix[b], inv);
        inv = fe_mul(inv, zs[b]);
        fe x = fe_mul(xs[b], zinv);
        fe y = fe_mul(ys[b], zinv);
        uint8_t enc[32];
        fe_tobytes(enc, y);
        enc[31] |= (uint8_t)(fe_isodd(x) << 7);
        out[b] = memcmp(enc, r_wire + b * 32, 32) == 0;
    }

    delete[] prefix;
    delete[] alive;
    delete[] ys;
    delete[] xs;
    delete[] zs;
    delete[] ktab;
    return 0;
}
