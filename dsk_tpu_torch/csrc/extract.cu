// Canonical k-mer window extraction for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dsk_tpu/kmer/pallas_kernels.py
// `_extract_kernel` (launched by `extract_canonical_planes_tpu`).  Same
// contract: (B, L) uint8 codes (0..3 = A, C, T, G; >= 4 invalid) ->
// (W, B, nw) canonical word planes, nw = L - k + 1, W = ceil(2k / 32),
// word 0 most significant and holding the top r = k - 16 (W - 1) bases,
// plus a (B, nw) valid mask.  A window is the word-by-word min of its
// forward and reverse-complement encodings; a window that touches an
// invalid base is all-sentinel (0xFFFFFFFF in every word).  Planes are
// written as int64 holding 0..2^32-1 (the port's key dtype,
// dsk_tpu_torch/kmer/layout.py), with no widening pass afterwards.
//
// Design.  One block per tile of TILE windows of one row.  The block
// stages the tile's TILE + k - 1 codes (the k - 1 halo) in shared memory;
// each thread then builds its window's W forward and W reverse-complement
// words straight from shared memory, compares them word by word, and
// writes its W plane words and its valid byte.  Neighbouring threads own
// neighbouring windows, so every plane store is coalesced.
//
// What bounds it on this card: bytes written.  Each window costs 1 byte
// read but W * 8 bytes of planes plus 1 byte of valid written (17 B at
// k = 31), and its arithmetic is ~4k shift-or ops from shared memory.  The
// TPU kernel's doubling "prefix-pack" exists to keep VMEM temporaries
// bounded; here a window lives in registers, so the direct per-window
// build is simpler and costs nothing in memory traffic.  The count's main
// path no longer launches this kernel: it runs the fused wire kernel below
// (dsk_extract_wire_planes), which reads the packed wire and writes the
// flush buffer in one pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;       // windows per block (= threads per block)
constexpr int MAX_K = 127;      // W <= 8
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

// The canonical choice of a window, shared by both kernels: forward when
// fwd <= rc as W-word numbers compared most significant word first.
template <int W>
__device__ __forceinline__ bool fwd_is_canonical(const uint32_t (&fwd)[W],
                                                 const uint32_t (&rc)[W]) {
  bool lt = false, eq = true;
#pragma unroll
  for (int v = 0; v < W; ++v) {
    lt = lt || (eq && fwd[v] < rc[v]);
    eq = eq && fwd[v] == rc[v];
  }
  return lt || eq;
}

template <int W>
__global__ void extract_kernel(const uint8_t* __restrict__ codes,
                               int64_t* __restrict__ planes,
                               uint8_t* __restrict__ valid_out,
                               int64_t B, int64_t L, int k, int64_t tiles) {
  __shared__ uint8_t s[TILE + MAX_K];
  const int64_t row = blockIdx.x / tiles;
  const int64_t start = (blockIdx.x % tiles) * TILE;
  const int64_t nw = L - k + 1;
  const uint8_t* src = codes + row * L;
  const int span = TILE + k - 1;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int64_t g = start + i;
    s[i] = g < L ? src[g] : uint8_t(0xFF);
  }
  __syncthreads();

  const int64_t p = start + threadIdx.x;
  if (p >= nw) return;
  const uint8_t* w = s + threadIdx.x;
  const int r = k - 16 * (W - 1);  // bases in word 0, 1..16

  bool ok = true;
  for (int j = 0; j < k; ++j) ok &= w[j] <= 3;

  uint32_t fwd[W];
  uint32_t rc[W];
  // forward word v holds bases [jstart, jstart + len), most significant
  // first: word 0 = bases 0..r-1, word v >= 1 = bases r+16(v-1)..+15
#pragma unroll
  for (int v = 0; v < W; ++v) {
    const int jstart = v == 0 ? 0 : r + 16 * (v - 1);
    const int len = v == 0 ? r : 16;
    uint32_t f = 0;
    for (int j = jstart; j < jstart + len; ++j) f = (f << 2) | (w[j] & 3u);
    fwd[v] = f;
  }
  // reverse complement: complemented base j sits at global bit 2j, so
  // word v holds bases 16(W-1-v) .. min(+15, k-1), the highest base most
  // significant
#pragma unroll
  for (int v = 0; v < W; ++v) {
    const int jlo = 16 * (W - 1 - v);
    const int jhi = v == 0 ? k - 1 : jlo + 15;
    uint32_t x = 0;
    for (int j = jhi; j >= jlo; --j) x = (x << 2) | ((w[j] & 3u) ^ 2u);
    rc[v] = x;
  }

  const bool use_fwd = fwd_is_canonical<W>(fwd, rc);
  const int64_t plane = B * nw;
  const int64_t off = row * nw + p;
#pragma unroll
  for (int v = 0; v < W; ++v) {
    const uint32_t c = ok ? (use_fwd ? fwd[v] : rc[v]) : SENTINEL;
    planes[v * plane + off] = static_cast<int64_t>(c);
  }
  valid_out[off] = ok ? 1 : 0;
}

template <int W>
void launch(const uint8_t* codes, int64_t* planes, uint8_t* valid, int64_t B,
            int64_t L, int k, cudaStream_t stream) {
  const int64_t nw = L - k + 1;
  const int64_t tiles = (nw + TILE - 1) / TILE;
  const int64_t blocks = B * tiles;
  extract_kernel<W><<<dim3(static_cast<unsigned>(blocks)), TILE, 0, stream>>>(
      codes, planes, valid, B, L, k, tiles);
}

}  // namespace

extern "C" int dsk_extract_canonical_planes(const void* codes, void* planes,
                                            void* valid, long long B,
                                            long long L, int k,
                                            void* stream) {
  if (k < 1 || k > MAX_K || L < k || B < 1) return int(cudaErrorInvalidValue);
  if (B * ((L - k + 256) / 256) > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  const int W = (2 * k + 31) / 32;
  auto c = static_cast<const uint8_t*>(codes);
  auto p = static_cast<int64_t*>(planes);
  auto v = static_cast<uint8_t*>(valid);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(c, p, v, B, L, k, s); break;
    case 2: launch<2>(c, p, v, B, L, k, s); break;
    case 3: launch<3>(c, p, v, B, L, k, s); break;
    case 4: launch<4>(c, p, v, B, L, k, s); break;
    case 5: launch<5>(c, p, v, B, L, k, s); break;
    case 6: launch<6>(c, p, v, B, L, k, s); break;
    case 7: launch<7>(c, p, v, B, L, k, s); break;
    case 8: launch<8>(c, p, v, B, L, k, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Fused wire -> flush-buffer extraction, one launch per flush group.
//
// Replaces, on the count's main path, the TPU kernel `_extract_kernel`
// (dsk_tpu/kmer/pallas_kernels.py) together with the reference's per-step
// wire unpack and pass filter (`unpack_codes_exc_jnp` / `unpack_codes_jnp`
// and `maybe_pass_filter`, dsk_tpu/dist/engine.py:441-454, 956-963).  In:
// the group's packed rows as they arrive from the host (16-base uint32 code
// words, base i at bits 2 (i % 16) of word i / 16, LSB first) and their
// validity, either the "exc" meta (live length + up to E invalid positions,
// uint16, padded with 0xFFFF) or the dense validity bitmap (bit i of word
// i / 32).  Out: every window's W canonical words, written in place into
// the caller's (W, stride) int64 flush buffer at column row * nw + p;
// all-sentinel where the window touches an invalid base or, with
// n_passes > 1, where pass_hash(window) % n_passes != pass_id.
//
// What bounds it on this card: bytes written.  At 2048 x 1024 bases, k = 31,
// a batch reads 0.6 MB of wire and writes 32.6 MB of int64 planes; the
// arithmetic is O(W) integer operations a window.
//
// What the design does about it.  No intermediate touches device memory:
// no byte codes, no unfiltered planes, no valid mask, no second copy into
// the buffer.  A block owns WTILE windows of one row; it stages the tile's
// wire words (WTILE / 16 + a halo) and a tile-local validity bitmap in
// shared memory, a few hundred bytes, with plain coalesced loads: TMA would
// save nothing on a copy that small, and every block's loads are ~2% of
// its stores.  Each thread then builds its window's words from the wire
// directly.  The wire is 2 bits a base LSB first, so the reverse
// complement is the stream itself (complemented base j at bit 2j): word
// W-1-u is a funnel shift of two consecutive wire words from base p + 16u,
// xor 0xAAAAAAAA (A<C<T<G: complement = code ^ 2), the top word masked to
// 2r bits (r = k - 16 (W - 1)).  The forward words are the same bits with
// the 2-bit groups reversed (__brev, then a swap inside each pair).  The
// window is valid iff its k bits of the validity bitmap are set, tested
// 32 at a time with funnel shifts, which serves both wires.  The pass hash
// runs in registers.  Neighbouring threads own neighbouring windows, so
// each plane store is a coalesced 256-byte run a warp.

namespace {

constexpr int WTILE = 1024;              // windows per block
constexpr int WTHREADS = 256;             // threads per block
constexpr int WSPAN = WTILE + MAX_K + 48;  // bases a tile may touch, rounded
constexpr int S_CODE = WSPAN / 16 + 2;     // staged code words
constexpr int S_VALID = WSPAN / 32 + 2;    // staged validity words

__device__ __forceinline__ uint32_t pair_reverse(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
}

// bits [2 b, 2 b + 32) of the staged wire: bases b .. b + 15, base b lowest
__device__ __forceinline__ uint32_t wire32(const uint32_t* s, int b) {
  return __funnelshift_r(s[b >> 4], s[(b >> 4) + 1], (b & 15) * 2);
}

// dsk_tpu_torch/kmer/device.py pass_hash_planes, in uint32
template <int W>
__device__ __forceinline__ uint32_t pass_hash(const uint32_t (&c)[W]) {
  uint32_t h = 0x27220A95u;
#pragma unroll
  for (int v = 0; v < W; ++v) {
    h = (h ^ c[v]) * 0xCC9E2D51u;
    h = (h << 15) | (h >> 17);
    h = h * 0x1B873593u;
  }
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  return h ^ (h >> 12);
}

template <int W, bool EXC>
__global__ void __launch_bounds__(WTHREADS)
wire_extract_kernel(const uint32_t* __restrict__ words,
                    const uint16_t* __restrict__ meta_exc,
                    const uint32_t* __restrict__ meta_bits,
                    int64_t* __restrict__ out, int64_t row_len,
                    int words_per_row, int meta_cols, int k, int n_passes,
                    int pass_id, int64_t tiles, int64_t stride) {
  __shared__ uint32_t s_code[S_CODE];
  __shared__ uint32_t s_valid[S_VALID];
  const int64_t row = blockIdx.x / tiles;
  const int64_t start = (blockIdx.x % tiles) * WTILE;  // a multiple of 32
  const int64_t nw = row_len - k + 1;

  const uint32_t* src = words + row * words_per_row;
  const int64_t w0 = start / 16;
  for (int i = threadIdx.x; i < S_CODE; i += blockDim.x) {
    const int64_t g = w0 + i;
    s_code[i] = g < words_per_row ? src[g] : 0u;
  }
  const int64_t v0 = start / 32;
  if (EXC) {
    const uint16_t* m = meta_exc + row * meta_cols;
    const int64_t live = m[0];
    for (int i = threadIdx.x; i < S_VALID; i += blockDim.x) {
      const int64_t lo = start + 32 * int64_t(i);  // first position of word i
      uint32_t bits = live >= lo + 32 ? 0xFFFFFFFFu
                      : live <= lo    ? 0u
                                      : (1u << (live - lo)) - 1u;
      for (int e = 1; e < meta_cols; ++e) {
        const int64_t d = int64_t(m[e]) - lo;
        if (d >= 0 && d < 32) bits &= ~(1u << d);
      }
      s_valid[i] = bits;
    }
  } else {
    const uint32_t* m = meta_bits + row * meta_cols;
    for (int i = threadIdx.x; i < S_VALID; i += blockDim.x) {
      const int64_t g = v0 + i;
      s_valid[i] = g < meta_cols ? m[g] : 0u;
    }
  }
  __syncthreads();

  const int r = k - 16 * (W - 1);  // bases in word 0, 1..16
  const uint32_t top_mask = r == 16 ? 0xFFFFFFFFu : (1u << (2 * r)) - 1u;
  const int64_t col0 = row * nw;
  for (int t = threadIdx.x; t < WTILE; t += WTHREADS) {
    const int64_t p = start + t;
    if (p >= nw) break;
    bool ok = true;
    for (int c = 0; c < k; c += 32) {
      const int b = t + c;
      const uint32_t bits =
          __funnelshift_r(s_valid[b >> 5], s_valid[(b >> 5) + 1], b & 31);
      const int nb = k - c;
      const uint32_t need = nb >= 32 ? 0xFFFFFFFFu : (1u << nb) - 1u;
      ok = ok && (bits & need) == need;
    }
    uint32_t fwd[W];
    uint32_t rc[W];
#pragma unroll
    for (int v = 0; v < W; ++v) {
      // rc word v: bases 16 (W-1-v) .. +15, complemented, highest base top
      rc[v] = wire32(s_code, t + 16 * (W - 1 - v)) ^ 0xAAAAAAAAu;
      // forward word 0: bases 0..r-1; word v >= 1: bases r + 16 (v-1) .. +15
      fwd[v] = v == 0 ? pair_reverse(wire32(s_code, t)) >> (32 - 2 * r)
                      : pair_reverse(wire32(s_code, t + r + 16 * (v - 1)));
    }
    rc[0] &= top_mask;
    const bool use_fwd = fwd_is_canonical<W>(fwd, rc);
    uint32_t canon[W];
#pragma unroll
    for (int v = 0; v < W; ++v) canon[v] = use_fwd ? fwd[v] : rc[v];
    if (n_passes > 1)
      ok = ok && pass_hash<W>(canon) % uint32_t(n_passes) == uint32_t(pass_id);
    int64_t* o = out + col0 + p;
#pragma unroll
    for (int v = 0; v < W; ++v)
      o[v * stride] = static_cast<int64_t>(ok ? canon[v] : SENTINEL);
  }
}

template <int W>
void launch_wire(const void* words, const void* meta, void* out, bool exc,
                 int64_t rows, int64_t row_len, int words_per_row,
                 int meta_cols, int k, int n_passes, int pass_id,
                 int64_t tiles, int64_t stride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(rows * tiles));
  auto w = static_cast<const uint32_t*>(words);
  auto o = static_cast<int64_t*>(out);
  if (exc)
    wire_extract_kernel<W, true><<<grid, WTHREADS, 0, stream>>>(
        w, static_cast<const uint16_t*>(meta), nullptr, o, row_len,
        words_per_row, meta_cols, k, n_passes, pass_id, tiles, stride);
  else
    wire_extract_kernel<W, false><<<grid, WTHREADS, 0, stream>>>(
        w, nullptr, static_cast<const uint32_t*>(meta), o, row_len,
        words_per_row, meta_cols, k, n_passes, pass_id, tiles, stride);
}

}  // namespace

// rows: the group's batches x rows per batch; the windows of row i land in
// columns i * (row_len - k + 1) + p of each of the W planes of `out`, a
// row-major (W, stride) int64 tensor.  exc != 0: meta is (rows, meta_cols)
// uint16 exc meta; else (rows, meta_cols) uint32 validity bitmap words.
extern "C" int dsk_extract_wire_planes(const void* words, const void* meta,
                                       void* out, long long rows,
                                       long long row_len, int words_per_row,
                                       int meta_cols, int exc, int k,
                                       int n_passes, int pass_id,
                                       long long stride, void* stream) {
  if (k < 1 || k > MAX_K || row_len < k || rows < 1 || n_passes < 1 ||
      pass_id < 0 || int64_t(words_per_row) * 16 < row_len || meta_cols < 1 ||
      (!exc && int64_t(meta_cols) * 32 < row_len))
    return int(cudaErrorInvalidValue);
  const int64_t nw = row_len - k + 1;
  const int64_t tiles = (nw + WTILE - 1) / WTILE;
  if (rows * tiles > 0x7FFFFFFFLL || stride < rows * nw)
    return int(cudaErrorInvalidValue);
  const int W = (2 * k + 31) / 32;
  auto s = static_cast<cudaStream_t>(stream);
  const bool e = exc != 0;
  switch (W) {
#define DSK_WIRE_CASE(n)                                                   \
  case n:                                                                  \
    launch_wire<n>(words, meta, out, e, rows, row_len, words_per_row,      \
                   meta_cols, k, n_passes, pass_id, tiles, stride, s);     \
    break;
    DSK_WIRE_CASE(1) DSK_WIRE_CASE(2) DSK_WIRE_CASE(3) DSK_WIRE_CASE(4)
    DSK_WIRE_CASE(5) DSK_WIRE_CASE(6) DSK_WIRE_CASE(7) DSK_WIRE_CASE(8)
#undef DSK_WIRE_CASE
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
