"""The fused wire extraction (kmer/cuda_kernels.py `extract_wire_planes`)
against the JAX package's composition of the same work.

The reference's group step unpacks each packed batch
(dsk_tpu.io.packed.unpack_codes_exc_jnp / unpack_codes_jnp), extracts its
canonical planes with the Pallas kernel (`extract_canonical_planes_tpu`,
run here in interpret mode as tests/test_pallas_kernels.py runs it) and
sentinels the windows of other passes (pass_hash_planes % n_passes !=
pass_id).  On the CPU the port's plain version is held to that, bit for
bit (tolerance 0: integer keys), for both wires, every word-split regime
of k up to 127, n_passes 1 and 3 with every pass_id, dead tails, dead
rows, rows with exactly E exceptions, exceptions on both sides of the CUDA
kernel's tile boundary, rows not a multiple of 32 bases, and a short group
whose buffer columns past it must stay untouched.  A numpy emulation of
the CUDA kernel's window build (funnel shifts of the wire, pair reversal,
top-word mask, tile-local validity bitmap) is held to the plain version
for every k in 1..127.

The `cuda` tests hold the kernel to the plain version and skip without a
GPU and nvcc; run them on the card with:
    python -m pytest --noconftest -q tests/test_torch_wire_extract.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from dsk_tpu_torch.io.packed import pack_codes_exc_numpy, pack_codes_numpy
from dsk_tpu_torch.kmer import cuda_kernels as ck
from dsk_tpu_torch.kmer.codec import words_per_kmer

torch.set_num_threads(1)

KS = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127]
PASSES = [(1, 0), (3, 0), (3, 1), (3, 2)]
WIRES = ["exc", "bitmap"]
E = 16
GUARD = 0x12345678  # buffer value past the group: must survive
WTILE = 1024        # windows per block of the CUDA kernel (csrc/extract.cu)
M32 = np.uint64(0xFFFFFFFF)


def _rows(rng, B, L, dense):
    """(B, L) codes cycling through the row kinds of the kernel's cases:
    clean, a dead tail (live < L), all invalid (live 0), exactly E
    invalid bases, and invalid bases on both sides of the CUDA kernel's
    tile boundary (window WTILE).  `dense` adds 30% N's (bitmap wire)."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    for r in range(B):
        kind = r % 5
        if kind == 1:
            codes[r, rng.integers(1, L):] = 4
        elif kind == 2:
            codes[r] = 4
        elif kind == 3:
            codes[r, rng.choice(L - 1, size=E, replace=False)] = 4
        elif kind == 4:
            at = WTILE if L > WTILE + 8 else L // 2
            codes[r, [at - 5, at - 1, at + 2, at + 6]] = 4
    if dense:
        codes[rng.random((B, L)) < 0.3] = 4
    return codes


def _group(seed, n, B, L, wire):
    """n packed batches as numpy (words uint32, meta uint16 or uint32)."""
    rng = np.random.default_rng(seed)
    words, meta = [], []
    for _ in range(n):
        codes = _rows(rng, B, L, dense=wire == "bitmap")
        w, m = (pack_codes_exc_numpy(codes, E) if wire == "exc"
                else pack_codes_numpy(codes))
        words.append(w)
        meta.append(m)
    return np.stack(words), np.stack(meta)


def _ship(a: np.ndarray) -> torch.Tensor:
    """As the engine's feeder ships wire arrays: unsigned bits in the
    signed dtype of the same width."""
    signed = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
    return torch.from_numpy(np.ascontiguousarray(a).view(signed[a.dtype]))


def _buffer(k, n_cols, extra=7, device="cpu"):
    return torch.full((words_per_kmer(k), n_cols + extra), GUARD,
                      dtype=torch.int64, device=device)


def _port(words, meta, wire, k, L, n_passes, pass_id, extra=7):
    n, B = words.shape[:2]
    out = _buffer(k, n * B * (L - k + 1), extra)
    ck.extract_wire_planes_torch(_ship(words), _ship(meta), wire, k, L, out,
                                 n_passes, pass_id)
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _jax_extract(seed, n, B, L, wire, k):
    """The reference's unpack -> Pallas extraction (interpret) per batch:
    ((W, n * m) uint32 planes, (n * m,) valid).  JAX is imported here,
    so that the `cuda` tests also run where JAX is not installed."""
    import jax.numpy as jnp

    from dsk_tpu.io.packed import unpack_codes_exc_jnp, unpack_codes_jnp
    from dsk_tpu.kmer.pallas_kernels import extract_canonical_planes_tpu

    words, meta = _group(seed, n, B, L, wire)
    unpack = unpack_codes_exc_jnp if wire == "exc" else unpack_codes_jnp
    planes, valid = [], []
    for g in range(n):
        codes = unpack(jnp.asarray(words[g]), jnp.asarray(meta[g]), L)
        p, v = extract_canonical_planes_tpu(codes, k, interpret=True)
        planes.append(np.asarray(p).reshape(p.shape[0], -1))
        valid.append(np.asarray(v).reshape(-1))
    return np.concatenate(planes, axis=1), np.concatenate(valid)


def _jax_group(seed, n, B, L, wire, k, n_passes, pass_id):
    """The reference's maybe_pass_filter on top of _jax_extract."""
    import jax.numpy as jnp

    from dsk_tpu.kmer.device import pass_hash_planes as jax_pass_hash

    flat, valid = _jax_extract(seed, n, B, L, wire, k)
    if n_passes <= 1:
        return flat
    h = np.asarray(jax_pass_hash(tuple(jnp.asarray(p) for p in flat)))
    keep = valid & (h % np.uint32(n_passes) == np.uint32(pass_id))
    return np.where(keep[None, :], flat, np.uint32(0xFFFFFFFF))


def _assert_port_matches_jax(seed, n, B, L, wire, k, n_passes, pass_id):
    words, meta = _group(seed, n, B, L, wire)
    got = _port(words, meta, wire, k, L, n_passes, pass_id)
    want = _jax_group(seed, n, B, L, wire, k, n_passes, pass_id)
    cols = want.shape[1]
    np.testing.assert_array_equal(got[:, :cols], want.astype(np.int64))
    assert (got[:, cols:] == GUARD).all()


@pytest.mark.parametrize("n_passes,pass_id", PASSES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("wire", WIRES)
def test_plain_matches_jax_composition(wire, k, n_passes, pass_id):
    _assert_port_matches_jax(k, 2, 10, 300, wire, k, n_passes, pass_id)


@pytest.mark.parametrize("k", [1, 31, 127])
@pytest.mark.parametrize("wire", WIRES)
def test_plain_matches_jax_across_tile_boundary(wire, k):
    """Rows longer than one kernel tile (WTILE windows), invalid bases
    just before and after window WTILE."""
    _assert_port_matches_jax(500 + k, 1, 5, WTILE + 276, wire, k, 3, 1)


@pytest.mark.parametrize("wire", WIRES)
def test_short_group_leaves_later_columns(wire):
    """A final group of n < G batches fills n * m columns of a G-batch
    buffer; the rest keep what they held."""
    k, L, B, G = 31, 96, 5, 4
    words, meta = _group(7, 2, B, L, wire)
    m = B * (L - k + 1)
    got = _port(words, meta, wire, k, L, 1, 0, extra=(G - 2) * m)
    want = _jax_group(7, 2, B, L, wire, k, 1, 0)
    np.testing.assert_array_equal(got[:, : 2 * m], want.astype(np.int64))
    assert (got[:, 2 * m:] == GUARD).all()


# -- numpy emulation of the CUDA kernel's window build --------------------


def _funnel_r(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh, sh < 32."""
    x = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (x >> sh.astype(np.uint64)) & M32


def _pair_reverse(x):
    """Reverse the order of the sixteen 2-bit groups of a uint32."""
    out = np.zeros_like(x)
    for i in range(16):
        out |= ((x >> np.uint64(2 * i)) & np.uint64(3)) << np.uint64(
            2 * (15 - i))
    return out


def _pass_hash32(canon):
    """pass_hash_planes in wrapping uint32, as the kernel computes it."""
    h = np.full(canon[0].shape, 0x27220A95, np.uint64)

    def mul(a, c):
        return (a * np.uint64(c)) & M32

    for c in canon:
        h = mul(h ^ c, 0xCC9E2D51)
        h = ((h << np.uint64(15)) & M32) | (h >> np.uint64(17))
        h = mul(h, 0x1B873593)
    h ^= h >> np.uint64(15)
    h = mul(h, 0x2C1B3C6D)
    return h ^ (h >> np.uint64(12))


def _emulate_kernel(words, meta, wire, k, L, n_passes, pass_id, tile):
    """What csrc/extract.cu wire_extract_kernel writes, block by block:
    (W, rows * nw) int64."""
    W = words_per_kmer(k)
    nw = L - k + 1
    rows_w = words.reshape(-1, words.shape[-1]).astype(np.uint64)
    rows_m = meta.reshape(-1, meta.shape[-1]).astype(np.int64)
    span = tile + 127 + 48
    s_code_n, s_valid_n = span // 16 + 2, span // 32 + 2
    r = k - 16 * (W - 1)
    top_mask = np.uint64(0xFFFFFFFF if r == 16 else (1 << (2 * r)) - 1)
    out = np.zeros((W, rows_w.shape[0] * nw), np.int64)
    for row in range(rows_w.shape[0]):
        for start in range(0, nw, tile):
            gi = start // 16 + np.arange(s_code_n)
            s_code = np.where(gi < rows_w.shape[1],
                              rows_w[row, np.minimum(gi, rows_w.shape[1] - 1)],
                              0).astype(np.uint64)
            lo = start + 32 * np.arange(s_valid_n)
            if wire == "exc":
                live = rows_m[row, 0]
                d = np.clip(live - lo, 0, 32)
                bits = np.where(d >= 32, 0xFFFFFFFF, (1 << d) - 1)
                for e in rows_m[row, 1:]:
                    hit = (e - lo >= 0) & (e - lo < 32)
                    bits = np.where(hit, bits & ~(1 << (e - lo) % 32), bits)
                s_valid = bits.astype(np.uint64) & M32
            else:
                gv = start // 32 + np.arange(s_valid_n)
                nb = rows_m.shape[1]
                s_valid = np.where(gv < nb, rows_m[row, np.minimum(gv, nb - 1)],
                                   0).astype(np.uint64) & M32
            t = np.arange(min(tile, nw - start))

            def wire32(b):
                return _funnel_r(s_code[b >> 4], s_code[(b >> 4) + 1],
                                 (b & 15) * 2)

            ok = np.ones(t.shape, bool)
            for c in range(0, k, 32):
                b = t + c
                bits = _funnel_r(s_valid[b >> 5], s_valid[(b >> 5) + 1],
                                 b & 31)
                need = np.uint64(0xFFFFFFFF if k - c >= 32
                                 else (1 << (k - c)) - 1)
                ok &= (bits & need) == need
            rc = [wire32(t + 16 * (W - 1 - v)) ^ np.uint64(0xAAAAAAAA)
                  for v in range(W)]
            rc[0] &= top_mask
            fwd = [_pair_reverse(wire32(t)) >> np.uint64(32 - 2 * r)]
            fwd += [_pair_reverse(wire32(t + r + 16 * (v - 1)))
                    for v in range(1, W)]
            lt = np.zeros(t.shape, bool)
            eq = np.ones(t.shape, bool)
            for f, c in zip(fwd, rc):
                lt |= eq & (f < c)
                eq &= f == c
            canon = [np.where(lt | eq, f, c) for f, c in zip(fwd, rc)]
            if n_passes > 1:
                ok &= _pass_hash32(canon) % np.uint64(n_passes) == pass_id
            cols = row * nw + start + t
            for v in range(W):
                out[v, cols] = np.where(ok, canon[v], 0xFFFFFFFF)
    return out


@pytest.mark.parametrize("k", range(1, 128))
def test_kernel_emulation_matches_plain(k):
    """Every k: both wires, a 64-window tile (so rows span several tiles),
    and the pass filter on for one pass of three."""
    L = 200
    for wire in WIRES:
        words, meta = _group(1000 + k, 1, 5, L, wire)
        for n_passes, pass_id in ((1, 0), (3, k % 3)):
            want = _port(words, meta, wire, k, L, n_passes, pass_id, extra=0)
            got = _emulate_kernel(words, meta, wire, k, L, n_passes, pass_id,
                                  tile=64)
            np.testing.assert_array_equal(got, want)


def test_kernel_emulation_real_tile():
    """The kernel's own tile (WTILE windows) on rows of two tiles."""
    L, k = WTILE + 276, 63
    for wire in WIRES:
        words, meta = _group(3, 1, 5, L, wire)
        want = _port(words, meta, wire, k, L, 3, 2, extra=0)
        got = _emulate_kernel(words, meta, wire, k, L, 3, 2, tile=WTILE)
        np.testing.assert_array_equal(got, want)


# -- wrapper: dispatch, checks, source ------------------------------------


def test_cpu_tensor_takes_plain_path():
    words, meta = _group(5, 2, 4, 64, "exc")
    before = ck.extract_wire_planes.launches
    out = _buffer(31, 2 * 4 * 34)
    ret = ck.extract_wire_planes(_ship(words), _ship(meta), "exc", 31, 64,
                                 out)
    assert ret is out
    want = _port(words, meta, "exc", 31, 64, 1, 0)
    np.testing.assert_array_equal(out.numpy(), want)
    assert ck.extract_wire_planes.launches == before


def test_other_device_raises():
    words = torch.empty((1, 2, 4), dtype=torch.int32, device="meta")
    meta = torch.empty((1, 2, 1 + E), dtype=torch.int16, device="meta")
    out = torch.empty((2, 64), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no wire extraction path"):
        ck.extract_wire_planes(words, meta, "exc", 31, 64, out)


@pytest.mark.parametrize("bad", ["words_dtype", "meta_dtype", "small_out",
                                 "wire", "meta_shape", "out_words"])
def test_wrapper_rejects_bad_inputs(bad):
    words, meta = _group(6, 1, 3, 64, "bitmap")
    w, m = _ship(words), _ship(meta)
    out = _buffer(31, 3 * 34)
    wire = "bitmap"
    if bad == "words_dtype":
        w = w.to(torch.int64)
    elif bad == "meta_dtype":
        m = m.to(torch.int16)
    elif bad == "small_out":
        out = out[:, : 3 * 34 - 1]
    elif bad == "wire":
        wire = "dense"
    elif bad == "meta_shape":
        m = m[:, :, :1]
    elif bad == "out_words":
        out = _buffer(33, 3 * 34)
    with pytest.raises((TypeError, ValueError)):
        ck.extract_wire_planes(w, m, wire, 31, 64, out)


def test_cuda_source_has_the_fused_entry_point():
    with open(ck.EXTRACT_SRC) as f:
        src = f.read()
    assert 'extern "C" int dsk_extract_wire_planes' in src
    assert 'extern "C" int dsk_extract_canonical_planes' in src
    assert f"constexpr int WTILE = {WTILE};" in src


# -- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if ck.find_nvcc() is None:
        pytest.skip("no nvcc")
    ck.build()
    return torch.device("cuda")


def _both(card, words, meta, wire, k, L, n_passes, pass_id, extra=7):
    n, B = words.shape[:2]
    cols = n * B * (L - k + 1)
    w, m = _ship(words).to(card), _ship(meta).to(card)
    got = _buffer(k, cols, extra, card)
    want = _buffer(k, cols, extra, card)
    before = ck.extract_wire_planes.launches
    ck.extract_wire_planes(w, m, wire, k, L, got, n_passes, pass_id)
    ck.extract_wire_planes_torch(w, m, wire, k, L, want, n_passes, pass_id)
    torch.cuda.synchronize()
    assert ck.extract_wire_planes.launches == before + 1
    return got, want, cols


@pytest.mark.cuda
@pytest.mark.parametrize("n_passes,pass_id", PASSES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("wire", WIRES)
def test_kernel_matches_plain(card, wire, k, n_passes, pass_id):
    words, meta = _group(k, 3, 10, 300, wire)
    got, want, cols = _both(card, words, meta, wire, k, 300, n_passes,
                            pass_id)
    assert torch.equal(got, want)
    assert bool((got[:, cols:] == GUARD).all())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_kernel_one_launch_per_group_and_guard(card, wire):
    """A short group (2 of 4 batches) across a tile boundary: one launch,
    the 2 unused batches' columns untouched."""
    k, L, B = 31, WTILE + 276, 5
    m = B * (L - k + 1)
    words, meta = _group(11, 2, B, L, wire)
    got, want, cols = _both(card, words, meta, wire, k, L, 3, 2,
                            extra=2 * m)
    assert torch.equal(got, want)
    assert bool((got[:, cols:] == GUARD).all())
