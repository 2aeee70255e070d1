"""Hand-written CUDA kernels of the port, their builds and their wrappers.

Two entry points of csrc/extract.cu replace the TPU's Pallas kernel
dsk_tpu/kmer/pallas_kernels.py `_extract_kernel` (launched there by
`extract_canonical_planes_tpu`); the source's notes say what bounds each
on Hopper:

  * `extract_wire_planes`, the count's main path: one launch per flush
    group reads the packed wire (io/packed.py) and writes the pass-filtered
    canonical planes straight into the flush buffer, doing the work of the
    reference's unpack -> `_extract_kernel` -> pass filter -> append.  Its
    plain version `extract_wire_planes_torch` is that composition.
  * `extract_canonical_planes`, the one-to-one counterpart of
    `_extract_kernel`'s contract ((B, L) uint8 codes in, planes and a valid
    mask out), off the main path.  Its plain version is
    `extract_canonical_planes_torch` (a port of dsk_tpu/kmer/device.py
    `extract_canonical`).

CPU tensors take the plain versions, which the kernels are held against on
the card.  The library of csrc/sortstage.cu (kmer/sortstage.py, the port of
the bitonic-stage probe) is built here too.

Build: nvcc, at first use, one shared library per source with a plain C
interface loaded through ctypes (no PyTorch headers, so a build takes
seconds).  Libraries land in dsk_tpu_torch/_build/, keyed by a hash of
their source (utils/build.py), so a changed source rebuilds and an
unchanged one is reused.  `build()` compiles every kernel source at once,
one nvcc each.  Nothing is built or imported for CUDA when this module is
imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import torch

from dsk_tpu_torch.io.packed import packed_shapes, unpack_codes, unpack_codes_exc
from dsk_tpu_torch.kmer.codec import words_per_kmer
from dsk_tpu_torch.kmer.device import pass_hash_planes
from dsk_tpu_torch.kmer.layout import KEY_DTYPE, SENTINEL
from dsk_tpu_torch.utils.build import (  # noqa: F401
    BUILD_DIR,
    build_library,
    library_path,
)

SRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
EXTRACT_SRC = os.path.join(SRC_DIR, "extract.cu")
SORTSTAGE_SRC = os.path.join(SRC_DIR, "sortstage.cu")
SOURCES = (EXTRACT_SRC, SORTSTAGE_SRC)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
MAX_K = 127

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str | None:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH (None if absent)."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    return shutil.which("nvcc")


def nvcc_command(nvcc: str, src: str, out: str) -> list[str]:
    """The nvcc command line that builds `src` into the shared library `out`."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src,
    ]


def _nvcc_build(src: str, out: str) -> list[str]:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
            "cannot build the CUDA kernels"
        )
    return nvcc_command(nvcc, src, out)


def load(src: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of `src`.  Raises on
    failure."""
    lib = _libs.get(src)
    if lib is None:
        lib = _libs.setdefault(
            src, ctypes.CDLL(build_library(src, _nvcc_build))
        )
    return lib


def build() -> dict[str, ctypes.CDLL]:
    """Build and load every kernel source, one nvcc each, all started
    together.  Raises on the first failure."""
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        return dict(zip(SOURCES, ex.map(load, SOURCES)))


def _extract_fn():
    fn = load(EXTRACT_SRC).dsk_extract_canonical_planes
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def extract_canonical_planes_torch(
    batch: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch extraction, a port of dsk_tpu/kmer/device.py
    `extract_canonical` in the plane layout: (B, L) uint8 codes ->
    ((W, B, nw) int64 canonical planes, (B, nw) bool valid)."""
    if batch.ndim != 2:
        raise ValueError(f"batch must be (B, L), got {tuple(batch.shape)}")
    B, L = batch.shape
    if L < k:
        raise ValueError(f"row length {L} < k={k}")
    W = words_per_kmer(k)
    nw = L - k + 1
    is_valid = batch <= 3
    codes = torch.where(is_valid, batch, 0).to(KEY_DTYPE)

    # window validity via prefix sums of invalid flags
    cbad = torch.cumsum((~is_valid).to(torch.int32), dim=1)
    cbad0 = torch.nn.functional.pad(cbad, (1, 0))
    valid = (cbad0[:, k:] - cbad0[:, :-k]) == 0

    fwd = [torch.zeros((B, nw), dtype=KEY_DTYPE, device=batch.device)
           for _ in range(W)]
    rc = [torch.zeros_like(fwd[0]) for _ in range(W)]
    for j in range(k):
        base = codes[:, j : j + nw]
        p = 2 * (k - 1 - j)  # forward: base j at global bit 2(k-1-j)
        fwd[W - 1 - p // 32] |= base << (p % 32)
        q = 2 * j  # revcomp: complemented base j at global bit 2j
        rc[W - 1 - q // 32] |= (base ^ 2) << (q % 32)

    lt = torch.zeros((B, nw), dtype=torch.bool, device=batch.device)
    eq = torch.ones_like(lt)
    for w in range(W):
        lt = lt | (eq & (fwd[w] < rc[w]))
        eq = eq & (fwd[w] == rc[w])
    use_fwd = lt | eq
    canon = [
        torch.where(valid, torch.where(use_fwd, fwd[w], rc[w]), SENTINEL)
        for w in range(W)
    ]
    return torch.stack(canon), valid


def _extract_cuda(codes: torch.Tensor, k: int):
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    if codes.ndim != 2:
        raise ValueError(f"codes must be (B, L), got {tuple(codes.shape)}")
    B, L = codes.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}")
    if L < k:
        raise ValueError(f"row length {L} < k={k}")
    codes = codes.contiguous()
    W = words_per_kmer(k)
    nw = L - k + 1
    planes = torch.empty((W, B, nw), dtype=KEY_DTYPE, device=codes.device)
    valid = torch.empty((B, nw), dtype=torch.bool, device=codes.device)
    fn = _extract_fn()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = fn(
            codes.data_ptr(), planes.data_ptr(), valid.data_ptr(),
            B, L, k, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"extract kernel launch failed: CUDA error {err} "
            f"(B={B}, L={L}, k={k})"
        )
    extract_canonical_planes.launches += 1
    return planes, valid


def extract_canonical_planes(
    codes: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L) uint8 codes -> ((W, B, nw) int64 planes, (B, nw) bool valid).

    A CUDA tensor launches the hand kernel (csrc/extract.cu) and counts
    the launch in `extract_canonical_planes.launches`; a CPU tensor takes
    the plain PyTorch version; any other device raises."""
    if codes.device.type == "cuda":
        return _extract_cuda(codes, k)
    if codes.device.type == "cpu":
        return extract_canonical_planes_torch(codes, k)
    raise ValueError(f"no extraction path for device {codes.device}")


extract_canonical_planes.launches = 0


def _wire_fn():
    fn = load(EXTRACT_SRC).dsk_extract_wire_planes
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_wire(words, meta, wire, k, row_len, out, n_passes, pass_id):
    """Validate a flush group's wire and its buffer; return the windows a
    batch fills (m = B * nw)."""
    if wire not in ("exc", "bitmap"):
        raise ValueError(f"unknown wire format {wire!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}")
    if row_len < k:
        raise ValueError(f"row length {row_len} < k={k}")
    if n_passes < 1 or not 0 <= pass_id < 2**31:
        raise ValueError(f"bad pass selection {pass_id} of {n_passes}")
    nw_p, nb_p = packed_shapes(row_len)
    meta_dtype = torch.int16 if wire == "exc" else torch.int32
    if words.dtype != torch.int32 or meta.dtype != meta_dtype:
        raise TypeError(
            f"{wire} wire wants int32 words and {meta_dtype} meta, got "
            f"{words.dtype} and {meta.dtype}"
        )
    if words.ndim != 3 or words.shape[-1] != nw_p:
        raise ValueError(
            f"words must be (n, B, {nw_p}), got {tuple(words.shape)}"
        )
    if (meta.ndim != 3 or meta.shape[:2] != words.shape[:2]
            or (wire == "bitmap" and meta.shape[-1] != nb_p)
            or meta.shape[-1] < 1):
        raise ValueError(f"meta shape {tuple(meta.shape)} does not fit the "
                         f"{wire} wire of words {tuple(words.shape)}")
    W = words_per_kmer(k)
    m = words.shape[1] * (row_len - k + 1)
    if (out.dtype != KEY_DTYPE or out.ndim != 2 or out.shape[0] != W
            or out.shape[1] < words.shape[0] * m):
        raise ValueError(
            f"out must be ({W}, >= {words.shape[0] * m}) {KEY_DTYPE}, got "
            f"{tuple(out.shape)} {out.dtype}"
        )
    if not words.device == meta.device == out.device:
        raise ValueError("words, meta and out must share a device")
    return m


def extract_wire_planes_torch(
    words: torch.Tensor, meta: torch.Tensor, wire: str, k: int,
    row_len: int, out: torch.Tensor, n_passes: int = 1, pass_id: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of `extract_wire_planes`, the composition the
    reference runs per scan step: unpack each batch (io/packed.py), extract
    its canonical planes, sentinel the windows of other passes, and assign
    them into `out`'s columns [g * m, (g + 1) * m).  Returns `out`."""
    m = _check_wire(words, meta, wire, k, row_len, out, n_passes, pass_id)
    unpack = unpack_codes_exc if wire == "exc" else unpack_codes
    W = words_per_kmer(k)
    for g in range(words.shape[0]):
        planes, valid = extract_canonical_planes_torch(
            unpack(words[g], meta[g], row_len), k
        )
        flat, valid = planes.reshape(W, m), valid.reshape(m)
        if n_passes > 1:
            keep = valid & (pass_hash_planes(flat) % n_passes == pass_id)
            flat = torch.where(keep, flat, SENTINEL)
        out[:, g * m : (g + 1) * m] = flat
    return out


def _wire_cuda(words, meta, wire, k, row_len, out, n_passes, pass_id):
    m = _check_wire(words, meta, wire, k, row_len, out, n_passes, pass_id)
    if not (words.is_contiguous() and meta.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("the wire kernel takes contiguous words, meta and out")
    n, B, nw_p = words.shape
    fn = _wire_fn()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            words.data_ptr(), meta.data_ptr(), out.data_ptr(), n * B,
            row_len, nw_p, meta.shape[-1], int(wire == "exc"), k, n_passes,
            pass_id, out.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"wire extract kernel launch failed: CUDA error {err} (n={n}, "
            f"B={B}, row_len={row_len}, k={k}, wire={wire})"
        )
    extract_wire_planes.launches += 1
    return out


def extract_wire_planes(
    words: torch.Tensor, meta: torch.Tensor, wire: str, k: int,
    row_len: int, out: torch.Tensor, n_passes: int = 1, pass_id: int = 0,
) -> torch.Tensor:
    """One flush group of packed batches -> canonical planes in the flush
    buffer, IN PLACE: `out[v, g * m + r * nw + p]` becomes word v of window
    p of row r of batch g (m = B * nw, nw = row_len - k + 1), all-sentinel
    where the window touches an invalid base or, when n_passes > 1, where
    pass_hash % n_passes != pass_id.  Columns >= n * m are not touched.

    words: (n, B, nw_p) int32 holding the uint32 code words; meta: the
    "exc" wire's (n, B, 1 + E) int16 (uint16 bits) or the "bitmap" wire's
    (n, B, nb_p) int32 (io/packed.py); out: (W, >= n * m) int64.  Returns
    `out`.  A CUDA tensor launches the fused kernel (csrc/extract.cu) and
    counts it in `extract_wire_planes.launches`; a CPU tensor takes
    `extract_wire_planes_torch`; any other device raises."""
    if out.device.type == "cuda":
        return _wire_cuda(words, meta, wire, k, row_len, out, n_passes,
                          pass_id)
    if out.device.type == "cpu":
        return extract_wire_planes_torch(words, meta, wire, k, row_len, out,
                                         n_passes, pass_id)
    raise ValueError(f"no wire extraction path for device {out.device}")


extract_wire_planes.launches = 0
