"""The port's one-device engine against dsk_tpu's DistCountEngine on a
one-device CPU mesh (same plan, same input).

Exact comparisons throughout: kmers, counts and histograms are integers.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dsk_tpu.dist.engine import AXIS
from dsk_tpu.dist.engine import DistCountEngine as JaxEngine
from dsk_tpu.dist.engine import TableOverflow as JaxTableOverflow
from dsk_tpu_torch.dist.engine import DistCountEngine, TableOverflow

torch.set_num_threads(1)

K27 = "read50x_ref10K_e001.fasta.gz"
PLAN = dict(batch_rows=32, row_len=128, table_cap=1 << 17, buf_batches=4)


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), (AXIS,))


def _assert_same(a, b):
    np.testing.assert_array_equal(a.kmers, b.kmers)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.histogram, b.histogram)


@pytest.mark.parametrize("k,n_passes", [(31, 1), (31, 3), (63, 1)])
def test_matches_jax_engine(data_dir, k, n_passes):
    uri = str(data_dir / K27)
    want = JaxEngine(k, mesh=_mesh1(), n_passes=n_passes, **PLAN).count(uri)
    got = DistCountEngine(k, device="cpu", n_passes=n_passes, **PLAN).count(uri)
    _assert_same(got, want)
    assert got.info["n_bases"] == want.info["n_bases"]


def test_table_overflow_raises_like_jax(data_dir):
    uri = str(data_dir / K27)
    small = dict(PLAN, table_cap=1 << 15)
    with pytest.raises(JaxTableOverflow) as je:
        JaxEngine(27, mesh=_mesh1(), **small).count(uri)
    with pytest.raises(TableOverflow) as te:
        DistCountEngine(27, device="cpu", **small).count(uri)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kwargs", [
    dict(flush_buckets=2), dict(flush_mode="merge", per_bank=True),
    dict(flush_mode="merge"), dict(flush_buckets=4),
])
def test_unported_modes_raise(data_dir, kwargs):
    # flush_mode="merge" is not ported and raises; flush_buckets > 1 is
    # ported: the engine builds and counts what dsk_tpu counts, in its
    # bucket-major order (tests/test_torch_buckets.py holds the rest)
    if kwargs.get("flush_mode") == "merge":
        with pytest.raises(NotImplementedError):
            DistCountEngine(31, device="cpu", **kwargs)
        return
    uri = str(data_dir / "readN.fasta")
    small = dict(PLAN, table_cap=1 << 14)
    want = JaxEngine(31, mesh=_mesh1(), **small, **kwargs).count(uri)
    eng = DistCountEngine(31, device="cpu", **small, **kwargs)
    assert eng.plan.S == kwargs["flush_buckets"]
    _assert_same(eng.count(uri), want)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DistCountEngine(31, device="cuda")
