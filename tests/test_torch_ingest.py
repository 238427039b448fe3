"""Port ingest path vs the JAX reference: the chunker scan (hashes and
both candidate maps), FastCDC boundaries, the sub-chunk stage and the
fused feature extraction. Integer stages are exact; features to 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunking as ref_chunking
from repro.core import features as ref_features
from repro.core import hashing as ref_hashing
from repro.data import workloads as ref_workloads
from repro.kernels import ingest as ref_ingest
from repro_torch.api.store import chunk_with
from repro_torch.core import chunking, features
from repro_torch.kernels import ingest, ops

torch.set_num_threads(1)

RAGGED = [1, 2, 31, 32, 33, 5, 700, 8192, 40000, 17]


def _case(sizes, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    stream = rng.integers(0, 256, size=sum(sizes), dtype=np.uint8)
    offsets = np.cumsum([0] + list(sizes[:-1])).astype(np.int64)
    return stream, ref_hashing.gear_hashes_np(stream), offsets


# 2^16 + 1 is just above a power of two (the reference's bucket doubles
# there); 70,015 is one short of a multiple of 128 (the port's scan length)
@pytest.mark.parametrize("n", [5000, 70_000, 65_537, 70_015])
def test_scan_stream_vs_reference(n):
    data = np.random.Generator(np.random.PCG64(n)).integers(0, 256, size=n, dtype=np.uint8)
    cfg = chunking.ChunkerConfig(avg_size=1024)
    scan, cs, cl = ingest.scan_stream(data, cfg.mask_s, cfg.mask_l, "cpu")
    rscan, rcs, rcl = ref_ingest.scan_stream(data, cfg.mask_s, cfg.mask_l)
    assert len(scan) == n
    assert np.array_equal(np.asarray(scan), np.asarray(rscan))
    assert np.array_equal(scan[100:200], rscan[100:200])
    assert np.array_equal(cs, rcs) and np.array_equal(cl, rcl)
    # the device-resident scan is padded to a multiple of 128 only, not to
    # the reference's pow2 bucket; the hashes below n are the reference's
    spad = scan.device.shape[0]
    assert spad % 128 == 0 and n <= spad < n + 128 and spad <= rscan.device.shape[0]


@pytest.mark.parametrize("name", ["sql_dump", "vmdk", "kernel"])
def test_boundaries_vs_serial_fastcdc(name):
    stream = ref_workloads.make_workload(
        name, ref_workloads.WorkloadConfig(base_size=256 << 10, versions=1))[0]
    cfg = chunking.ChunkerConfig(avg_size=2048)
    chunks, scan = chunk_with(cfg, stream, "cpu")
    bounds = [0] + [c.offset + c.length for c in chunks]
    want = ref_chunking.chunk_boundaries_serial(
        stream, ref_chunking.ChunkerConfig(avg_size=2048))
    assert np.array_equal(np.asarray(bounds), want)
    assert b"".join(c.data for c in chunks) == stream
    assert np.array_equal(np.asarray(scan),
                          ref_hashing.gear_hashes_np(np.frombuffer(stream, np.uint8)))


@pytest.mark.parametrize("sizes,lmax_floor", [
    (RAGGED, 0),                              # two-tier segment max
    ([1, 2, 31, 32, 33, 5, 300, 17], 0),      # dense gather (Lmax 512)
    ([5, 100, 31, 8192, 999], 32768),         # Lmax pinned by the chunker
])
def test_subchunk_stage_is_bit_identical(sizes, lmax_floor):
    """Sub-chunk maxgear and shingle ids equal the reference's per-chunk
    numpy oracle -> shingle_ids, including chunks under the warm-up."""
    stream, h, offs = _case(sizes, seed=len(sizes))
    k, n = 32, 2
    for size in sizes:
        assert np.array_equal(features._bounds(size, k), ref_features._bounds(size, k))
    sub_ref = np.stack([ref_features.subchunk_maxgear_np(h[o:o + s], k)
                        for o, s in zip(offs, sizes)])
    ids_ref = np.asarray(ref_features.shingle_ids(jnp.asarray(sub_ref), n))
    sh = torch.zeros(features.bucket_pow2(len(h), 1 << 16), dtype=torch.int64)
    sh[:len(h)] = torch.from_numpy(h.astype(np.int64))
    lmax = features.bucket_pow2(max(sizes), max(1, lmax_floor))
    sub = ingest.subchunk_maxgear(sh, torch.from_numpy(offs),
                                  torch.tensor(sizes, dtype=torch.int64), k, lmax)
    assert np.array_equal(sub.numpy().astype(np.uint32), sub_ref)
    ids = features.shingle_ids(sub, n)
    assert np.array_equal(ids.numpy().astype(np.uint32), ids_ref)
    s, first = features.unique_mask(ids)
    rs, rfirst = ref_features.unique_mask(jnp.asarray(ids_ref))
    assert np.array_equal(s.numpy().astype(np.uint32), np.asarray(rs))
    assert np.array_equal(first.numpy(), np.asarray(rfirst))


EXTRACT_SIZES = {
    0: RAGGED,
    1: [4096, 3000, 9000, 64, 12000, 2500],
    2: [30000, 20000, 15537],       # n = 2^16 + 1, the last chunk ends at n
    3: [8192, 40000, 21823],        # n = 70,015, one short of 547 x 128
}


@pytest.mark.parametrize("seed", sorted(EXTRACT_SIZES))
def test_extract_stream_vs_reference(seed):
    sizes = EXTRACT_SIZES[seed]
    stream, h, offs = _case(sizes, seed=seed)
    a, b = ref_hashing.multiply_shift_params(64)
    want = ref_ingest.extract_stream(h, offs, np.asarray(sizes), jnp.asarray(a),
                                     jnp.asarray(b), k=32, n=2, use_kernel=True)
    ext = features.FeatureExtractor(features.FeatureConfig(k=32, m=64, n=2), device="cpu")
    scan, _, _ = ingest.scan_stream(stream, 0xFF, 0xF, "cpu")
    assert np.array_equal(np.asarray(scan), h)
    got = ext.features_from_stream(scan, offs, np.asarray(sizes)).numpy()
    assert got.shape == want.shape == (len(sizes), 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_embed_plain_route_vs_reference_embed_shingles():
    """The one plain version of the embed (``ops.shingle_embed`` on CPU
    tensors) against the reference's jnp ``embed_shingles_j``."""
    rng = np.random.Generator(np.random.PCG64(11))
    ids = np.sort(rng.integers(0, 2**32, size=(6, 61), dtype=np.uint32), axis=1)
    mask = rng.random((6, 61)) < 0.7
    mask[2] = False
    a, b = ref_hashing.multiply_shift_params(64)
    want = np.asarray(ref_features.embed_shingles_j(
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b)))
    bits = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))
    got = ops.shingle_embed(bits(ids), torch.from_numpy(mask), bits(a), bits(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(got[2].abs().max()) == 0.0


def test_extract_limits():
    ext = features.FeatureExtractor(features.FeatureConfig(k=8, m=16, n=2), device="cpu")
    scan, _, _ = ingest.scan_stream(np.zeros(10, np.uint8), 0xFF, 0xF, "cpu")
    empty = ext.features_from_stream(scan, np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert tuple(empty.shape) == (0, 16)
    with pytest.raises(ValueError, match="FUSED_STREAM_LIMIT"):
        ingest.extract_stream(scan, np.asarray([ingest.FUSED_STREAM_LIMIT]),
                              np.asarray([10]), ext._a, ext._b, k=8, n=2)
