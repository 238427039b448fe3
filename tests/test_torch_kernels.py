"""Kernels B and C of the port: plain versions vs the reference Pallas
kernels in interpret mode, over the shape sweeps of tests/test_kernels.py;
the wrappers' device dispatch and launch counters; and, on a machine with
an NVIDIA card, each CUDA kernel against its plain version.

Tolerances: embed 1e-5; scores 1e-4 (fp32 sums in another order), argmax
exact."""
import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref_hashing
from repro.kernels import shingle_embed as ref_shingle
from repro.kernels import sim_topk as ref_topk
from repro_torch.core import features, hashing
from repro_torch.kernels import _build, gear_hash, ops, shingle_embed, sim_topk

torch.set_num_threads(1)


def _embed_inputs(b, s, m, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    ids = rng.integers(0, 2**32, size=(b, s), dtype=np.uint32)
    mask = rng.random((b, s)) < 0.8
    a, bb = ref_hashing.multiply_shift_params(m)
    return ids, mask, a, bb


def _bits(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


@pytest.mark.parametrize("b,s,m", [(1, 61, 64), (8, 61, 64), (13, 61, 50),
                                   (32, 200, 80), (7, 130, 40)])
def test_shingle_embed_plain_vs_pallas(b, s, m):
    ids, mask, a, bb = _embed_inputs(b, s, m, b * 100 + s + m)
    want = np.asarray(ref_shingle.shingle_embed_sum(
        jnp.asarray(ids), jnp.asarray(mask.astype(np.float32)),
        jnp.asarray(a).reshape(1, -1), jnp.asarray(bb).reshape(1, -1), interpret=True))
    got = shingle_embed.shingle_embed_sum_plain(_bits(ids), torch.from_numpy(mask),
                                                _bits(a), _bits(bb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper's epilogue: mean over unmasked shingles, then normalise
    feat = ops.shingle_embed(_bits(ids), torch.from_numpy(mask), _bits(a), _bits(bb))
    cnt = np.maximum(mask.sum(-1, keepdims=True), 1)
    mean = want / cnt
    want_feat = mean / (np.linalg.norm(mean, axis=-1, keepdims=True) + 1e-12)
    np.testing.assert_allclose(feat.numpy(), want_feat, rtol=1e-5, atol=1e-5)


def test_shingle_embed_all_masked_row_is_zero():
    ids, mask, a, bb = _embed_inputs(4, 61, 64, 1)
    mask[1] = False
    out = ops.shingle_embed(_bits(ids), torch.from_numpy(mask), _bits(a), _bits(bb))
    assert float(out[1].abs().max()) == 0.0
    assert float(out[0].abs().max()) > 0.0


@pytest.mark.parametrize("b,n,d", [(1, 100, 50), (8, 1024, 50), (5, 3000, 64),
                                   (16, 257, 80), (9, 5000, 40)])
def test_sim_topk_plain_vs_pallas(b, n, d):
    rng = np.random.Generator(np.random.PCG64(b * 7 + n + d))
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = rng.standard_normal((n, d)).astype(np.float32)
    ws, wa = ref_topk.sim_topk(jnp.asarray(q), jnp.asarray(idx), interpret=True)
    s, a = ops.sim_topk(torch.from_numpy(q), torch.from_numpy(idx))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-4, atol=1e-5)
    assert a.dtype == torch.int32
    assert np.array_equal(a.numpy(), np.asarray(wa))


def test_sim_topk_padding_never_wins():
    q = -np.eye(4, 16, dtype=np.float32)
    idx = np.eye(3, 16, dtype=np.float32)
    _, wa = ref_topk.sim_topk(jnp.asarray(q), jnp.asarray(idx), interpret=True)
    _, a = ops.sim_topk(torch.from_numpy(q), torch.from_numpy(idx))
    assert (a.numpy() < 3).all()
    assert np.array_equal(a.numpy(), np.asarray(wa))


def test_sim_topk_tie_goes_to_lowest_row(monkeypatch):
    """Equal best scores, also across the plain version's index blocks."""
    monkeypatch.setattr(sim_topk, "PLAIN_BLOCK_N", 1000)
    rng = np.random.Generator(np.random.PCG64(2))
    idx = (rng.standard_normal((3000, 16)) * 0.01).astype(np.float32)
    idx[[700, 1500, 2900]] = 1.0
    q = np.ones((8, 16), np.float32)
    ws, wa = ref_topk.sim_topk(jnp.asarray(q), jnp.asarray(idx), interpret=True)
    s, a = ops.sim_topk(torch.from_numpy(q), torch.from_numpy(idx))
    assert (a.numpy() == 700).all() and (np.asarray(wa) == 700).all()
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    ops.reset_launches()
    data = torch.randint(0, 256, (500,), dtype=torch.uint8)
    ops.gear_hashes(data)
    ops.rabin_fps(data)
    ops.scan_candidates(data, 0xFF, 0xF)
    ids, mask, a, bb = _embed_inputs(3, 61, 64, 3)
    ops.shingle_embed(_bits(ids), torch.from_numpy(mask), _bits(a), _bits(bb))
    ops.sim_topk(torch.ones(2, 4), torch.ones(5, 4))
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_build_and_launch_failures_raise(monkeypatch, tmp_path):
    """No nvcc means no library: the build raises, nothing falls back; a
    non-zero CUDA error code from a C entry point raises too."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    _build.check(0, "repro_sim_topk")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(1, "repro_sim_topk")


def test_concurrent_builds_keep_their_objects_apart(monkeypatch, tmp_path):
    """Builds racing on one build directory each compile and link in a
    directory of their own, so each renames a whole library into place and
    leaves no objects behind. A stand-in nvcc writes its -o target."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then echo "$2" > "$2"; fi\n'
                    '  shift\ndone\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: _build.build(), range(4)))
    assert len(set(paths)) == 1
    lib_path = paths[0]
    assert sorted(p.name for p in lib_path.parent.iterdir()) == sorted(
        [lib_path.name, lib_path.with_suffix(".ptxas.log").name])
    # the library is the one its own build linked (named after it)
    assert lib_path.read_text().strip().endswith(lib_path.name)


def test_wrappers_check_inputs():
    with pytest.raises(ValueError):
        ops.gear_hashes(torch.zeros(10, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.sim_topk(torch.ones(2, 4), torch.ones(5, 3))
    with pytest.raises(ValueError):
        ops.sim_topk(torch.ones(2, 4, dtype=torch.float64), torch.ones(5, 4))
    with pytest.raises(ValueError):
        ops.shingle_embed(torch.zeros(2, 3, dtype=torch.int32), torch.ones(2, 4, dtype=torch.bool),
                          torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops._on_cuda(torch.zeros(1, device="meta"))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each kernel against its plain version on the card (launch-checked
    and synchronised); chip_smoke.py runs the same checks at full size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ops.reset_launches()
    # across a thread's run of 32, a block of 8192 and the W-1 halo
    sizes = (1, 15, 16, 31, 32, 33, 47, 48, 100, 8191, 8193, 70_000, 100_000)
    for n in sizes:
        data = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=gen)
        got = ops.scan_candidates(data, 0x1FFF, 0x7F)
        want = gear_hash.scan_plain(data, 0x1FFF, 0x7F)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert torch.equal(ops.gear_hashes(data), want[0])
        for window in (16, 48):
            assert torch.equal(ops.rabin_fps(data, window),
                               gear_hash.rabin_fps_plain(data, window))
        # a stream that does not start 16-byte aligned takes the byte loads
        if n > 1:
            assert torch.equal(ops.gear_hashes(data[1:]), gear_hash.gear_hashes_plain(data[1:]))
    # kernel B's features against the plain sums + epilogue: S across a
    # pass of 64, M 50 / 64 / 256, random masks and sorted first
    # occurrences as unique_mask makes them; row 0 all-masked gives 0
    embeds = ((300, 61, 64, False), (300, 61, 64, True), (129, 200, 64, False),
              (77, 61, 50, True), (40, 130, 256, False), (40, 61, 256, True))
    for rows, s_len, m, unique in embeds:
        ids = torch.randint(-2**31, 2**31 - 1, (rows, s_len), dtype=torch.int32,
                            device=dev, generator=gen)
        if unique:
            # ids drawn from the row's first half, so many repeat
            pick = torch.randint(0, s_len // 2, (rows, s_len), device=dev, generator=gen)
            ids, mask = features.unique_mask(hashing.from_i32_bits(torch.gather(ids, 1, pick)))
            ids = hashing.to_i32_bits(ids)
        else:
            mask = torch.rand(rows, s_len, device=dev, generator=gen) < 0.8
        mask[0] = False
        a, b = (hashing.to_i32_bits(hashing.u32_tensor(x, dev))
                for x in hashing.multiply_shift_params(m))
        got = ops.shingle_embed(ids, mask, a, b)
        want = shingle_embed.mean_normalize(
            shingle_embed.shingle_embed_sum_plain(ids, mask, a, b), mask)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert float(got[0].abs().max()) == 0.0
    # its division-free quotient, bit for bit against IEEE x / norm
    h = torch.randint(-2**31, 2**31 - 1, (1 << 20,), dtype=torch.int32, device=dev,
                      generator=gen)
    norm = torch.rand(1 << 20, device=dev, generator=gen) * 12 + 4e-3
    q = shingle_embed.residual_quotient_cuda(h, norm)
    assert torch.equal(q.view(torch.int32), (h.float() * 2.0**-31 / norm).view(torch.int32))
    q = torch.randn(37, 50, device=dev, generator=gen)
    index = torch.randn(5000, 50, device=dev, generator=gen)
    s, r = ops.sim_topk(q, index)
    ps, pr = sim_topk.sim_topk_plain(q, index)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-4)
    assert torch.equal(r, pr)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["scan_candidates"] == len(sizes) and ops.LAUNCHES["sim_topk"] == 1
    assert ops.LAUNCHES["shingle_embed"] == len(embeds)


def test_sim_topk_split_plan():
    """Every split owns at least one 128-row tile and the splits cover the
    tiles exactly once, at the H100's 132 SMs (and other counts)."""
    for sm_count in (132, 1, 7):
        for rows_q in (1, 129, 4096, 4097):
            for rows_n in (1, 127, 128, 129, 16_384, 200_000, 1 << 20):
                splits, per = sim_topk.split_plan(rows_q, rows_n, sm_count)
                ntiles = -(-rows_n // sim_topk.TILE)
                owned = [min(ntiles, (k + 1) * per) - k * per for k in range(splits)]
                assert min(owned) >= 1 and sum(owned) == ntiles
    # the main path's shapes at 132 SMs: 32 query blocks, about 8 blocks an SM
    assert sim_topk.split_plan(4096, 1 << 20, 132) == (33, 249)
    assert sim_topk.split_plan(4096, 16_384, 132) == (32, 4)


@pytest.mark.cuda
def test_cuda_sim_topk_edges():
    """Kernel C at the edges of its tiles, splits and D chunks, against
    the plain version: every argmax row equal, scores within 1e-4; ties
    within a thread, a tile and across splits go to the lowest row;
    padded rows never win."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for b in (1, 129, 4097):
        for n in (1, 127, 129, 200_000):
            for d in (16, 50, 64, 256):
                if b * n * d > 4097 * 200_000 * 50:
                    continue
                q = torch.randn(b, d, device=dev, generator=gen)
                index = torch.randn(n, d, device=dev, generator=gen)
                s, r = ops.sim_topk(q, index)
                ps, pr = sim_topk.sim_topk_plain(q, index)
                torch.cuda.synchronize()
                torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-4)
                assert torch.equal(r, pr), (b, n, d)
    for d in (16, 50, 64, 256):
        q = torch.ones(9, d, device=dev)
        # rows 3 and 35 are one thread's (tx 3), 3 and 100 one tile's, and
        # 3, 150,000 and 199,999 lie in different splits: row 3 wins
        index = torch.randn(200_000, d, device=dev, generator=gen) * 0.01
        index[[3, 35, 100, 150_000, 199_999]] = 1.0
        _, r = ops.sim_topk(q, index)
        assert bool((r == 3).all()), d
        _, r = ops.sim_topk(-torch.eye(4, d, device=dev), torch.eye(3, d, device=dev))
        assert int(r.max()) < 3
