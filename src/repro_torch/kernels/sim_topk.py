"""Kernel C: cosine top-1 against the stored index — the CUDA launcher and
its plain version.

score = q @ index^T with a running (max, argmax); the [B, N] score matrix
is never stored. Ties go to the lowest row. Source:
``csrc/sim_topk.cu``; replaces ``repro/kernels/sim_topk.py:45``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/sim_topk.cu"
REPLACES = "src/repro/kernels/sim_topk.py:45"
TILE = 128       # queries per block and index rows per tile (csrc kTile)
BLOCKS_PER_SM = 8
MAX_D = 256
PLAIN_BLOCK_N = 1 << 16


def sim_topk_plain(q: torch.Tensor, index: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, D] x index [N, D] f32 -> (best score [B] f32, row [B] int32).

    Walks the index in blocks of ``PLAIN_BLOCK_N`` rows with a running best
    (strict ``>`` across blocks, first max within one), so the full [B, N]
    matrix never exists."""
    rows_q = q.shape[0]
    best = torch.full((rows_q,), float("-inf"), dtype=torch.float32, device=q.device)
    arg = torch.zeros(rows_q, dtype=torch.int64, device=q.device)
    for n0 in range(0, index.shape[0], PLAIN_BLOCK_N):
        s = q @ index[n0:n0 + PLAIN_BLOCK_N].T
        a = s.argmax(dim=1)
        m = s.gather(1, a[:, None])[:, 0]
        take = m > best
        best = torch.where(take, m, best)
        arg = torch.where(take, a + n0, arg)
    return best, arg.to(torch.int32)


def split_plan(rows_q: int, rows_n: int, sm_count: int) -> tuple[int, int]:
    """(splits, tiles_per_split) over the index's 128-row tiles: about
    ``BLOCKS_PER_SM`` blocks a multiprocessor (two resident, so four
    waves), every split owning at least one tile."""
    ntiles = -(-rows_n // TILE)
    qblocks = -(-rows_q // TILE)
    want = max(1, min(ntiles, -(-BLOCKS_PER_SM * sm_count // qblocks)))
    per = -(-ntiles // want)
    return -(-ntiles // per), per


def sim_topk_cuda(q: torch.Tensor, index: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel C (inputs checked by the caller)."""
    rows_q, d = q.shape
    rows_n = index.shape[0]
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, per = split_plan(rows_q, rows_n, sm_count)
    part_s = torch.empty(splits, rows_q, dtype=torch.float32, device=q.device)
    part_r = torch.empty(splits, rows_q, dtype=torch.int32, device=q.device)
    out_s = torch.empty(rows_q, dtype=torch.float32, device=q.device)
    out_r = torch.empty(rows_q, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().repro_sim_topk(
        q.data_ptr(), index.data_ptr(), rows_q, rows_n, d, splits, per,
        part_s.data_ptr(), part_r.data_ptr(), out_s.data_ptr(),
        out_r.data_ptr(), stream)
    _build.check(err, "repro_sim_topk")
    return out_s, out_r
