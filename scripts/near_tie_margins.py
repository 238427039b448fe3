#!/usr/bin/env python3
"""Locate the stage at which CARD's intra-stream verdicts on the card part
from the port's on the CPU (near-ties of cosine scores).

    python3 scripts/near_tie_margins.py

Needs a CUDA device. For vmdk and sql_dump (chip_smoke.py's widths and
data: FastCDC avg 8192; CARD k 32, m 64, n 2, d 50, 150 steps; 32 MiB x 4
versions, seed 1234) CARD is fitted on version 0 on the card, as phase
``lifecycle`` does. For every version, the intra-stream scores
``feats @ feats.T`` (earlier chunks only) are computed from features
made at these points, all with the card's fitted weights:

  a        the store's features on the card: kernel B, then the transform
           ``f @ u_pinv`` and the product by cuBLAS (fp32, no TF32);
  b        kernel B's embeddings from the card, transform and product on
           the CPU;
  c        the plain version's features on the CPU (the port's CPU path);
  d        exact: kernel B's inputs from the card, every later step in
           float64 on the CPU;

and at one more, which tells the fit from the features:

  cpu_fit  point c's features with the context model fitted on the CPU.

A row's verdict is the stream id of its intra-stream argmax. One JSON line
per (workload, version) counts the new chunks whose verdict at each point
differs from point c's; then one line per differing row, and per row whose
best two candidates at point c lie within NEAR_TIE of each other, gives
the float64 score margin between c's candidate and the other (at a near
tie, c's runner-up) at each point (positive: c's candidate scores higher).
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.api.store import chunk_with  # noqa: E402
from repro_torch.core import features, hashing, similarity  # noqa: E402
from repro_torch.data import workloads  # noqa: E402
from repro_torch.kernels import ingest  # noqa: E402

CPU = torch.device("cpu")
NEAR_TIE = 1e-6


def intra(feats: torch.Tensor) -> torch.Tensor:
    """Masked intra-stream score matrix (float64 on the CPU)."""
    sims = similarity.exact_matmul(feats, feats.T)
    n = sims.shape[0]
    upper = torch.ones(n, n, dtype=torch.bool, device=sims.device).triu()
    return sims.masked_fill(upper, float("-inf")).double().cpu()


def transformed(model, init: torch.Tensor) -> torch.Tensor:
    """``model.transform`` at the store's padded shape, real rows only."""
    n = init.shape[0]
    pad = features.bucket_pow2(n, 16) - n
    if pad:
        init = torch.cat([init, init.new_zeros(pad, init.shape[1])])
    return model.transform(init)[:n]


def exact_features(ids: torch.Tensor, mask: torch.Tensor, u_pinv: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Kernel B's function and Formula 3 with every step after the
    multiply-shift unit values (float32, as both packages make them) in
    float64."""
    a, b = hashing.multiply_shift_params(chip_smoke.FEAT.m)
    v = hashing.multiply_shift_unit(hashing.from_i32_bits(ids),
                                    hashing.u32_tensor(a, CPU), hashing.u32_tensor(b, CPU))
    v = v.double()
    v = v / (torch.sqrt((v * v).sum(-1, keepdim=True)) + 1e-12) * mask[..., None].double()
    feat = v.sum(1) / torch.clamp(mask.sum(-1, keepdim=True), min=1).double()
    feat = feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-12)
    v = (2 * k) * (feat @ u_pinv.double())
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


def main() -> int:
    if not torch.cuda.is_available():
        print("near_tie_margins: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    k = chip_smoke.MODEL.k
    for name in ("vmdk", "sql_dump"):
        versions = workloads.make_workload(
            name, workloads.WorkloadConfig(base_size=chip_smoke.BASE,
                                           versions=chip_smoke.VERSIONS))
        det = chip_smoke.card_detector(dev)
        det.fit(versions[:1], chip_smoke.CHUNKER)
        cpu_fit = chip_smoke.card_detector(CPU)
        cpu_fit.fit(versions[:1], chip_smoke.CHUNKER)
        # point b and c: the card's fitted weights, on the CPU
        card_model_on_cpu = chip_smoke.card_detector(CPU).model
        card_model_on_cpu.u_pinv = det.model.u_pinv.cpu()
        ext_cpu = features.FeatureExtractor(chip_smoke.FEAT, device=CPU)
        for vi, stream in enumerate(versions):
            chunks, scan = chunk_with(chip_smoke.CHUNKER, stream, dev)
            _, scan_c = chunk_with(chip_smoke.CHUNKER, stream, CPU)
            offs = np.asarray([c.offset for c in chunks], np.int64)
            lens = np.asarray([c.length for c in chunks], np.int64)
            # stream ids as the intra-stream pass assigns them (first occurrence)
            first: dict[bytes, int] = {}
            sid = np.asarray([first.setdefault(c.digest, i) for i, c in enumerate(chunks)])
            new = sid == np.arange(len(chunks))
            init_card = det.extractor.features_from_stream(scan, offs, lens,
                                                            lmax_floor=det.lmax_floor)
            init_cpu = ext_cpu.features_from_stream(scan_c, offs, lens, lmax_floor=det.lmax_floor)
            ids, mask = ingest.shingle_inputs(scan, offs, lens, dev, k=chip_smoke.FEAT.k,
                                              n=chip_smoke.FEAT.n, lmax_floor=det.lmax_floor)
            pts = {
                "a": intra(transformed(det.model, init_card)),
                "b": intra(transformed(card_model_on_cpu, init_card.cpu())),
                "c": intra(transformed(card_model_on_cpu, init_cpu)),
                "d": intra(exact_features(ids.cpu(), mask.cpu(), det.model.u_pinv.cpu(), k)),
                "cpu_fit": intra(transformed(cpu_fit.model, init_cpu)),
            }
            verdict = {p: sid[s.argmax(1).numpy()] for p, s in pts.items()}
            rows = np.flatnonzero(new)[1:]          # row 0 has no earlier chunk
            differs = {p: rows[verdict[p][rows] != verdict["c"][rows]] for p in pts}
            print(json.dumps({"workload": name, "version": vi, "chunks": len(chunks),
                              "new": int(new.sum()),
                              "differs_from_c": {p: len(r) for p, r in differs.items()}}),
                  flush=True)
            top2 = pts["c"].topk(2, dim=1)
            near = rows[(top2.values[rows, 0] - top2.values[rows, 1]).numpy() < NEAR_TIE]
            for i in sorted(set(near.tolist()).union(*(r.tolist() for r in differs.values()))):
                jc = int(pts["c"][i].argmax())
                others = {int(pts[p][i].argmax()) for p in pts} - {jc}
                for jo in sorted(others or {int(top2.indices[i, 1])}):
                    print(json.dumps({
                        "workload": name, "version": vi, "row": i,
                        "candidate_c": int(sid[jc]), "other": int(sid[jo]),
                        "score_c": float(pts["c"][i, jc]),
                        "margin": {p: float(s[i, jc] - s[i, jo]) for p, s in pts.items()},
                        "verdict": {p: int(verdict[p][i]) for p in pts}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
