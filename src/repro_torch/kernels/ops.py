"""Public wrappers around the hand-written kernels (port of
``repro.kernels.ops``).

Dispatch is by the device of the tensor a wrapper is given, and nothing
else: a CPU tensor takes the kernel's plain PyTorch version; a CUDA
tensor launches the kernel, and a build or launch failure raises — there
is no fallback. Each wrapper counts its launches in ``LAUNCHES`` (plain
integers, incremented only where a kernel is launched), so a run can
show that its main path went through the kernels.

``flash_attention`` also takes ``meta`` tensors (the dry run's shapes):
it returns its output's shape and dtype, computes nothing, launches
nothing, and adds the attention's FLOPs, the reference's ``_attn_flops``
rule, to ``META_FLOPS``. A mix of ``meta`` with CPU or CUDA tensors
raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import gear_hash as _gear
from repro_torch.kernels import shingle_embed as _shingle
from repro_torch.kernels import sim_topk as _topk

LAUNCHES: dict[str, int] = {
    "gear_hashes": 0, "rabin_fps": 0, "scan_candidates": 0,
    "shingle_embed": 0, "sim_topk": 0, "flash_attention": 0,
    "flash_attention_sm90": 0,
}


# the FLOPs that kernel D's meta route stood for: 4 H hd Tq Tk a sequence,
# halved when causal (``repro/distributed/roofline.py``'s ``_attn_flops``)
META_FLOPS: dict[str, float] = {"flash_attention": 0.0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Entry-point device rule: ``None`` means the CUDA device, and asking
    for CUDA where there is none raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on_meta(*tensors: torch.Tensor) -> bool:
    """True for ``meta`` tensors alone; a mix with other devices raises."""
    kinds = {t.device.type for t in tensors}
    if "meta" in kinds and kinds != {"meta"}:
        raise ValueError(f"meta tensors mixed with {kinds - {'meta'}}")
    return kinds == {"meta"}


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all be on one CPU or CUDA device, got {kinds}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {ndim}-d {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def gear_hashes(data: torch.Tensor) -> torch.Tensor:
    """[n] uint8 byte stream -> [n] int32 windowed gear hash bits."""
    _check(data, "data", torch.uint8, 1)
    if not _on_cuda(data):
        return _gear.gear_hashes_plain(data)
    if data.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=data.device)
    LAUNCHES["gear_hashes"] += 1
    return _gear.windowed_sum_cuda(data, hashing.GEAR_WEIGHTS, gear=True)[0]


def rabin_fps(data: torch.Tensor, window: int = hashing.RABIN_WINDOW) -> torch.Tensor:
    """[n] uint8 byte stream -> [n] int32 windowed polynomial fingerprint bits."""
    _check(data, "data", torch.uint8, 1)
    if not _on_cuda(data):
        return _gear.rabin_fps_plain(data, window)
    if data.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=data.device)
    LAUNCHES["rabin_fps"] += 1
    return _gear.windowed_sum_cuda(data, hashing.poly_powers(window), gear=False)[0]


def scan_candidates(data: torch.Tensor, mask_s: int, mask_l: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chunker scan: [n] uint8 -> (gear hash bits [n] int32, cand_s
    words, cand_l words [ceil(n/32)] int32; see ``gear_hash.unpack_bits``)."""
    _check(data, "data", torch.uint8, 1)
    if not _on_cuda(data):
        return _gear.scan_plain(data, mask_s, mask_l)
    if data.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.int32, device=data.device)
        return empty, empty, empty
    LAUNCHES["scan_candidates"] += 1
    return _gear.windowed_sum_cuda(data, hashing.GEAR_WEIGHTS, gear=True,
                                   masks=(mask_s, mask_l))


def shingle_embed(ids: torch.Tensor, mask: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """[B, S] int32 shingle-id bits + [B, S] bool mask, a/b [M] int32 bits
    -> [B, M] float32 initial features (mean rows, L2-normalised unless
    ``normalize`` is False). On the card one launch computes the sums,
    the mean and the normalisation."""
    _check(ids, "ids", torch.int32, 2)
    _check(mask, "mask", torch.bool, 2)
    _check(a, "a", torch.int32, 1)
    _check(b, "b", torch.int32, 1)
    if mask.shape != ids.shape or a.shape != b.shape:
        raise ValueError(f"shape mismatch: ids {tuple(ids.shape)}, mask "
                         f"{tuple(mask.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not _on_cuda(ids, mask, a, b):
        return _shingle.mean_normalize(_shingle.shingle_embed_sum_plain(ids, mask, a, b),
                                       mask, normalize)
    if ids.shape[0] == 0:
        return torch.zeros(0, a.shape[0], dtype=torch.float32, device=ids.device)
    if a.shape[0] > _shingle.MAX_M:
        raise ValueError(f"M = {a.shape[0]} exceeds the kernel's {_shingle.MAX_M}")
    LAUNCHES["shingle_embed"] += 1
    return _shingle.shingle_embed_cuda(ids, mask, a, b, normalize)


def sim_topk(q: torch.Tensor, index: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, D] queries x [N, D] index (f32) -> (best score [B], best row [B] int32)."""
    _check(q, "q", torch.float32, 2)
    _check(index, "index", torch.float32, 2)
    if q.shape[1] != index.shape[1] or index.shape[0] == 0:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, index {tuple(index.shape)}")
    if not _on_cuda(q, index):
        return _topk.sim_topk_plain(q, index)
    if q.shape[0] == 0:
        return (torch.empty(0, dtype=torch.float32, device=q.device),
                torch.empty(0, dtype=torch.int32, device=q.device))
    if q.shape[1] > _topk.MAX_D:
        raise ValueError(f"D = {q.shape[1]} exceeds the kernel's {_topk.MAX_D}")
    LAUNCHES["sim_topk"] += 1
    return _topk.sim_topk_cuda(q, index)


class _FlashAttention(torch.autograd.Function):
    """Kernel D with a gradient. The forward is the wrapper's dispatch by
    device (kernel D on CUDA tensors, the plain version on CPU ones), run
    with autograd off, so the plain version may work in place and the
    kernel's output, which no autograd op made, still gets a backward.
    The backward is ``flash_attn.flash_attention_plain_grad``: torch ops
    that recompute the scores from the saved q, k and v; it launches no
    kernel and counts nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _flash_attention_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        grads = _fa.flash_attention_plain_grad(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2), do.transpose(1, 2),
                                               ctx.causal)
        return (*(g.transpose(1, 2).contiguous() for g in grads), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Model layout: q [B, Tq, H, hd], k/v [B, Tk, KV, hd] (H % KV == 0),
    contiguous, all f32 or all bf16 -> [B, Tq, H, hd] in that dtype.

    On the card, dtype and hd pick the kernel (``flash_attn.route``): bf16
    at hd 64 or 128 runs on the tensor cores (``flash_attn_sm90.cu``, also
    counted in ``LAUNCHES["flash_attention_sm90"]``), anything else on the
    SIMT kernel (``flash_attn.cu``). ``LAUNCHES["flash_attention"]`` counts
    both. A launch error raises; neither kernel stands in for the other.
    Where q, k or v requires grad, the output carries the gradient of
    ``_FlashAttention`` (the same forward; the backward in torch ops)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: want float32 or bfloat16, got {t.dtype}")
        _check(t, name, q.dtype, 4)
    b, tq, h, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd or q.numel() == 0
            or k.numel() == 0 or h % k.shape[2] != 0):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (want H % KV == 0, none empty)")
    if not _on_meta(q, k, v) and _on_cuda(q, k, v) and hd > _fa.MAX_HD:
        raise ValueError(f"hd = {hd} exceeds the kernel's {_fa.MAX_HD}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_attention_forward(q, k, v, causal)


def _flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool) -> torch.Tensor:
    """The dispatch of checked inputs: the plain version for CPU tensors,
    kernel D by its route for CUDA ones, the output's shape alone for
    ``meta`` ones (its FLOPs counted in ``META_FLOPS``)."""
    if _on_meta(q, k, v):
        b, tq, h, hd = q.shape
        META_FLOPS["flash_attention"] += (4.0 * b * h * hd * tq * k.shape[1]
                                          * (0.5 if causal else 1.0))
        return torch.empty_like(q)
    if not _on_cuda(q, k, v):
        out = _fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal)
        return out.transpose(1, 2).contiguous()
    LAUNCHES["flash_attention"] += 1
    if _fa.route(q.dtype, q.shape[3]) == "sm90":
        LAUNCHES["flash_attention_sm90"] += 1
        return _fa.flash_attention_sm90_cuda(q, k, v, causal)
    return _fa.flash_attention_cuda(q, k, v, causal)
