"""Shared plain layers of the references (fp32; the fp8 control)."""
from __future__ import annotations

import contextlib
import math

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in fp32, not TF32, for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def to_e4m3(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude (per row along ``dim``, or over the whole tensor) to 448,
    returned in fp32."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference multiplies: ``"fp32"`` exactly, or ``"fp8"``:
    activations rounded per row and weights per tensor (per expert for a
    stack of experts) to e4m3. Each weight is converted once and kept:
    fp32 in fp32, e4m3 with its scale in fp8."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(kind)
        self.kind = kind
        self._kept = {}

    def _convert(self, w: torch.Tensor):
        if self.kind == "fp32":
            return w.float()
        flat = w.float().flatten(1) if w.dim() == 3 else w.float()
        dim = 1 if w.dim() == 3 else None
        amax = flat.abs().amax() if dim is None else \
            flat.abs().amax(dim=1, keepdim=True)
        scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
        return (flat / scale).to(torch.float8_e4m3fn), scale

    def w(self, w: torch.Tensor) -> torch.Tensor:
        key = (w.data_ptr(), tuple(w.shape), tuple(w.stride()), w.dtype)
        if key not in self._kept:
            self._kept[key] = self._convert(w)
        kept = self._kept[key]
        if self.kind == "fp32":
            return kept
        q, scale = kept
        return (q.float() * scale).view(w.shape)

    def x(self, x: torch.Tensor) -> torch.Tensor:
        return to_e4m3(x, dim=-1) if self.kind == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.x(x) @ self.w(w)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on (..., s, heads, d), the first half of d paired
    with the second; pos (..., s)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float32) / d)
    ang = pos.float()[..., None] * inv                      # (..., s, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """q (s, h, d), k/v (s, hkv, d), query head i on kv head i // (h/hkv);
    query blocks of ``block`` rows keep the scores small."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1).transpose(0, 1)    # (h, s, d)
    vv = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qq = q.transpose(0, 1)
    out = torch.empty_like(qq)
    kpos = torch.arange(s, device=q.device)
    for i in range(0, s, block):
        j = min(s, i + block)
        sc = qq[:, i:j] @ kk[:, :j].transpose(1, 2) / math.sqrt(d)
        qpos = torch.arange(i, j, device=q.device)
        sc = sc.masked_fill(kpos[None, :j] > qpos[:, None], float("-inf"))
        out[:, i:j] = torch.softmax(sc, dim=-1) @ vv[:, :j]
    return out.transpose(0, 1)


def swiglu(x, p, prec: Precision) -> torch.Tensor:
    h = torch.nn.functional.silu(prec.mm(x, p["gate"])) * prec.mm(x, p["up"])
    return prec.mm(h, p["down"])


def logits(x, embed, vocab: int, prec: Precision) -> torch.Tensor:
    """The unembedding over the real vocabulary (pad columns left out)."""
    w = embed["out"] if "out" in embed else embed["tok"].T
    return prec.mm(x, w[:, :vocab])


def layer(tree, i: int):
    """Layer i of a stacked tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]
