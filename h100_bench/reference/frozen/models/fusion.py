"""Cross-modal fusion: DAFM and its variants, batched + masked
(models/fusion.py).

  - Attention_mat — the paper's DAFM: two single-head cross-attention
    streams whose logits are *multiplied* by the distance prior
    E_r = softmax(-De / sigma) before the softmax, stacked, max-merged.
  - Attention_normal — no distance bias; Attention_exp / Attention_multi /
    Attention_multi_cat — additive exp(-De^2 / 2 sigma^2) bias (the last
    concatenates R' and L' instead of the max); Attention_gaussian —
    additive Gaussian-pdf bias.
  - Attention_pe — bbox-center positional concat into Q / K.
  - crossAtt, catandAtt — 8-head attention; Attention_MMCA_sty — joint
    self-attention over the stacked [R; L] tokens.
  - sum / concat merges; SocialEncoderLayer for the similarity input.

Everything is batched (B, N, D) with a (B, N) validity mask; padded actors
are excluded from every softmax by masking. Modules and parameters are
named as the flax tree names them, so convert.py is a path map.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masked import masked_softmax
from .layers import FFN, KAIMING, MultiHeadAttention, draw, linear

# fusion name -> (prior mode, how the prior enters the logits, merge) of the
# FusionAttentionLayer family
_ATTENTION_FAMILY = {
    "Attention_mat": ("mult_softmax", "mult", "max"),
    "Attention_normal": ("none", "add", "max"),
    "Attention_gaussian": ("add_gauss", "add", "max"),
    "Attention_exp": ("add_exp", "add", "max"),
    "Attention_multi": ("add_exp", "add", "max"),
    "Attention_multi_cat": ("add_exp", "add", "concat"),
}
FUSIONS = ("sum", "concat", "Attention_pe", "crossAtt", "catandAtt",
           "Attention_MMCA_sty") + tuple(_ATTENTION_FAMILY)


def fused_width(fusion: str, dim: int) -> int:
    """Width of DAFM's output for per-modality features of width ``dim``."""
    return 2 * dim if fusion in ("concat", "Attention_multi_cat") else dim


def distance_prior(de: torch.Tensor, pair_valid: torch.Tensor, sigma: float,
                   mode: str = "mult_softmax") -> torch.Tensor:
    """Distance-derived attention prior: 'mult_softmax' (DAFM), 'add_exp',
    'add_gauss', 'none'."""
    if mode == "mult_softmax":
        return masked_softmax(-de / sigma, pair_valid, dim=-1)
    if mode == "add_exp":
        return torch.exp(-de ** 2 / (2.0 * sigma ** 2)) * pair_valid
    if mode == "add_gauss":
        return (1.0 / (sigma * math.sqrt(2 * math.pi))
                * torch.exp(-0.5 * (de / sigma) ** 2) * pair_valid)
    if mode == "none":
        return torch.zeros_like(de)
    raise ValueError(f"unknown distance prior mode {mode!r}")


def _raw(shape, *, device, generator) -> nn.Parameter:
    """A raw (in, out) weight used as x @ W, kaiming-normal."""
    return nn.Parameter(draw(shape, (KAIMING / shape[0]) ** 0.5,
                             device=device, generator=generator))


def _attend(q, k, v, pair_valid, dim: int) -> torch.Tensor:
    """Single-head masked attention with logits q.k / sqrt(dim)."""
    logits = torch.einsum("bnd,bmd->bnm", q, k) / dim ** 0.5
    return torch.einsum("bnm,bmd->bnd",
                        masked_softmax(logits, pair_valid, dim=-1), v)


class _AttentionStream(nn.Module):
    """Att(Q=A.WQ, K=B.WK, V=B.WV) with the prior in the logits
    (``bias_mode`` 'mult': logits * prior / sqrt(d); 'add': logits / sqrt(d)
    + prior), then LN(out + B) -> + FFN -> LN."""

    def __init__(self, dim: int, bias_mode: str = "mult", *, device,
                 generator):
        super().__init__()
        self.dim, self.bias_mode = dim, bias_mode
        for name in ("WQ", "WK", "WV"):       # raw (in, out), used as x @ W
            setattr(self, name, _raw((dim, dim), device=device,
                                     generator=generator))
        self.LN1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.FFN = FFN(dim, device=device, generator=generator)
        self.LN2 = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, q_src, kv_src, prior, pair_valid):
        q = q_src @ self.WQ
        k = kv_src @ self.WK
        v = kv_src @ self.WV
        logits = torch.einsum("bnd,bmd->bnm", q, k)
        if self.bias_mode == "mult":
            logits = logits * prior / self.dim ** 0.5
        else:
            logits = logits / self.dim ** 0.5 + prior
        att = masked_softmax(logits, pair_valid, dim=-1)
        out = torch.einsum("bnm,bmd->bnd", att, v)
        out = self.LN1(out + kv_src)
        out = out + self.FFN(out)
        return self.LN2(out)


class FusionAttentionLayer(nn.Module):
    """One DAFM layer: R' and L' streams, both modulated by the same E_r."""

    def __init__(self, dim: int, sigma: float,
                 prior_mode: str = "mult_softmax", bias_mode: str = "mult",
                 *, device, generator):
        super().__init__()
        self.sigma, self.prior_mode = sigma, prior_mode
        kw = dict(device=device, generator=generator)
        self.stream_r = _AttentionStream(dim, bias_mode, **kw)
        self.stream_l = _AttentionStream(dim, bias_mode, **kw)

    def forward(self, rgb, lidar, de, pair_valid):
        prior = distance_prior(de, pair_valid, self.sigma, self.prior_mode)
        r_prime = self.stream_r(lidar, rgb, prior, pair_valid)
        l_prime = self.stream_l(rgb, lidar, prior, pair_valid)
        return r_prime, l_prime


class PositionalFusionLayer(nn.Module):
    """FusionAttention_pe: Q and K from the feature concatenated with the
    actor's bbox centre (cx, cy), V from the raw feature, no distance prior;
    residual / LN / FFN / LN as in the other streams."""

    def __init__(self, dim: int, center_dim: int = 2, *, device, generator):
        super().__init__()
        self.dim = dim
        kw = dict(device=device, generator=generator)
        for prefix in ("r", "l"):
            setattr(self, f"WQ_{prefix}", _raw((dim + center_dim, dim), **kw))
            setattr(self, f"WK_{prefix}", _raw((dim + center_dim, dim), **kw))
            setattr(self, f"WV_{prefix}", _raw((dim, dim), **kw))
            setattr(self, f"LN1_{prefix}",
                    nn.LayerNorm(dim, eps=1e-5, device=device))
            setattr(self, f"FFN_{prefix}", FFN(dim, **kw))
            setattr(self, f"LN2_{prefix}",
                    nn.LayerNorm(dim, eps=1e-5, device=device))

    def _stream(self, q_src_pe, kv_src_pe, kv_src, pair_valid, prefix):
        def part(name):
            return getattr(self, f"{name}_{prefix}")
        out = _attend(q_src_pe @ part("WQ"), kv_src_pe @ part("WK"),
                      kv_src @ part("WV"), pair_valid, self.dim)
        out = part("LN1")(out + kv_src)
        out = out + part("FFN")(out)
        return part("LN2")(out)

    def forward(self, rgb, lidar, centers, pair_valid):
        r_pe = torch.cat([centers, rgb], dim=-1)
        l_pe = torch.cat([centers, lidar], dim=-1)
        r_prime = self._stream(l_pe, r_pe, rgb, pair_valid, "r")
        l_prime = self._stream(r_pe, l_pe, lidar, pair_valid, "l")
        return r_prime, l_prime


class SocialEncoderLayer(nn.Module):
    """Masked transformer encoder layer (post-norm, 8 heads, FFN 2048) on
    the fused features before the cosine similarity."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_dim: int = 2048, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.self_att = MultiHeadAttention(dim, num_heads, **kw)
        self.LN1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.FFN_0 = linear(dim, ffn_dim, **kw)
        self.FFN_1 = linear(ffn_dim, dim, **kw)
        self.LN2 = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, x, pair_valid):
        x = self.LN1(x + self.self_att(x, x, pair_valid))
        h = self.FFN_1(F.relu(self.FFN_0(x)))
        return self.LN2(x + h)


class CrossAttentionFusion(nn.Module):
    """8-head bidirectional cross attention, max merge: R' = MHA(Q=L, K=R,
    V=R) + R -> LN -> + FFN -> LN; symmetric L' stream."""

    def __init__(self, dim: int, num_heads: int = 8, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        for prefix in ("r", "l"):
            setattr(self, f"{prefix}_mha",
                    MultiHeadAttention(dim, num_heads, **kw))
            setattr(self, f"{prefix}_ln1",
                    nn.LayerNorm(dim, eps=1e-5, device=device))
            setattr(self, f"{prefix}_ffn", FFN(dim, **kw))
            setattr(self, f"{prefix}_ln2",
                    nn.LayerNorm(dim, eps=1e-5, device=device))

    def _stream(self, q_src, kv_src, pair_valid, prefix):
        att = getattr(self, f"{prefix}_mha")(q_src, kv_src, pair_valid)
        x = getattr(self, f"{prefix}_ln1")(att + kv_src)
        x = x + getattr(self, f"{prefix}_ffn")(x)
        return getattr(self, f"{prefix}_ln2")(x)

    def forward(self, rgb, lidar, pair_valid):
        return torch.maximum(self._stream(lidar, rgb, pair_valid, "r"),
                             self._stream(rgb, lidar, pair_valid, "l"))


class CatAndAttFusion(nn.Module):
    """concat -> Linear(2 dim, dim) -> self-MHA -> LN -> FFN -> LN."""

    def __init__(self, dim: int, num_heads: int = 8, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.FL = linear(2 * dim, dim, **kw)
        self.att = MultiHeadAttention(dim, num_heads, **kw)
        self.LN = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.FL2 = FFN(dim, **kw)
        self.LN2 = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, rgb, lidar, pair_valid):
        x = self.FL(torch.cat([rgb, lidar], dim=-1))
        x = self.LN(x + self.att(x, x, pair_valid))
        return self.LN2(self.FL2(x) + x)


class MMCAStyleFusion(nn.Module):
    """Joint self-attention over the concatenated [R; L] token set (2N):
    shared W_Q / K / V per layer over the stacked sequence, then split and
    max-merge."""

    def __init__(self, dim: int, num_layers: int = 2, *, device, generator):
        super().__init__()
        self.dim, self.num_layers = dim, num_layers
        kw = dict(device=device, generator=generator)
        for i in range(num_layers):
            for name in ("WQ", "WK", "WV"):
                setattr(self, f"{name}_{i}", _raw((dim, dim), **kw))
            setattr(self, f"LN1_{i}",
                    nn.LayerNorm(dim, eps=1e-5, device=device))
            setattr(self, f"FFN_{i}", FFN(dim, **kw))
            setattr(self, f"LN2_{i}",
                    nn.LayerNorm(dim, eps=1e-5, device=device))

    def forward(self, rgb, lidar, pair_valid):
        valid = torch.diagonal(pair_valid, dim1=1, dim2=2)       # (B, N)
        valid2 = torch.cat([valid, valid], dim=1)                # (B, 2N)
        pv = valid2[:, None, :] & valid2[:, :, None]
        x = torch.cat([rgb, lidar], dim=1)                       # (B, 2N, D)
        for i in range(self.num_layers):
            def part(name):
                return getattr(self, f"{name}_{i}")
            y = _attend(x @ part("WQ"), x @ part("WK"), x @ part("WV"), pv,
                        self.dim)
            y = part("LN1")(y + x)
            y = y + part("FFN")(y)
            x = part("LN2")(y)
        n = rgb.shape[1]
        return torch.maximum(x[:, :n], x[:, n:])


class DAFM(nn.Module):
    """Stacked distance-aware fusion; ``fusion`` selects the variant (one of
    ``FUSIONS``), 'Attention_mat' being the paper's: two layers of
    multiplicative-prior cross attention and an elementwise-max merge."""

    def __init__(self, dim: int, sigma: float, num_layers: int,
                 fusion: str = "Attention_mat", *, device, generator):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}: one of {FUSIONS}")
        self.fusion, self.num_layers = fusion, num_layers
        kw = dict(device=device, generator=generator)
        if fusion == "Attention_pe":
            for i in range(num_layers):
                self.add_module(f"pe_layer_{i}",
                                PositionalFusionLayer(dim, **kw))
        elif fusion == "crossAtt":
            self.cross_att = CrossAttentionFusion(dim, **kw)
        elif fusion == "catandAtt":
            self.cat_and_att = CatAndAttFusion(dim, **kw)
        elif fusion == "Attention_MMCA_sty":
            self.mmca = MMCAStyleFusion(dim, num_layers, **kw)
        elif fusion in _ATTENTION_FAMILY:
            prior_mode, bias_mode, self.merge = _ATTENTION_FAMILY[fusion]
            for i in range(num_layers):
                self.add_module(f"layer_{i}", FusionAttentionLayer(
                    dim, sigma, prior_mode, bias_mode, **kw))

    def forward(self, rgb, lidar, de, pair_valid,
                centers: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fusion == "sum":
            return rgb + lidar
        if self.fusion == "concat":
            return torch.cat([rgb, lidar], dim=-1)
        if self.fusion == "crossAtt":
            return self.cross_att(rgb, lidar, pair_valid)
        if self.fusion == "catandAtt":
            return self.cat_and_att(rgb, lidar, pair_valid)
        if self.fusion == "Attention_MMCA_sty":
            return self.mmca(rgb, lidar, pair_valid)
        r, l = rgb, lidar
        if self.fusion == "Attention_pe":
            if centers is None:
                raise ValueError("Attention_pe needs bbox3d centers")
            for i in range(self.num_layers):
                r, l = getattr(self, f"pe_layer_{i}")(r, l, centers,
                                                      pair_valid)
            return torch.maximum(r, l)
        for i in range(self.num_layers):
            r, l = getattr(self, f"layer_{i}")(r, l, de, pair_valid)
        if self.merge == "max":
            return torch.maximum(r, l)
        return torch.cat([r, l], dim=-1)

