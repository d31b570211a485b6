"""Feature Matching Transformer with linear attention (reference models/FMT.py).

Eight encoder layers alternate self and cross attention over the stage-1
feature tokens; linear attention (elu+1 feature map, KV = sum K (x) V) never
forms the N x N matrix; a closed-form 2-D sinusoidal position encoding; and
the coarse-to-fine pathway into stages 2 and 3. All source views run as
one batch [B*S, L, C].

On a mesh (``parallel/sharding.py``) the FMT runs sequence parallel, as
the JAX package's does under GSPMD: the tokens are split over the
``depth`` axis (the JAX package's "seq") for the reference and the
sources, and the sources over ``view``. Every op is local to a token but
linear attention's ``KV`` and ``Z`` sums over the keys' tokens, which are
summed over the ``depth`` axis in one all-reduce of their float32
partials per attention. The pathway's 3x3 convs need whole images, so
the FMT's outputs are gathered once, at its end.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from transmvsnet_tpu_torch.models.blocks import Conv2d, LayerNorm, Linear
from transmvsnet_tpu_torch.parallel import sharding
from transmvsnet_tpu_torch.ops.sampling import resize_bilinear


def sine_position_encoding(h: int, w: int, d_model: int) -> np.ndarray:
    """2-D sinusoidal encoding [H, W, C], 1-based positions (the
    reference's temp_bug_fix=True variant, position_encoding.py:39-52)."""
    y = np.arange(1, h + 1, dtype=np.float32)[:, None, None]
    x = np.arange(1, w + 1, dtype=np.float32)[None, :, None]
    div = np.exp(
        np.arange(0, d_model // 2, 2, dtype=np.float32)
        * (-math.log(10000.0) / (d_model // 2))
    )[None, None, :]
    pe = np.zeros((h, w, d_model), dtype=np.float32)
    pe[:, :, 0::4] = np.sin(x * div)
    pe[:, :, 1::4] = np.cos(x * div)
    pe[:, :, 2::4] = np.sin(y * div)
    pe[:, :, 3::4] = np.cos(y * div)
    return pe


def linear_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, eps: float = 1e-6, seq_axis: str | None = None
) -> torch.Tensor:
    """q [N, L, H, D], k/v [N, S, H, D] -> [N, L, H, D]; sums in float32.
    With ``seq_axis`` the tokens are split over that mesh axis and the
    sums over the keys' tokens are all-reduced over it."""
    q = (F.elu(q) + 1.0).float()
    k = (F.elu(k) + 1.0).float()
    kv = torch.einsum("nshd,nshm->nhmd", k, v.float())
    k_sum = k.sum(1)
    if seq_axis is not None and sharding.axis_size(seq_axis) > 1:
        both = sharding.psum(torch.cat([kv.flatten(1), k_sum.flatten(1)], 1), (seq_axis,), "fmt.kv")
        kv, k_sum = both[:, : kv[0].numel()].view_as(kv), both[:, kv[0].numel():].view_as(k_sum)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k_sum) + eps)
    out = torch.einsum("nlhd,nhmd,nlh->nlhm", q, kv, z)
    return out.to(v.dtype)


class AttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query_projection = Linear(d_model, d_model)
        self.key_projection = Linear(d_model, d_model)
        self.value_projection = Linear(d_model, d_model)
        self.out_projection = Linear(d_model, d_model)

    def forward(self, queries, keys, values, seq_axis=None):
        N, L, C = queries.shape
        S, H = keys.shape[1], self.n_heads
        q = self.query_projection(queries).reshape(N, L, H, C // H)
        k = self.key_projection(keys).reshape(N, S, H, C // H)
        v = self.value_projection(values).reshape(N, S, H, C // H)
        return self.out_projection(linear_attention(q, k, v, seq_axis=seq_axis).reshape(N, L, C))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.attention = AttentionLayer(d_model, n_heads)
        self.linear1 = Linear(d_model, 2 * d_model)
        self.linear2 = Linear(2 * d_model, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, source: torch.Tensor, seq_axis: str | None = None) -> torch.Tensor:
        x = self.norm1(x + self.attention(x, source, source, seq_axis))
        y = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + y)


class FMT(nn.Module):
    def __init__(self, d_model: int = 32, n_heads: int = 8, layer_names=("self", "cross") * 4):
        super().__init__()
        self.d_model = d_model
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(EncoderLayer(d_model, n_heads) for _ in self.layer_names)

    def forward(self, ref: torch.Tensor, src: torch.Tensor):
        """ref [B, C, H, W], src [B, S, C, H, W] -> same shapes.

        Cross layers attend from the sources to the reference's output of
        the self layer before them (the reference's intermediate contract).
        """
        B, C, H, W = ref.shape
        S = src.shape[1]
        assert C == self.d_model
        pe = torch.from_numpy(sine_position_encoding(H, W, C)).to(ref.device, ref.dtype)
        pe = pe.reshape(1, H * W, C)
        L = H * W
        # This process's tokens (and source views) on a mesh.
        r = sharding.split(ref.flatten(2).transpose(1, 2) + pe, 1, "depth")  # [B, L, C]
        s = src.reshape(B * S, C, L).transpose(1, 2) + pe  # [B*S, L, C]
        s = sharding.split(sharding.split(s.unflatten(0, (B, S)), 1, "view"), 2, "depth")
        S_local, L_local = s.shape[1:3]
        s = s.flatten(0, 1)
        ref_intermediates = []
        for i, name in enumerate(self.layer_names):
            layer = self.layers[i]
            if name == "self":
                r = layer(r, r, "depth")
                ref_intermediates.append(r)
                s = layer(s, s, "depth")
            elif name == "cross":
                inter = ref_intermediates[i // 2]
                tiled = inter[:, None].expand(B, S_local, L_local, C).reshape(B * S_local, L_local, C)
                s = layer(s, tiled, "depth")
            else:
                raise ValueError(f"unknown layer kind {name}")
        r = sharding.gather(r, 1, "depth", L, "fmt.out")
        s = sharding.gather(sharding.gather(s.unflatten(0, (B, S_local)), 2, "depth", L, "fmt.out"),
                            1, "view", S, "fmt.out")
        r = r.transpose(1, 2).reshape(B, C, H, W)
        s = s.transpose(2, 3).reshape(B, S, C, H, W)
        return r, s


class FMTWithPathway(nn.Module):
    """FMT on stage-1 features + top-down pathway into stages 2 and 3."""

    def __init__(self, base_channels: int = 8, d_model: int = 32, n_heads: int = 8,
                 layer_names=("self", "cross") * 4):
        super().__init__()
        bc = base_channels
        self.FMT = FMT(d_model, n_heads, layer_names)
        self.dim_reduction_1 = Conv2d(bc * 4, bc * 2, 1, bias=False)
        self.dim_reduction_2 = Conv2d(bc * 2, bc, 1, bias=False)
        self.smooth_1 = Conv2d(bc * 2, bc * 2, 3, padding=1, bias=False)
        self.smooth_2 = Conv2d(bc, bc, 3, padding=1, bias=False)

    def forward(self, features: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """features {"stageN": [B, V, C_N, h_N, w_N]}, view 0 the reference."""
        s1, s2, s3 = features["stage1"], features["stage2"], features["stage3"]
        B, V = s1.shape[:2]
        ref_out, src_out = self.FMT(s1[:, 0], s1[:, 1:])
        s1 = torch.cat([ref_out[:, None], src_out], dim=1)
        s1f, s2f, s3f = (t.flatten(0, 1) for t in (s1, s2, s3))
        s2f = self.smooth_1(resize_bilinear(self.dim_reduction_1(s1f), s2f.shape[-2:]) + s2f)
        s3f = self.smooth_2(resize_bilinear(self.dim_reduction_2(s2f), s3f.shape[-2:]) + s3f)
        return {
            "stage1": s1,
            "stage2": s2f.unflatten(0, (B, V)),
            "stage3": s3f.unflatten(0, (B, V)),
        }
