"""TransMVSNet in plain PyTorch and float32: the benchmark's yardstick.

A frozen re-implementation of the network that ``transmvsnet_tpu_torch``
runs (TransMVSNet, Ding et al., CVPR 2022; MegviiRobot/TransMVSNet), in
that program's numerics: a three-level feature pyramid with deformable
(DCNv2) output heads, the Feature Matching Transformer with linear
attention and its pathway, a three-stage plane sweep whose source views
are weighted by PixelwiseNet's visibility (BatchNorm over all source views
of a stage at once), the 3-D U-Net cost regulariser, softmax over depth,
winner-take-all depth and max-probability confidence. It imports nothing
of the program and calls none of its kernels: sampling is
``F.grid_sample``, the deformable convolution nine of them. Parameter
names are the reference checkpoint's, so one state dict loads into both.

Run it under ``full_float32()``, which turns TF32 off for matmuls and
cuDNN convolutions.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and cuDNN inside the block. The matmul flag is
    assigned only where it is on, so that the block leaves PyTorch's
    precision settings as it found them."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    if matmul:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        if matmul:
            torch.backends.cuda.matmul.allow_tf32 = True


class BatchNorm(nn.Module):
    """Batch norm over channel dim 1, eps 1e-5, momentum 0.1. With
    ``calibrating`` set (in eval mode) it normalises with the batch's
    statistics and stores them as its running statistics, so that the same
    input normalises alike afterwards."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.calibrating = False

    def forward(self, x):
        if self.calibrating:
            dims = [0] + list(range(2, x.ndim))
            with torch.no_grad():
                self.running_mean.copy_(x.mean(dims))
                self.running_var.copy_(x.var(dims, unbiased=False))
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, 0.1, 1e-5)


class ConvBnReLU(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, pad=1, ndim=2, transpose=False, relu=True):
        super().__init__()
        if transpose:
            self.conv = nn.ConvTranspose3d(cin, cout, k, stride, pad, output_padding=1, bias=False)
        else:
            cls = nn.Conv2d if ndim == 2 else nn.Conv3d
            self.conv = cls(cin, cout, k, stride, pad, bias=False)
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def normalised_grid(px: torch.Tensor, py: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coordinates -> ``grid_sample``'s [-1, 1] with align_corners=True."""
    return torch.stack([px * (2.0 / (w - 1)) - 1.0, py * (2.0 / (h - 1)) - 1.0], dim=-1)


def sample(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img [N, C, h, w] at pixel coords [N, a, b], zeros
    outside: [N, C, a, b]."""
    h, w = img.shape[-2:]
    return F.grid_sample(img, normalised_grid(px, py, h, w), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def deform_conv(x, off, weight, bias):
    """DCNv2, 3x3, stride 1, pad 1: ``off`` [N, 27, h, w] holds dy, dx
    interleaved for the nine taps, then the nine mask logits."""
    N, C, h, w = x.shape
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, :]
    mask = torch.sigmoid(off[:, 18:])
    out = None
    for k in range(9):
        i, j = divmod(k, 3)
        s = sample(x, xs + (j - 1) + off[:, 2 * k + 1], ys + (i - 1) + off[:, 2 * k]) * mask[:, k:k + 1]
        term = torch.einsum("nchw,oc->nohw", s, weight[:, :, i, j])
        out = term if out is None else out + term
    return out + bias[None, :, None, None]


class DCN(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv_offset_mask = nn.Conv2d(cin, 27, 3, 1, 1, bias=True)
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        off = self.conv_offset_mask(x)
        if torch.is_grad_enabled():
            # Nine sampled copies of a full-size head are kept for autograd
            # otherwise; recompute them in the backward.
            return checkpoint(deform_conv, x, off, self.weight, self.bias, use_reentrant=False)
        return deform_conv(x, off, self.weight, self.bias)


def arf_head(cin, mid, cout, lead=3):
    return nn.Sequential(ConvBnReLU(cin, mid, lead, 1, (lead - 1) // 2), DCN(mid, mid), BatchNorm(mid),
                         nn.ReLU(), DCN(mid, mid), BatchNorm(mid), nn.ReLU(), DCN(mid, cout))


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize(x, hw):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class FeatureNet(nn.Module):
    def __init__(self, bc=8):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, bc), ConvBnReLU(bc, bc))
        self.conv1 = nn.Sequential(ConvBnReLU(bc, 2 * bc, 5, 2, 2), ConvBnReLU(2 * bc, 2 * bc),
                                   ConvBnReLU(2 * bc, 2 * bc))
        self.conv2 = nn.Sequential(ConvBnReLU(2 * bc, 4 * bc, 5, 2, 2), ConvBnReLU(4 * bc, 4 * bc),
                                   ConvBnReLU(4 * bc, 4 * bc))
        self.out1 = arf_head(4 * bc, 4 * bc, 4 * bc, lead=1)
        self.out2 = arf_head(4 * bc, 4 * bc, 2 * bc)
        self.out3 = arf_head(4 * bc, 4 * bc, bc)
        self.inner1 = nn.Conv2d(2 * bc, 4 * bc, 1, bias=True)
        self.inner2 = nn.Conv2d(bc, 4 * bc, 1, bias=True)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        f1 = self.out1(c2)
        intra = up2(c2) + self.inner1(c1)
        f2 = self.out2(intra)
        intra = up2(intra) + self.inner2(c0)
        return f1, f2, self.out3(intra)


def position_encoding(h, w, d, like):
    """2-D sine encoding [h*w, d], positions from 1, float32 cast to
    ``like``'s dtype."""
    f32 = dict(dtype=torch.float32, device=like.device)
    y = torch.arange(1, h + 1, **f32)[:, None, None]
    x = torch.arange(1, w + 1, **f32)[None, :, None]
    div = torch.exp(torch.arange(0, d // 2, 2, **f32) * (-math.log(10000.0) / (d // 2)))[None, None, :]
    pe = torch.zeros(h, w, d, **f32)
    pe[:, :, 0::4] = torch.sin(x * div).expand(h, w, -1)
    pe[:, :, 1::4] = torch.cos(x * div).expand(h, w, -1)
    pe[:, :, 2::4] = torch.sin(y * div).expand(h, w, -1)
    pe[:, :, 3::4] = torch.cos(y * div).expand(h, w, -1)
    return pe.reshape(h * w, d).to(like.dtype)


class Attention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.query_projection = nn.Linear(d, d)
        self.key_projection = nn.Linear(d, d)
        self.value_projection = nn.Linear(d, d)
        self.out_projection = nn.Linear(d, d)

    def forward(self, x, src):
        N, L, C = x.shape
        H = self.heads
        q = F.elu(self.query_projection(x).reshape(N, L, H, C // H)) + 1
        k = F.elu(self.key_projection(src).reshape(N, -1, H, C // H)) + 1
        v = self.value_projection(src).reshape(N, -1, H, C // H)
        kv = torch.einsum("nshd,nshm->nhdm", k, v)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(1)) + 1e-6)
        out = torch.einsum("nlhd,nhdm->nlhm", q, kv) * z[..., None]
        return self.out_projection(out.reshape(N, L, C))


class EncoderLayer(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attention = Attention(d, heads)
        self.linear1 = nn.Linear(d, 2 * d)
        self.linear2 = nn.Linear(2 * d, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, src):
        x = self.norm1(x + self.attention(x, src))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class FMT(nn.Module):
    def __init__(self, d, heads, kinds):
        super().__init__()
        self.kinds = tuple(kinds)
        self.layers = nn.ModuleList(EncoderLayer(d, heads) for _ in self.kinds)

    def forward(self, ref, src):
        """ref [B, C, h, w], src [B, S, C, h, w]. Each cross layer attends
        from the sources to the reference's output of the self layer
        before it."""
        B, C, h, w = ref.shape
        S = src.shape[1]
        pe = position_encoding(h, w, C, ref)
        r = ref.flatten(2).transpose(1, 2) + pe
        s = src.reshape(B * S, C, h * w).transpose(1, 2) + pe
        ref_after_self = None
        for kind, layer in zip(self.kinds, self.layers):
            if kind == "self":
                r = layer(r, r)
                ref_after_self = r
                s = layer(s, s)
            else:
                s = layer(s, ref_after_self.repeat_interleave(S, dim=0))
        return (r.transpose(1, 2).reshape(B, C, h, w),
                s.transpose(1, 2).reshape(B, S, C, h, w))


class FMTWithPathway(nn.Module):
    def __init__(self, bc, d, heads, kinds):
        super().__init__()
        self.FMT = FMT(d, heads, kinds)
        self.dim_reduction_1 = nn.Conv2d(4 * bc, 2 * bc, 1, bias=False)
        self.dim_reduction_2 = nn.Conv2d(2 * bc, bc, 1, bias=False)
        self.smooth_1 = nn.Conv2d(2 * bc, 2 * bc, 3, padding=1, bias=False)
        self.smooth_2 = nn.Conv2d(bc, bc, 3, padding=1, bias=False)

    def forward(self, f1, f2, f3):
        """Each [B, V, C, h, w], view 0 the reference."""
        B, V = f1.shape[:2]
        r, s = self.FMT(f1[:, 0], f1[:, 1:])
        f1 = torch.cat([r[:, None], s], 1)
        a, b, c = f1.flatten(0, 1), f2.flatten(0, 1), f3.flatten(0, 1)
        b = self.smooth_1(resize(self.dim_reduction_1(a), b.shape[-2:]) + b)
        c = self.smooth_2(resize(self.dim_reduction_2(b), c.shape[-2:]) + c)
        return f1, b.unflatten(0, (B, V)), c.unflatten(0, (B, V))


class CostRegNet(nn.Module):
    """The 3-D U-Net: [B, 1, D, h, w] -> [B, 1, D, h, w]."""

    def __init__(self, cin=1, c=8):
        super().__init__()
        conv = lambda i, o, s=1: ConvBnReLU(i, o, 3, s, 1, ndim=3)  # noqa: E731
        deconv = lambda i, o: ConvBnReLU(i, o, 3, 2, 1, ndim=3, transpose=True)  # noqa: E731
        self.conv0, self.conv1, self.conv2 = conv(cin, c), conv(c, 2 * c, 2), conv(2 * c, 2 * c)
        self.conv3, self.conv4 = conv(2 * c, 4 * c, 2), conv(4 * c, 4 * c)
        self.conv5, self.conv6 = conv(4 * c, 8 * c, 2), conv(8 * c, 8 * c)
        self.conv7, self.conv9, self.conv11 = deconv(8 * c, 4 * c), deconv(4 * c, 2 * c), deconv(2 * c, c)
        self.prob = nn.Conv3d(c, 1, 3, 1, 1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        x = self.conv6(self.conv5(c4))
        x = c4 + self.conv7(x)
        x = c2 + self.conv9(x)
        x = c0 + self.conv11(x)
        return self.prob(x)


class PixelwiseNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(1, 16, 1, 1, 0, ndim=3)
        self.conv1 = ConvBnReLU(16, 8, 1, 1, 0, ndim=3)
        self.conv2 = nn.Conv3d(8, 1, 1, 1, 0, bias=True)

    def forward(self, x):
        """[N, 1, D, h, w] -> [N, h, w]."""
        return torch.sigmoid(self.conv2(self.conv1(self.conv0(x))))[:, 0].amax(1)


class _DepthNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.pixel_wise_net = PixelwiseNet()


def fused_projection(proj):
    """[..., 2, 4, 4] (extrinsics, intrinsics) -> the 4x4 [[K E[:3]], E[3]]."""
    ext, k = proj[..., 0, :, :], proj[..., 1, :3, :3]
    return torch.cat([k @ ext[..., :3, :], ext[..., 3:, :]], dim=-2)


def warp_correlation(src, ref, src_p, ref_p, depth):
    """Mean over channels of ref times the source warped to each hypothesis.
    src, ref [B, C, h, w]; fused projections [B, 4, 4]; depth [B, D, h, w]
    -> [B, D, h, w]. Points behind the source camera (z < 1e-6) sample
    nothing."""
    B, C, h, w = src.shape
    D = depth.shape[1]
    rel = src_p @ torch.linalg.inv(ref_p)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=src.dtype, device=src.device),
                            torch.arange(w, dtype=src.dtype, device=src.device), indexing="ij")
    pix = torch.stack([xs.flatten(), ys.flatten(), torch.ones_like(xs.flatten())])
    pts = (rel[:, :3, :3] @ pix)[:, :, None, :] * depth.reshape(B, 1, D, h * w) + rel[:, :3, 3, None, None]
    z = pts[:, 2]
    bad = z < 1e-6
    z = torch.where(bad, torch.ones_like(z), z)
    px = torch.where(bad, torch.full_like(z, -1e6), pts[:, 0] / z)
    py = torch.where(bad, torch.full_like(z, -1e6), pts[:, 1] / z)
    warped = sample(src, px, py)  # [B, C, D, h*w]
    return (warped * ref.reshape(B, C, 1, h * w)).mean(1).reshape(B, D, h, w)


def stage_hypotheses(depth_values, prev_depth, ndepth, interval, stage_hw, full_hw):
    """Stage 1: ``ndepth`` planes spread evenly over the sweep's range.
    Later: ``ndepth`` planes ``interval`` apart, centred on the previous
    stage's depth, which is resized to full size and then to the stage's."""
    B = depth_values.shape[0]
    h, w = stage_hw
    d = torch.arange(ndepth, dtype=depth_values.dtype, device=depth_values.device)
    if prev_depth is None:
        lo, hi = depth_values[:, 0], depth_values[:, -1]
        planes = lo[:, None] + d[None] * ((hi - lo) / (ndepth - 1))[:, None]
        return planes[:, :, None, None].expand(B, ndepth, h, w)
    centre = resize(resize(prev_depth[:, None], full_hw), stage_hw)[:, 0]
    offsets = interval[:, None] * (d * (ndepth / (ndepth - 1)) - ndepth / 2)
    return centre[:, None] + offsets[:, :, None, None]


class TransMVSNet(nn.Module):
    def __init__(self, ndepths=(48, 32, 8), ratios=(4.0, 1.0, 0.5), base_channels=8, d_model=32,
                 heads=8, kinds=("self", "cross") * 4, cr_channels=(8, 8, 8)):
        super().__init__()
        self.ndepths, self.ratios = tuple(ndepths), tuple(ratios)
        self.feature = FeatureNet(base_channels)
        self.FMT_with_pathway = FMTWithPathway(base_channels, d_model, heads, kinds)
        self.cost_regularization = nn.ModuleList(CostRegNet(1, c) for c in cr_channels)
        self.DepthNet = _DepthNet()

    def features(self, imgs):
        B, V = imgs.shape[:2]
        f = self.feature(imgs.permute(0, 1, 4, 2, 3).flatten(0, 1))
        return self.FMT_with_pathway(*(t.unflatten(0, (B, V)) for t in f))

    def stage(self, feats, proj, planes, reg, view_weights):
        """One stage: returns (outputs, view weights for the next)."""
        B, V = feats.shape[:2]
        P = fused_projection(proj)
        ref = feats[:, 0]
        sims = torch.stack([warp_correlation(feats[:, v], ref, P[:, v], P[:, 0], planes)
                            for v in range(1, V)], 1)  # [B, S, D, h, w]
        S, D, h, w = sims.shape[1:]
        if view_weights is None:
            w_used = self.DepthNet.pixel_wise_net(sims.reshape(B * S, 1, D, h, w)).reshape(B, S, h, w)
            view_weights = w_used.detach()
        else:
            w_used = view_weights
        wb = w_used[:, :, None]
        similarity = (sims * wb).sum(1) / (1e-5 + wb.sum(1))
        prob = torch.softmax(reg(similarity[:, None])[:, 0], dim=1)
        idx = prob.argmax(1, keepdim=True)
        out = {"depth": torch.gather(planes.expand_as(prob), 1, idx)[:, 0],
               "photo_confidence": prob.amax(1).detach(), "prob_volume": prob, "depth_values": planes}
        return out, view_weights

    def forward(self, imgs, projs, depth_values, given_prev_depth=None):
        """imgs [B, V, H, W, 3], view 0 the reference; projs {"stageN":
        [B, V, 2, 4, 4]}; depth_values [B, Dh]. ``given_prev_depth``
        {"stage2": ..., "stage3": ...}, where given, is the depth each
        stage's hypotheses are centred on in place of this model's own
        previous stage (to follow another program stage by stage)."""
        B, V, H, W, _ = imgs.shape
        feats = self.features(imgs)
        interval = (depth_values[:, -1] - depth_values[:, 0]) / depth_values.shape[1]
        outputs, prev, weights = {}, None, None
        for i in range(len(self.ndepths)):
            key = f"stage{i + 1}"
            scale = 2 ** (len(self.ndepths) - 1 - i)
            hw = (H // scale, W // scale)
            if given_prev_depth is not None and key in given_prev_depth:
                prev = given_prev_depth[key]
            planes = stage_hypotheses(depth_values, None if i == 0 else prev.detach(), self.ndepths[i],
                                      self.ratios[i] * interval, hw, (H, W))
            if i > 0:
                weights = up2(weights)
            out, weights = self.stage(feats[i], projs[key], planes, self.cost_regularization[i], weights)
            prev = out["depth"]
            outputs[key] = out
        return outputs


def blended(outputs):
    """Served depth and confidence: stage-3 confidence times the bilinearly
    resized stage-1 and stage-2 ones; depth 0 where that is below 0.01."""
    depth = outputs["stage3"]["depth"]
    conf = outputs["stage3"]["photo_confidence"]
    for s in ("stage1", "stage2"):
        conf = conf * resize(outputs[s]["photo_confidence"][:, None], depth.shape[-2:])[:, 0]
    return torch.where(conf < 0.01, torch.zeros_like(depth), depth), conf


def calibrate_batchnorm(model, imgs, projs, depth_values):
    """Set every BatchNorm's running statistics to those of one forward on
    these inputs (in eval mode), as a trained model's are set by its data."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    model.eval()
    for m in norms:
        m.calibrating = True
    try:
        with torch.no_grad():
            model(imgs, projs, depth_values)
    finally:
        for m in norms:
            m.calibrating = False
