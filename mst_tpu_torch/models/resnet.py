"""ResNet family: N-D backbone, 3D baseline classifier, MST-ResNet.

Counterpart of `mst_tpu/models/resnet.py`:

- `ResNetBackbone`: the torchvision / MONAI topology over 2 or 3 spatial
  dims (taken from the input's rank): a 7-wide stride-2 stem conv, BN,
  ReLU, a 3-wide stride-2 max pool, then 4 stages of Basic / Bottleneck
  blocks (`_RESNET_LAYERS`: 18 / 34 / 50 / 101 / 152). Its final ReLU
  map is the Grad-CAM target.
- `ResNet3DClassifier`: the 3D baseline (`--model ResNet`, variant 50):
  backbone, global average pool, linear `fc`; `features` / `classify` feed
  its Grad-CAM++ (`train/predictor._resnet3d_saliency`, the gradient of
  the linear head in closed form).
- `ResNetSliceTrans`: MST-ResNet (`--model ResNetSliceTrans`, variant 34):
  the 2D backbone on every slice (gray -> RGB), the mean of each slice's
  map, a volume CLS token (init normal(1)), one pre-norm fusion layer
  (d = 512, 16 heads, FFN 1x, optional RoPE / LiRE), the fusion norm and
  a linear head.

The convolutions are `F.conv2d` / `F.conv3d` (cuDNN on the card): the JAX
package leaves them to XLA, not to Pallas, so no hand-written kernel
replaces a TPU kernel here. Parameters keep the flax names and layouts:
conv kernels [*k, in, out] (permuted to torch's [out, in, *k] per call),
BN `scale` / `bias`. `dtype` is the compute dtype of the backbone (bf16 on
the card); parameters stay f32.

`BatchNorm` has flax's semantics, not torch's (`nn.BatchNorm` defaults:
momentum 0.99, eps 1e-5, the fast variance E[x^2] - E[x]^2 clipped at 0,
statistics in f32 under a bf16 compute dtype): with `train` it normalises
by the batch's mean and biased variance and moves the running statistics
(`mean`, `var`: buffers, JAX's `batch_stats` collection) to 0.99 * ra +
0.01 * batch; without, by the running statistics. A forward takes `train`
as an argument, as `DinoSliceClassifier.forward` does; `nn.Module.train()`
plays no part.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mst_tpu_torch.models.layers import Dense, LayerNorm
from mst_tpu_torch.models.slice_fusion import TransformerEncoderLayer
from mst_tpu_torch.ops.fused_block import _ln

BN_MOMENTUM = 0.99  # flax nn.BatchNorm's default
BN_EPS = 1e-5


class Conv(nn.Module):
    """flax `nn.Conv(use_bias=False)`: kernel [*k, in, out]; symmetric
    padding `padding` on every spatial dim."""

    def __init__(self, dims: int, in_ch: int, out_ch: int, size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(*(size,) * dims, in_ch,
                                               out_ch))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        k = self.kernel.ndim - 2
        w = self.kernel.permute(k + 1, k, *range(k)).to(x.dtype)
        conv = F.conv3d if k == 3 else F.conv2d
        return conv(x, w, stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the channel axis 1 of [N, C, *spatial]:
    parameters `scale`, `bias`; running statistics `mean` (init 0) and
    `var` (init 1) as buffers."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x, train: bool):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        if train:
            axes = [0, *range(2, x.ndim)]
            mu = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mu * mu, min=0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * mu.detach())
                self.var.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * var.detach())
        else:
            mu, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (xf - mu.reshape(shape)) * mul.reshape(shape) + \
            self.bias.reshape(shape)
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, dims: int, in_ch: int, features: int,
                 stride: int = 1):
        super().__init__()
        self.conv1 = Conv(dims, in_ch, features, 3, stride, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(dims, features, features, 3, 1, 1)
        self.bn2 = BatchNorm(features)
        if stride != 1 or in_ch != features:
            self.downsample_conv = Conv(dims, in_ch, features, 1, stride)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x, train: bool):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4  # bottleneck width `features`, output 4x

    def __init__(self, dims: int, in_ch: int, features: int,
                 stride: int = 1):
        super().__init__()
        out = 4 * features
        self.conv1 = Conv(dims, in_ch, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(dims, features, features, 3, stride, 1)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(dims, features, out, 1)
        self.bn3 = BatchNorm(out)
        if stride != 1 or in_ch != out:
            self.downsample_conv = Conv(dims, in_ch, out, 1, stride)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x, train: bool):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return torch.relu(y + residual)


_RESNET_LAYERS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}
WIDTHS = (64, 128, 256, 512)


def resnet_out_channels(variant: int) -> int:
    block, _ = _RESNET_LAYERS[variant]
    return 512 * block.expansion


class ResNetBackbone(nn.Module):
    """[N, C, *spatial] (2 or 3 spatial dims, those of `dims`) -> the final
    ReLU feature map [N, C', *spatial'] in the input's dtype. Blocks are
    `layer{stage}_{i}` (flax's names)."""

    def __init__(self, variant: int = 34, dims: int = 2, in_ch: int = 3):
        super().__init__()
        if variant not in _RESNET_LAYERS:
            raise ValueError(f"unknown ResNet variant {variant}; available: "
                             f"{sorted(_RESNET_LAYERS)}")
        block_cls, counts = _RESNET_LAYERS[variant]
        self.dims = dims
        self.conv1 = Conv(dims, in_ch, WIDTHS[0], 7, 2, 3)
        self.bn1 = BatchNorm(WIDTHS[0])
        ch = WIDTHS[0]
        self.block_names = []
        for stage, (w, n) in enumerate(zip(WIDTHS, counts)):
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block_cls(dims, ch, w, stride))
                self.block_names.append(name)
                ch = w * block_cls.expansion

    def forward(self, x, train: bool = False):
        if x.ndim - 2 != self.dims:
            raise ValueError(f"a {self.dims}D backbone takes [N, C, "
                             f"{self.dims} spatial dims], got {x.ndim - 2}")
        y = torch.relu(self.bn1(self.conv1(x), train))
        pool = F.max_pool3d if self.dims == 3 else F.max_pool2d
        y = pool(y, 3, stride=2, padding=1)
        for name in self.block_names:
            y = getattr(self, name)(y, train)
        return y


def batchnorms(model: nn.Module):
    """[(name, BatchNorm)] of `model` in module order."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, BatchNorm)]


class ResNet3DClassifier(nn.Module):
    """The 3D ResNet baseline (reference `ResNet`, spatial_dims 3, the
    from-scratch MONAI topology): parameters `backbone/...`, `fc/{kernel,
    bias}` (f32). `freeze` is kept for the CLIs' sake and changes nothing:
    JAX's `make_optimizer(freeze_encoder=True)` masks an `encoder` subtree,
    which a ResNet has none of."""

    def __init__(self, out_ch: int = 2, variant: int = 50, in_ch: int = 1,
                 freeze: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant = variant
        self.freeze = freeze
        self.dtype = dtype
        self.config = dict(freeze=freeze)
        self.backbone = ResNetBackbone(variant, dims=3, in_ch=in_ch)
        self.fc = Dense(resnet_out_channels(variant), out_ch)

    def features(self, source, train: bool = False, dtype=None):
        """[B, C, D, H, W] -> the final ReLU map [B, C', D', H', W'] f32."""
        dtype = self.dtype if dtype is None else dtype
        return self.backbone(source.to(dtype), train).float()

    def classify(self, feats):
        """The final map -> logits [B, out_ch] f32 (mean pool, fc)."""
        return self.fc(feats.mean(dim=tuple(range(2, feats.ndim))))

    def forward(self, source, src_key_padding_mask=None, train: bool = False,
                dtype=None):
        """-> logits [B, out_ch] f32; the mask is ignored (every slice is
        in the volume), as in JAX."""
        return self.classify(self.features(source, train, dtype))


class ResNetSliceTrans(nn.Module):
    """MST-ResNet (reference `ResNetSliceTrans`): parameters `backbone/...`
    (2D), `cls_token` [1, 1, e], `fusion_{i}/...`, `fusion_norm`, `linear`
    (f32). `freeze` is kept and changes nothing (see
    `ResNet3DClassifier`)."""

    def __init__(self, out_ch: int = 2, variant: int = 34,
                 fusion_heads: int = 16, fusion_layers: int = 1,
                 rotary: Optional[str] = None, freeze: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant = variant
        self.freeze = freeze
        self.dtype = dtype
        self.fusion_layers = fusion_layers
        self.config = dict(fusion_heads=fusion_heads,
                           fusion_layers=fusion_layers, rotary=rotary,
                           freeze=freeze)
        self.backbone = ResNetBackbone(variant, dims=2, in_ch=3)
        self.emb_ch = emb = resnet_out_channels(variant)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, emb))
        for i in range(fusion_layers):
            self.add_module(f"fusion_{i}", TransformerEncoderLayer(
                emb, fusion_heads, emb, rotary=rotary))
        self.fusion_norm = LayerNorm(emb, 1e-5)
        self.linear = Dense(emb, out_ch)

    def fusion(self, i: int) -> TransformerEncoderLayer:
        return getattr(self, f"fusion_{i}")

    def slice_features(self, source, train: bool = False, dtype=None):
        """[B, C, D, H, W] -> each slice's final ReLU map [B*D, C', H', W']
        f32 (gray -> RGB)."""
        dtype = self.dtype if dtype is None else dtype
        b, c, d, h, w = source.shape
        x = source.permute(0, 2, 1, 3, 4).reshape(b * d, c, h, w)
        if c == 1:
            x = x.expand(b * d, 3, h, w)
        return self.backbone(x.to(dtype), train).float()

    @staticmethod
    def slice_embed(feats):
        return feats.mean(dim=(2, 3))  # [B*D, emb]

    def fuse(self, feats_bde, src_key_padding_mask=None, want_probs=False,
             dtype=None):
        """Pooled slice features [B, D, e] (f32) -> logits [B, out_ch] f32,
        or (logits, the last fusion layer's probabilities [B, heads, 1+D,
        1+D] f32) with `want_probs`. The stream stays in the features'
        dtype; the layers compute in `dtype` (flax's mix)."""
        dtype = self.dtype if dtype is None else dtype
        b = feats_bde.shape[0]
        cls = self.cls_token.to(feats_bde.dtype).expand(b, 1, self.emb_ch)
        h = torch.cat([cls, feats_bde], dim=1)
        pad = None
        if src_key_padding_mask is not None:
            m = torch.as_tensor(src_key_padding_mask, dtype=torch.bool,
                                device=h.device)
            pad = torch.cat([torch.zeros_like(m[:, :1]), m], dim=1)
        probs = None
        for i in range(self.fusion_layers):
            h, probs = self.fusion(i)(h, pad, want_probs=True, dtype=dtype)
        ln = self.fusion_norm
        h = _ln(h[:, 0], ln.scale, ln.bias, ln.eps).to(dtype)
        logits = self.linear(h.float())
        return (logits, probs) if want_probs else logits

    def forward(self, source, src_key_padding_mask=None, train: bool = False,
                dtype=None):
        """-> logits [B, out_ch] f32."""
        b, d = source.shape[0], source.shape[2]
        feats = self.slice_features(source, train, dtype)
        emb = self.slice_embed(feats).reshape(b, d, self.emb_ch)
        return self.fuse(emb, src_key_padding_mask, dtype=dtype)

