"""InceptionV3 FID detector: the TF-slim inception-2015-12-05 graph.

Counterpart of vivid_tpu/metrics/inception_jax.py as an `nn.Module`, from a
copy of its architecture spec (`INCEPTION_V3_SPEC`). uint8 NHWC images in,
[N, 2048] fp32 pool3 features out. Preprocessing is TF1's bilinear resize to
299 (corner-origin: source = destination * in / out, clamped; the NVIDIA
pickle emulates it, and FID is sensitive to it, so a half-pixel resize is
not the same), then (x - 128) / 128. Each conv is followed by TF-slim's batch
norm (moving statistics and beta, no scale, eps 1e-3) and a ReLU. TF `SAME`
average pools divide by the count of cells inside the image, max pools pad
with -inf.

With `use_bf16` (the default on a card, as the JAX package's device path)
the network runs in bf16, channels-last, at the JAX package's rounding
points: each conv's output rounds to bf16 once, batch norm and ReLU run in
fp32 and round back, average pools sum in fp32, and the mean over pixels is
taken in fp32. Weights come from the NVIDIA pickle (`load_torch_module`), a
seeded random draw (`init_random`), or the JAX package's parameter tree
(compat/from_jax.py).
"""

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Architecture spec (a copy of the JAX package's). Node kinds:
#   ("conv", name, cout, (kh, kw), stride, pad)   pad in {"SAME", "VALID"}
#   ("max"|"avg", (kh, kw), stride, pad)
#   ("fan", (branch, ...))  — each branch (a tuple of nodes) on the same
#                             input, the results concatenated on channels
# Names follow TF-slim.


def _c(name, cout, k, s=1, pad="SAME"):
    return ("conv", name, cout, (k, k) if isinstance(k, int) else k, s, pad)


def _prefix(node, pre):
    if node[0] == "conv":
        return (node[0], f"{pre}/{node[1]}") + node[2:]
    if node[0] == "fan":
        return ("fan", tuple(tuple(_prefix(n, pre) for n in br) for br in node[1]))
    return node


def _mixed(name, *branches):
    return ("fan", tuple(tuple(_prefix(n, f"{name}/Branch_{i}") for n in br)
                         for i, br in enumerate(branches)))


def _inception_a(name, pool_ch):
    return _mixed(
        name,
        (_c("Conv2d_0a_1x1", 64, 1),),
        (_c("Conv2d_0a_1x1", 48, 1), _c("Conv2d_0b_5x5", 64, 5)),
        (_c("Conv2d_0a_1x1", 64, 1), _c("Conv2d_0b_3x3", 96, 3),
         _c("Conv2d_0c_3x3", 96, 3)),
        (("avg", (3, 3), 1, "SAME"), _c("Conv2d_0b_1x1", pool_ch, 1)),
    )


def _inception_b(name, c7):
    return _mixed(
        name,
        (_c("Conv2d_0a_1x1", 192, 1),),
        (_c("Conv2d_0a_1x1", c7, 1), _c("Conv2d_0b_1x7", c7, (1, 7)),
         _c("Conv2d_0c_7x1", 192, (7, 1))),
        (_c("Conv2d_0a_1x1", c7, 1), _c("Conv2d_0b_7x1", c7, (7, 1)),
         _c("Conv2d_0c_1x7", c7, (1, 7)), _c("Conv2d_0d_7x1", c7, (7, 1)),
         _c("Conv2d_0e_1x7", 192, (1, 7))),
        (("avg", (3, 3), 1, "SAME"), _c("Conv2d_0b_1x1", 192, 1)),
    )


def _inception_c(name):
    return _mixed(
        name,
        (_c("Conv2d_0a_1x1", 320, 1),),
        (_c("Conv2d_0a_1x1", 384, 1),
         ("fan", ((_c("Conv2d_0b_1x3", 384, (1, 3)),),
                  (_c("Conv2d_0c_3x1", 384, (3, 1)),)))),
        (_c("Conv2d_0a_1x1", 448, 1), _c("Conv2d_0b_3x3", 384, 3),
         ("fan", ((_c("Conv2d_0c_1x3", 384, (1, 3)),),
                  (_c("Conv2d_0d_3x1", 384, (3, 1)),)))),
        (("avg", (3, 3), 1, "SAME"), _c("Conv2d_0b_1x1", 192, 1)),
    )


INCEPTION_V3_SPEC: Tuple = (
    _c("Conv2d_1a_3x3", 32, 3, s=2, pad="VALID"),
    _c("Conv2d_2a_3x3", 32, 3, pad="VALID"),
    _c("Conv2d_2b_3x3", 64, 3),
    ("max", (3, 3), 2, "VALID"),
    _c("Conv2d_3b_1x1", 80, 1, pad="VALID"),
    _c("Conv2d_4a_3x3", 192, 3, pad="VALID"),
    ("max", (3, 3), 2, "VALID"),
    _inception_a("Mixed_5b", 32),
    _inception_a("Mixed_5c", 64),
    _inception_a("Mixed_5d", 64),
    _mixed("Mixed_6a",
           (_c("Conv2d_1a_1x1", 384, 3, s=2, pad="VALID"),),
           (_c("Conv2d_0a_1x1", 64, 1), _c("Conv2d_0b_3x3", 96, 3),
            _c("Conv2d_1a_1x1", 96, 3, s=2, pad="VALID")),
           (("max", (3, 3), 2, "VALID"),)),
    _inception_b("Mixed_6b", 128),
    _inception_b("Mixed_6c", 160),
    _inception_b("Mixed_6d", 160),
    _inception_b("Mixed_6e", 192),
    _mixed("Mixed_7a",
           (_c("Conv2d_0a_1x1", 192, 1), _c("Conv2d_1a_3x3", 320, 3, s=2, pad="VALID")),
           (_c("Conv2d_0a_1x1", 192, 1), _c("Conv2d_0b_1x7", 192, (1, 7)),
            _c("Conv2d_0c_7x1", 192, (7, 1)),
            _c("Conv2d_1a_3x3", 192, 3, s=2, pad="VALID")),
           (("max", (3, 3), 2, "VALID"),)),
    _inception_c("Mixed_7b"),
    _inception_c("Mixed_7c"),
)

FEATURE_DIM = 2048
BN_EPS = 1e-3
INPUT_SIZE = 299


def _walk_convs(spec, cin, out: list) -> int:
    for node in spec:
        if node[0] == "conv":
            _, name, cout, k, s, pad = node
            out.append((name, cin, cout, k, s, pad))
            cin = cout
        elif node[0] == "fan":
            cin = sum(_walk_convs(br, cin, out) for br in node[1])
    return cin


def iter_convs(spec=INCEPTION_V3_SPEC, cin=3):
    """(name, cin, cout, kernel, stride, pad) of every conv, in topological order."""
    out: list = []
    _walk_convs(spec, cin, out)
    return out


def same_pads(size: int, k: int, stride: int):
    """TF `SAME` padding of one axis: (before, after)."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def tf1_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 `resize_bilinear(align_corners=False)` of NHWC fp32 `x`: source
    position = destination * (in / out), clamped at the border; gather and
    lerp with the JAX package's float32 weights."""
    h, w = x.shape[1], x.shape[2]

    def axis(in_size, out_size):
        p = np.arange(out_size) * (in_size / out_size)
        i0 = np.floor(p).astype(np.int64)
        t = (p - i0).astype(np.float32)
        i1 = np.minimum(i0 + 1, in_size - 1)
        return (torch.from_numpy(i0).to(x.device), torch.from_numpy(i1).to(x.device),
                torch.from_numpy(1.0 - t).to(x.device), torch.from_numpy(t).to(x.device))

    y0, y1, wy0, wy1 = axis(h, out_h)
    x0, x1, wx0, wx1 = axis(w, out_w)
    rows = x[:, y0] * wy0[None, :, None, None] + x[:, y1] * wy1[None, :, None, None]
    return rows[:, :, x0] * wx0[None, None, :, None] + rows[:, :, x1] * wx1[None, None, :, None]


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] pixels (uint8) -> [N, 3, 299, 299] fp32 in [-1, 1],
    channels-last in memory."""
    x = images.float()
    if x.shape[1:3] != (INPUT_SIZE, INPUT_SIZE):
        x = tf1_resize_bilinear(x, INPUT_SIZE, INPUT_SIZE)
    return ((x - 128.0) / 128.0).permute(0, 3, 1, 2)


def pool(kind: str, x: torch.Tensor, k, stride: int, pad: str) -> torch.Tensor:
    """TF max / average pool of NCHW `x`, `SAME` or `VALID`."""
    if pad == "SAME":
        (top, bottom), (left, right) = (same_pads(x.shape[2], k[0], stride),
                                        same_pads(x.shape[3], k[1], stride))
    else:
        top = bottom = left = right = 0
    if kind == "max":
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        return F.max_pool2d(x, k, stride)
    if (top, left) != (bottom, right):
        raise NotImplementedError(f"asymmetric SAME average pool {k}/{stride} at {x.shape}")
    # count_include_pad=False: each window divides by its cells inside the image.
    y = F.avg_pool2d(x.float(), k, stride, padding=(top, left), count_include_pad=False)
    return y.to(x.dtype)


class ConvBN(nn.Module):
    """A conv without bias, then TF-slim's batch norm (moving mean and
    variance, beta, no scale) and a ReLU."""

    def __init__(self, cin, cout, k, stride, pad, device=None):
        super().__init__()
        self.stride, self.pad, self.k = stride, pad, k
        self.weight = nn.Parameter(torch.empty(cout, cin, *k, device=device))
        self.register_buffer("mean", torch.zeros(cout, device=device))
        self.register_buffer("var", torch.ones(cout, device=device))
        self.register_buffer("beta", torch.zeros(cout, device=device))

    def forward(self, x):
        padding = 0
        if self.pad == "SAME":
            (top, bottom), (left, right) = (same_pads(x.shape[2], self.k[0], self.stride),
                                            same_pads(x.shape[3], self.k[1], self.stride))
            if (top, left) == (bottom, right):
                padding = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=padding)
        shape = (1, -1, 1, 1)
        y = (y.float() - self.mean.view(shape)) * torch.rsqrt(self.var.view(shape) + BN_EPS) \
            + self.beta.view(shape)
        return F.relu(y).to(x.dtype)


class InceptionV3(nn.Module):
    """uint8 [N, H, W, 3] on the module's device -> [N, 2048] fp32 pool3
    features. Parameters are
    named after the TF-slim convs: `convs.<scope>/<conv>.weight` and the
    buffers `.mean`, `.var`, `.beta`."""

    def __init__(self, use_bf16: bool = False, device=None):
        super().__init__()
        self.use_bf16 = use_bf16
        self.convs = nn.ModuleDict({
            name: ConvBN(cin, cout, k, s, pad, device=device)
            for name, cin, cout, k, s, pad in iter_convs()})

    def _seq(self, spec, x):
        for node in spec:
            if node[0] == "conv":
                x = self.convs[node[1]](x)
            elif node[0] in ("max", "avg"):
                _, k, s, pad = node
                x = pool(node[0], x, k, s, pad)
            else:
                x = torch.cat([self._seq(br, x) for br in node[1]], dim=1)
        return x

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = preprocess(images)
        if self.use_bf16:
            x = x.to(torch.bfloat16)
        with torch.no_grad():
            y = self._seq(INCEPTION_V3_SPEC, x)
        return y.float().mean(dim=(2, 3))

    def init_random(self, seed: int = 0):
        """Seeded random weights with the JAX package's `init_params`
        distributions: w ~ N(0, 1) / sqrt(fan_in), beta and mean ~ N(0, 0.1²),
        var ~ 1 + U(0, 0.1). (Another stream than JAX's PRNGKey draw.)"""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for conv in self.convs.values():
                cout, cin, kh, kw = conv.weight.shape
                draws = (torch.randn(conv.weight.shape, generator=gen) / math.sqrt(cin * kh * kw),
                         torch.randn(cout, generator=gen) * 0.1,
                         torch.randn(cout, generator=gen) * 0.1,
                         1.0 + 0.1 * torch.rand(cout, generator=gen))
                for dst, src in zip((conv.weight, conv.beta, conv.mean, conv.var), draws):
                    dst.copy_(src)
        return self

    def load_torch_module(self, net):
        """Weights of a reconstructed NVIDIA inception-2015-12-05 torch module
        (the reference's pickle): one (conv, batch norm) pair per TF-slim conv,
        matched in topological order and checked by shape."""
        convs, bns = [], []
        for m in net.modules():
            cls = type(m).__name__.lower()
            weight = getattr(m, "weight", None)
            if weight is not None:
                if weight.ndim == 4 and "conv" in cls:
                    convs.append(m)
                elif "batchnorm" in cls or "bn" in cls or hasattr(m, "running_mean"):
                    bns.append(m)
            elif getattr(m, "running_mean", None) is not None:
                bns.append(m)
        spec_convs = iter_convs()
        if len(convs) != len(spec_convs):
            raise ValueError(f"torch module has {len(convs)} convs, spec expects "
                             f"{len(spec_convs)}: not an inception-2015-12-05 module "
                             "this importer understands")
        with torch.no_grad():
            for (name, cin, cout, (kh, kw), _, _), src in zip(spec_convs, convs):
                dst = self.convs[name]
                if tuple(src.weight.shape) != (cout, cin, kh, kw):
                    raise ValueError(f"{name}: torch conv weight {tuple(src.weight.shape)} "
                                     f"!= spec {(cout, cin, kh, kw)}")
                dst.weight.copy_(src.weight)
                bn = bns.pop(0) if bns else None
                if bn is not None and bn.running_mean.shape[0] == cout:
                    dst.mean.copy_(bn.running_mean)
                    dst.var.copy_(bn.running_var)
                    beta = getattr(bn, "bias", None)
                    dst.beta.copy_(beta if beta is not None else torch.zeros(cout))
                else:
                    bias = getattr(src, "bias", None)
                    dst.mean.zero_()
                    dst.var.fill_(1.0)
                    dst.beta.copy_(bias if bias is not None else torch.zeros(cout))
        return self
