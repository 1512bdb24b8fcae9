"""Plain PyTorch CenterFusion / CenterNet: the benchmark's reference model.

A frozen, self-contained copy of the detector's plain path (DLA-34,
DLAUp/IDAUp with DCNv2 nodes, the CenterNet heads and the middle-fusion
secondary heads), written from the published description of CenterFusion
(Nabati and Qi, WACV 2021, arXiv:2011.04841) and the reference
implementation's module layout, so that a checkpoint's parameter names load
unchanged. It imports nothing of the program: no kernel, no config
reader. Every contraction is a plain ``F.conv2d`` / ``torch.matmul`` in the
parameters' dtype (float32; TF32 is switched off by the caller), and the
DCN is bilinear sampling followed by one matmul per tap.

``quant`` on :class:`Ref` rounds the operands of every contraction (a
convolution's input and weight, the DCN's sampled taps and weight) to a
lower precision: the control of the correctness check.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)
SECONDARY_HEADS = ("velocity", "nuscenes_att", "depth2", "rotation2")
FIRST_LEVEL, LAST_LEVEL = 2, 5


class Quant:
    """Holds the rounding applied to contraction operands (None: exact)."""

    def __init__(self):
        self.fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.fn is None else self.fn(t)


def _round(t: torch.Tensor, fmt, top: float) -> torch.Tensor:
    """``t`` through the float8 format ``fmt`` with one per-tensor scale
    (its largest magnitude onto ``top``, the format's largest finite
    value), back in ``t``'s dtype."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    q = (t.detach().float() * scale).clamp(-top, top).to(fmt)
    return (q.float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """fp8 operands as fp8 training takes them: e4m3 forward, the
    gradient that flows back through the operand rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """The operand rounding of an fp8 contraction (see :class:`_Fp8`)."""
    return _Fp8.apply(t)


class QConv2d(nn.Conv2d):
    def __init__(self, *args, quant: Quant, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return F.conv2d(self.quant(x), self.quant(self.weight), self.bias,
                        self.stride, self.padding, self.dilation, self.groups)


class QConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, quant: Quant, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return F.conv_transpose2d(self.quant(x), self.quant(self.weight),
                                  self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


# --------------------------------------------------------------------- DCN
def dcn_taps(x, offset, mask):
    """The 9 modulated taps of DCNv2 (torchvision's layout: offset[:, 2k]
    is dy_k, offset[:, 2k+1] dx_k, k = 3i + j): each (B, C, H*W), the
    bilinear sample of x at the tap's point times its mask; a corner outside
    the image reads zero."""
    b, c, h, w = x.shape
    hw = h * w
    flat = x.reshape(b, c, hw)
    off = offset.reshape(b, 9, 2, hw)
    msk = mask.reshape(b, 9, hw)
    pos = torch.arange(hw, device=x.device)
    base_y = torch.div(pos, w, rounding_mode="floor").to(x.dtype)
    base_x = (pos % w).to(x.dtype)
    for k in range(9):
        i, j = divmod(k, 3)
        py = base_y + (i - 1) + off[:, k, 0]
        px = base_x + (j - 1) + off[:, k, 1]
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = py - y0, px - x0
        tap = None
        for cy in (0, 1):
            for cx in (0, 1):
                yy, xx = y0 + cy, x0 + cx
                valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
                vals = torch.gather(flat, 2, idx[:, None, :].expand(b, c, hw))
                wgt = ((ly if cy else 1 - ly) * (lx if cx else 1 - lx)
                       * valid.to(x.dtype))
                term = vals * wgt[:, None, :]
                tap = term if tap is None else tap + term
        yield i, j, tap * msk[:, k:k + 1]


def _dcn(x, offset, mask, weight, quant: Quant, only=None):
    """sum over taps of W_tap @ tap; ``only``: that tap alone."""
    out = None
    qw = quant(weight)
    for k, (i, j, tap) in enumerate(dcn_taps(x, offset, mask)):
        if only is not None and k != only:
            continue
        term = torch.matmul(qw[:, :, i, j], quant(tap))
        out = term if out is None else out + term
    return out


class _DCN(torch.autograd.Function):
    """The DCN contraction whose backward recomputes one tap at a time
    and differentiates it with autograd, so that a node's backward holds
    one tap's sampling at once, not nine."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, quant):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.quant = quant
        with torch.no_grad():
            return _dcn(x, offset, mask, weight, quant)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip((x, offset, mask, weight), ctx.needs_input_grad[:4])]
        grads = [None] * 4
        for k in range(9):
            with torch.enable_grad():
                term = _dcn(*leaves, ctx.quant, only=k)
                want = [t for t in leaves if t.requires_grad]
                got = torch.autograd.grad(term, want, g)
            it = iter(got)
            for n, t in enumerate(leaves):
                if t.requires_grad:
                    d = next(it)
                    grads[n] = d if grads[n] is None else grads[n] + d
        return (*grads, None)


def deform_conv2d(x, offset, mask, weight, bias, quant: Quant):
    b, _, h, w = x.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, offset, mask, weight)):
        out = _DCN.apply(x, offset, mask, weight, quant)
    else:
        out = _dcn(x, offset, mask, weight, quant)
    return (out + bias[:, None]).reshape(b, weight.shape[0], h, w)


class DeformConvNode(nn.Module):
    def __init__(self, cin, cout, quant: Quant):
        super().__init__()
        self.quant = quant
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = QConv2d(cin, 27, 3, padding=1, quant=quant)
        self.activation = nn.Sequential(nn.BatchNorm2d(cout), nn.ReLU())
        self.dcn_fn = deform_conv2d

    def forward(self, x):
        om = self.conv_offset_mask(x)
        y = self.dcn_fn(x, om[:, :18].contiguous(),
                        torch.sigmoid(om[:, 18:]), self.weight, self.bias,
                        self.quant)
        return self.activation(y)


# ----------------------------------------------------------------- DLA-34
def conv_bn_relu(cin, cout, quant, k=3, stride=1):
    return [QConv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                    bias=False, quant=quant), nn.BatchNorm2d(cout), nn.ReLU()]


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride, quant):
        super().__init__()
        self.conv1 = QConv2d(cin, cout, 3, stride=stride, padding=1,
                             bias=False, quant=quant)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = QConv2d(cout, cout, 3, padding=1, bias=False, quant=quant)
        self.bn2 = nn.BatchNorm2d(cout)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + residual)


class Root(nn.Module):
    def __init__(self, cin, cout, quant):
        super().__init__()
        self.conv = QConv2d(cin, cout, 1, bias=False, quant=quant)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, children):
        return F.relu(self.bn(self.conv(torch.cat(list(children), 1))))


class Tree(nn.Module):
    def __init__(self, levels, cin, cout, quant, stride=1, level_root=False,
                 root_dim=0):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        self.levels, self.level_root, self.stride = levels, level_root, stride
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride, quant)
            self.tree2 = BasicBlock(cout, cout, 1, quant)
            self.root = Root(root_dim, cout, quant)
            self.project = (nn.Sequential(
                QConv2d(cin, cout, 1, bias=False, quant=quant),
                nn.BatchNorm2d(cout)) if cin != cout else None)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, quant, stride)
            self.tree2 = Tree(levels - 1, cout, cout, quant,
                              root_dim=root_dim + cout)

    def forward(self, x, children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) \
            if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = bottom if self.project is None else self.project(bottom)
            x1 = self.tree1(x, residual)
            return self.root([self.tree2(x1), x1, *children])
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DLA(nn.Module):
    def __init__(self, quant):
        super().__init__()
        ch, lv = DLA34_CHANNELS, DLA34_LEVELS
        self.base_layer = nn.Sequential(*conv_bn_relu(3, ch[0], quant, 7))
        self.level0 = nn.Sequential(*conv_bn_relu(ch[0], ch[0], quant))
        self.level1 = nn.Sequential(*conv_bn_relu(ch[0], ch[1], quant,
                                                  stride=2))
        self.level2 = Tree(lv[2], ch[1], ch[2], quant, 2)
        self.level3 = Tree(lv[3], ch[2], ch[3], quant, 2, level_root=True)
        self.level4 = Tree(lv[4], ch[3], ch[4], quant, 2, level_root=True)
        self.level5 = Tree(lv[5], ch[4], ch[5], quant, 2, level_root=True)

    def forward(self, x):
        x = self.base_layer(x)
        feats = []
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            feats.append(x)
        return feats


def bilinear_kernel(factor: int) -> torch.Tensor:
    size = 2 * factor
    f = math.ceil(size / 2)
    center = (2 * f - 1 - f % 2) / (2.0 * f)
    k1d = 1 - np.abs(np.arange(size) / f - center)
    return torch.from_numpy(np.outer(k1d, k1d).astype(np.float32))


class IDAUp(nn.Module):
    def __init__(self, cout, in_channels, up_factors, quant):
        super().__init__()
        for i in range(1, len(in_channels)):
            f = int(up_factors[i])
            setattr(self, f"proj_{i}",
                    DeformConvNode(int(in_channels[i]), cout, quant))
            up = QConvTranspose2d(cout, cout, 2 * f, stride=f,
                                  padding=f // 2, groups=cout, bias=False,
                                  quant=quant)
            with torch.no_grad():
                up.weight.copy_(bilinear_kernel(f).expand_as(up.weight))
            setattr(self, f"up_{i}", up)
            setattr(self, f"node_{i}", DeformConvNode(cout, cout, quant))

    def forward(self, layers, startp, endp):
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            x = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(layers[i]))
            layers[i] = getattr(self, f"node_{j}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    def __init__(self, startp, channels, quant):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = np.array([2 ** i for i in range(len(channels))], int)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(channels[j], in_channels[j:],
                                            (scales[j:] // scales[j]).tolist(),
                                            quant))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers):
        layers = list(layers)
        out = [layers[-1]]
        for i in range(len(layers) - self.startp - 1):
            layers = getattr(self, f"ida_{i}")(layers, len(layers) - i - 2,
                                               len(layers))
            out.insert(0, layers[-1])
        return out


# ------------------------------------------------------------------- heads
def sigmoid_depth(x):
    return 1.0 / (torch.sigmoid(x) + 1e-6) - 1.0


def resize_nearest(x, size_hw):
    h, w = x.shape[-2:]
    oh, ow = int(size_hw[0]), int(size_hw[1])
    if (h, w) == (oh, ow):
        return x
    iy = ((torch.arange(oh, device=x.device, dtype=torch.float64) + 0.5)
          * (h / oh)).floor().long().clamp(max=h - 1)
    ix = ((torch.arange(ow, device=x.device, dtype=torch.float64) + 0.5)
          * (w / ow)).floor().long().clamp(max=w - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def head_tower(cin, nout, hidden, quant):
    layers = [QConv2d(cin, hidden[0], 3, padding=1, quant=quant), nn.ReLU()]
    for prev, h in zip(hidden[:-1], hidden[1:]):
        layers += [QConv2d(prev, h, 1, quant=quant), nn.ReLU()]
    return nn.Sequential(*layers, QConv2d(hidden[-1], nout, 1, quant=quant))


class DetectHeadSet(nn.Module):
    def __init__(self, cin, heads, head_conv, secondary, quant):
        super().__init__()
        self.first = [n for n in heads if n not in secondary]
        self.secondary = [n for n in secondary if n in heads]
        for name, nout in heads.items():
            width = cin + (3 if name in self.secondary else 0)
            setattr(self, name, head_tower(width, int(nout),
                                           tuple(head_conv[name]), quant))

    def first_stage(self, feats):
        y = {n: getattr(self, n)(feats) for n in self.first}
        y["heatmap"] = torch.clamp(torch.sigmoid(y["heatmap"]), 1e-4,
                                   1 - 1e-4)
        y["depthMap"] = y["depth"]
        y["depth"] = sigmoid_depth(y["depth"])
        return y

    def second_stage(self, feats, pc_hm):
        pc = resize_nearest(pc_hm, feats.shape[-2:]).to(feats.dtype)
        sec = torch.cat([feats, pc], 1)
        y = {n: getattr(self, n)(sec) for n in self.secondary}
        if "depth2" in y:
            y["depthMap"] = y["depth2"]
            y["depth2"] = sigmoid_depth(y["depth2"])
        y["pc_hm_out"] = pc[:, :1]
        return y


class Ref(nn.Module):
    """DLA-34 + DLAUp/IDAUp + heads. ``middle``: radar middle fusion with
    the frustum association (CenterFusion); otherwise camera only
    (CenterNet)."""

    def __init__(self, heads: Dict[str, int], head_conv, middle: bool,
                 k: int = 100, max_pc_dist: float = 60.0):
        super().__init__()
        self.quant = Quant()
        self.middle, self.k, self.max_pc_dist = middle, k, max_pc_dist
        ch = DLA34_CHANNELS
        self.base = DLA(self.quant)
        self.dla_up = DLAUp(FIRST_LEVEL, ch[FIRST_LEVEL:], self.quant)
        self.ida_up = IDAUp(ch[FIRST_LEVEL], ch[FIRST_LEVEL:LAST_LEVEL],
                            [2 ** i for i in range(LAST_LEVEL - FIRST_LEVEL)],
                            self.quant)
        self.detectHead_0 = DetectHeadSet(
            ch[FIRST_LEVEL], heads, head_conv,
            SECONDARY_HEADS if middle else (), self.quant)

    def features(self, x):
        pyramid = self.dla_up(self.base(x))
        y = list(pyramid[:LAST_LEVEL - FIRST_LEVEL])
        return self.ida_up(y, 0, len(y))[-1]

    def forward(self, image, pc_dep=None, calib=None, pc_hm=None,
                frustum_from: Optional[Dict[str, torch.Tensor]] = None):
        """image (B, 3, H, W) normalized; pc_dep (B, 3, H/4, W/4) the raw
        radar map; calib (B, 3, 4). ``pc_hm`` given (training): the
        secondary heads take it and no association runs. Otherwise the
        frustum association runs on the first-stage heads, or on
        ``frustum_from`` (another model's first-stage heads: the check
        follows the program's top-K there)."""
        feats = self.features(image)
        y = self.detectHead_0.first_stage(feats)
        if self.middle:
            y["pc_hm_in"] = pc_dep[:, :1]
            if pc_hm is None:
                from .postprocess import frustum_heatmap

                pc_hm = frustum_heatmap(frustum_from or y, pc_dep, calib,
                                        self.k, self.max_pc_dist)
            y["pc_hm"] = pc_hm[:, 0:1]
            y.update(self.detectHead_0.second_stage(feats, pc_hm))
        return y


def build_reference(cfg: dict) -> Ref:
    """The reference model of a configuration file's ``model`` block."""
    m = cfg["model"]
    return Ref(m["heads"], m["head_conv"], bool(m["middle_fusion"]),
               int(m["K"]), float(m["max_pc_dist"]))
