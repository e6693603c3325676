"""A bottleneck-block ResNet (He et al. 2016, Table 1: ResNet-50, -101 and
-152; v1.5, the stride on the 3x3 conv) at a given input size, layer by
layer, and the heads. A configuration whose ``model.block`` is
``bottleneck_v1_5`` is counted here (``model.block``); v1, with the
stride on the first 1x1 conv, does other work and would have a module of
its own. ``widths`` are the stages' output widths, each block working at
a quarter of its stage's (1x1 reduce, 3x3, 1x1 expand by 4), the stem at
a quarter of the first.

Operations as in ``resnet_basic``: a conv's 2·B·Ho·Wo·F·k·k·C, the stem on
one input plane (the three input channels repeat one log-mel plane), the
max-pool, residual adds and global pool one operation an element. Bytes
are counted at float32, the dtype the configuration that runs this block
computes in: each conv's input read once (a strided 1x1 conv reads the
pixels it uses), its weight, its output, its BN scale and bias.

The products are counted in ``Work.ops_bf16`` and so bounded at the tensor
cores' 989 TFLOP/s, although the configuration's float32 runs on the CUDA
cores (67 TFLOP/s): a float32-accurate route on the tensor cores (3xTF32
splits, say) does this work faster than the CUDA-core peak allows, and a
share taken against that peak would then pass 100%. Against the tensor
cores' rate every route reads below 100%.

At 224² with three stem planes ResNet-50/101/152 count 4.09 / 7.80 /
11.51 GMAC (torchvision's published figures).
"""

from __future__ import annotations

from typing import List, Sequence

from portbench.work import resnet_basic
from portbench.work.peaks import Work

F32 = 4
EXPANSION = 4


class Conv(resnet_basic.Conv):
    """A conv whose tensors are float32."""

    def work(self, batch: int) -> Work:
        ho, wo = self.hout, self.wout
        ops = 2.0 * batch * ho * wo * self.cout * self.k * self.k * self.cin
        pixels = ho * wo if self.k == 1 else self.hin * self.win
        nbytes = F32 * (batch * pixels * self.cin + self.cout * self.k * self.k * self.cin
                        + batch * ho * wo * self.cout + 2 * self.cout)
        return Work(ops_bf16=ops, bytes=nbytes)


def resnet_convs(h: int, w: int, stages: Sequence[int] = (3, 8, 36, 3),
                 widths: Sequence[int] = (256, 512, 1024, 2048), stem_cin: int = 1) -> List[Conv]:
    """Every conv of a bottleneck ResNet in order: the 7x7/2 stem, then each
    block's 1x1 reduce, 3x3 and 1x1 expand, and its 1x1 downsample."""
    stem = widths[0] // EXPANSION
    convs = [Conv("stem", stem_cin, stem, 7, 2, h, w)]
    h, w = -(-h // 4), -(-w // 4)  # stem stride 2, max-pool stride 2
    cin = stem
    for s, (n, f) in enumerate(zip(stages, widths), start=1):
        inner = f // EXPANSION
        for b in range(n):
            stride = 2 if (s > 1 and b == 0) else 1
            ho, wo = -(-h // stride), -(-w // stride)
            convs.append(Conv(f"layer{s}.{b}.conv1", cin, inner, 1, 1, h, w))
            convs.append(Conv(f"layer{s}.{b}.conv2", inner, inner, 3, stride, h, w))
            convs.append(Conv(f"layer{s}.{b}.conv3", inner, f, 1, 1, ho, wo))
            if stride != 1 or cin != f:
                convs.append(Conv(f"layer{s}.{b}.downsample", cin, f, 1, stride, h, w))
            h, w, cin = ho, wo, f
    return convs


def _elementwise(batch: int, h: int, w: int, stages, widths) -> Work:
    """Max-pool (read the stem's output, write a quarter), each block's
    residual add (read the identity once more), the global average pool
    (read the last map)."""
    stem = widths[0] // EXPANSION
    sh, sw = -(-h // 2), -(-w // 2)
    ph, pw = -(-sh // 2), -(-sw // 2)
    nbytes = F32 * batch * stem * (sh * sw + ph * pw)
    ops = 9.0 * batch * stem * ph * pw
    hh, ww = ph, pw
    for s, (n, f) in enumerate(zip(stages, widths), start=1):
        if s > 1:
            hh, ww = -(-hh // 2), -(-ww // 2)
        nbytes += F32 * n * batch * f * hh * ww
        ops += 2.0 * n * batch * f * hh * ww
    nbytes += F32 * batch * widths[-1] * hh * ww
    ops += batch * widths[-1] * hh * ww
    return Work(ops_f32=ops, bytes=nbytes)


def backbone_work(batch: int, h: int, w: int, stages=(3, 8, 36, 3),
                  widths=(256, 512, 1024, 2048), stem_cin: int = 1) -> Work:
    """One backbone's forward over ``batch`` inputs of h×w."""
    total = Work()
    for c in resnet_convs(h, w, stages, widths, stem_cin):
        total = total + c.work(batch)
    return total + _elementwise(batch, h, w, stages, widths)


def heads_work(batch: int, n_heads: int, features: int = 2048,
               hidden: Sequence[int] = (512, 256), outputs: int = 5) -> Work:
    """N heads' Linear layers (eval BN folded in) on pooled features, float32."""
    w = resnet_basic.heads_work(batch, n_heads, features, hidden, outputs)
    return Work(ops_bf16=w.ops_bf16, bytes=w.bytes * F32 / resnet_basic.BF16)
