"""A basic-block ResNet (He et al. 2016, Table 1: ResNet-18 and -34) at a
given input size, layer by layer, and the binary heads. A configuration
whose ``model.block`` is ``basic`` is counted here (``model.block``).

A conv's operations are 2·B·Ho·Wo·F·k·k·C; its bytes are its input read
once (a 1x1 stride-2 conv reads the quarter of the pixels it uses), its
weight, its output written once, all bf16, and its float32 BN scale and
bias. At 512², batch 128, the sixteen 3x3 convs and the three 1x1
downsamples are 2.268 TFLOP and 4.636 GB.

The stem is counted on one input plane: the serving and training inputs
repeat one log-mel plane on three channels, so the function needs a third
of a three-channel stem's products. The max-pool, the residual adds and the
pooling before the heads are counted as the bytes they must read and write
and one operation an element; BN and ReLU ride in the conv's epilogue.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from portbench.work.peaks import Work

BF16 = 2
F32 = 4


@dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    hin: int
    win: int

    @property
    def hout(self) -> int:
        return -(-self.hin // self.stride)

    @property
    def wout(self) -> int:
        return -(-self.win // self.stride)

    def work(self, batch: int) -> Work:
        ho, wo = self.hout, self.wout
        ops = 2.0 * batch * ho * wo * self.cout * self.k * self.k * self.cin
        if self.k == 1:
            x = batch * ho * wo * self.cin
        else:
            x = batch * self.hin * self.win * self.cin
        nbytes = BF16 * (x + self.cout * self.k * self.k * self.cin
                         + batch * ho * wo * self.cout) + 2 * F32 * self.cout
        return Work(ops_bf16=ops, bytes=nbytes)


def resnet_convs(h: int, w: int, stages: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512), stem_cin: int = 1) -> List[Conv]:
    """Every conv of a basic-block ResNet in order: the 7x7/2 stem, then
    each block's 3x3 convs and its 1x1 downsample."""
    convs = [Conv("stem", stem_cin, widths[0], 7, 2, h, w)]
    h, w = -(-h // 4), -(-w // 4)  # stem stride 2, max-pool stride 2
    cin = widths[0]
    for s, (n, f) in enumerate(zip(stages, widths), start=1):
        for b in range(n):
            stride = 2 if (s > 1 and b == 0) else 1
            convs.append(Conv(f"layer{s}.{b}.conv1", cin, f, 3, stride, h, w))
            ho, wo = -(-h // stride), -(-w // stride)
            convs.append(Conv(f"layer{s}.{b}.conv2", f, f, 3, 1, ho, wo))
            if stride != 1 or cin != f:
                convs.append(Conv(f"layer{s}.{b}.downsample", cin, f, 1, stride, h, w))
            h, w, cin = ho, wo, f
    return convs


def kernel_convs(h: int, w: int) -> List[Conv]:
    """The 3x3 convs and 1x1 downsamples (the stem left out)."""
    return [c for c in resnet_convs(h, w) if c.name != "stem"]


def _elementwise(batch: int, h: int, w: int, stages, widths) -> Work:
    """Max-pool (read the stem's output, write a quarter), each block's
    residual add (read the identity once more), the global average pool
    (read the last map)."""
    sh, sw = -(-h // 2), -(-w // 2)
    ph, pw = -(-sh // 2), -(-sw // 2)
    nbytes = BF16 * batch * widths[0] * (sh * sw + ph * pw)
    ops = 9.0 * batch * widths[0] * ph * pw
    hh, ww = ph, pw
    for s, (n, f) in enumerate(zip(stages, widths), start=1):
        if s > 1:
            hh, ww = -(-hh // 2), -(-ww // 2)
        nbytes += BF16 * n * batch * f * hh * ww
        ops += 2.0 * n * batch * f * hh * ww
    nbytes += BF16 * batch * widths[-1] * hh * ww
    ops += batch * widths[-1] * hh * ww
    return Work(ops_f32=ops, bytes=nbytes)


def backbone_work(batch: int, h: int, w: int, stages=(2, 2, 2, 2),
                  widths=(64, 128, 256, 512), stem_cin: int = 1) -> Work:
    """One backbone's forward over ``batch`` inputs of h×w."""
    total = Work()
    for c in resnet_convs(h, w, stages, widths, stem_cin):
        total = total + c.work(batch)
    return total + _elementwise(batch, h, w, stages, widths)


def heads_work(batch: int, n_heads: int, features: int = 512,
               hidden: Sequence[int] = (512, 256), outputs: int = 2) -> Work:
    """N heads' Linear layers (eval BN folded in) on pooled features."""
    dims = [features, *hidden, outputs]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return Work(ops_bf16=2.0 * batch * n_heads * macs,
                bytes=BF16 * n_heads * (batch * features + weights + batch * outputs))
