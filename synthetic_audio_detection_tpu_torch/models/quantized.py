"""Int8 post-training quantization of the ResNet backbone, the serving fast
path (the reference package's ``models/quantized.py``), on the GPU.

The reference's scheme, kept:

- weights: per-output-channel symmetric int8, s = max|w| / 127 per
  channel (at least 1e-12), codes round(w / s) clipped to ±127, with the
  eval-mode BatchNorm folded in float64 into a per-channel affine
  (alpha, beta) applied to the int32 accumulator: ``out_scale`` = s·alpha,
  ``bias`` = beta;
- activations: dynamic per-tensor symmetric int8, s_x = max(max|x|,
  1e-12) / 127 over the whole batch tensor, so a result depends on the
  batch it was computed in (compare only at the same batch);
- each conv: an int32 accumulator, then acc·(s_x·out_scale) + bias in
  float32, ReLU where the reference applies it; the float32 residual
  relu(out + identity); the stem's max-pool with −inf padding;
- the heads in float, in the ensemble's dtype, then ``_aggregate``.

The reference computes each int8 conv with ``lax.conv_general_dilated``
outside any Pallas kernel; here a conv is a zero-padded int8 im2col of the
NHWC activation (``Tensor.unfold``, K ordered (kh, kw, ci)) and one
``torch._int_mm``: cuBLASLt's int8 tensor cores on the card; on the CPU a
float64 product, exact int32 on any instruction set. ``_int_mm`` on CUDA
takes K and N multiples of 8 and M > 16: K is padded with zero columns and
zero weight rows (the stem's 7·7·3 = 147 to 152), M with zero rows to 32
when it is 16 or less. A shape it still
refuses raises; nothing falls back to a float conv.

The int8 codes are the reference's exactly (they are computed in numpy
from the same float32 weights, in the port's OIHW layout: the reference's
HWIO transposed).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from synthetic_audio_detection_tpu_torch.models.resnet import BN_EPS, RESNET_SPECS, ResNet

# _int_mm's shape rules on CUDA
K_MULTIPLE = 8
MIN_ROWS = 17
PAD_ROWS = 32


class IntMatmul:
    """``torch._int_mm``, counted: ``launches`` adds one per product (one
    per int8 conv)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        self.launches += 1
        if a.device.type == "cpu":
            # oneDNN's int8 product on a CPU without VNNI sums u8·s8 pairs
            # into saturating int16 and is not exact; a float64 product is
            # (|Σ| ≤ K·127·128 < 2^53), on any CPU
            return torch.matmul(a.double(), b.double()).to(torch.int32)
        return torch._int_mm(a, b)


INT_MM = IntMatmul()


# ---------------------------------------------------------------------------
# Quantization (host side, once per checkpoint)
# ---------------------------------------------------------------------------

def _fold_bn(bn: nn.BatchNorm2d) -> Tuple[np.ndarray, np.ndarray]:
    """BN(scale, bias, mean, var) → per-channel (alpha, beta): y = alpha·x +
    beta, in float64, returned in float32."""
    as64 = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    alpha = as64(bn.weight) / np.sqrt(as64(bn.running_var) + BN_EPS)
    beta = as64(bn.bias) - as64(bn.running_mean) * alpha
    return alpha.astype(np.float32), beta.astype(np.float32)


def _quant_weight(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[co, ci, kh, kw] float → (int8 kernel, per-co scale)."""
    k = np.asarray(kernel, np.float32)
    s = np.max(np.abs(k), axis=(1, 2, 3)) / 127.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.round(k / s[:, None, None, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _quant_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, device: torch.device) -> Dict:
    """{'kernel_q' [co, ci, kh, kw] int8, 'out_scale' [co], 'bias' [co]
    float32, 'w_mat' [K padded, co] int8: the GEMM operand, K ordered (kh,
    kw, ci) as the im2col's columns, zero rows to a multiple of 8}."""
    q, s_w = _quant_weight(conv.weight.detach().cpu().float().numpy())
    alpha, beta = _fold_bn(bn)
    co = q.shape[0]
    w_mat = q.transpose(2, 3, 1, 0).reshape(-1, co)
    k_pad = -(-w_mat.shape[0] // K_MULTIPLE) * K_MULTIPLE
    w_mat = np.concatenate([w_mat, np.zeros((k_pad - w_mat.shape[0], co), np.int8)])
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {"kernel_q": as_t(q), "out_scale": as_t((s_w * alpha).astype(np.float32)),
            "bias": as_t(beta), "w_mat": as_t(w_mat)}


def quantize_backbone(net: ResNet, device: Any = "cuda") -> Dict:
    """The port's float ResNet (stem to layer4, eval statistics) → the
    quantized parameter tree {'stem', 'layers': [{'convs': [...],
    'downsample'?}, ...]} on ``device`` (the GPU unless the caller asks for
    the CPU)."""
    device = _resolve(device)
    if net.first_stage != 1 or net.last_stage != len(net.stage_sizes):
        raise ValueError("quantize_backbone takes a whole backbone, not a stage slice")
    n_convs = 2 if net.block == "basic" else 3
    out: Dict[str, Any] = {"stem": _quant_conv_bn(net.conv1, net.bn1, device), "layers": []}
    for stage in range(1, len(net.stage_sizes) + 1):
        for blk in getattr(net, f"layer{stage}"):
            entry = {"convs": [_quant_conv_bn(getattr(blk, f"conv{i + 1}"),
                                              getattr(blk, f"bn{i + 1}"), device)
                               for i in range(n_convs)]}
            if blk.downsample is not None:
                entry["downsample"] = _quant_conv_bn(blk.downsample[0], blk.downsample[1],
                                                     device)
            out["layers"].append(entry)
    return out


def _resolve(device: Any) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for the CPU")
    return device


# ---------------------------------------------------------------------------
# Quantized forward
# ---------------------------------------------------------------------------

def _quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8 (true divisions by 0-d tensors,
    as the reference's, on every device)."""
    s = torch.clamp(x.abs().amax(), min=1e-12) / torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def qconv_accumulators(x: torch.Tensor, qc: Dict, stride: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, H, W, C] float32 → (the int32 accumulator [B, Ho, Wo, co] of
    the int8 conv with 'same' zero padding, the activation scale s_x)."""
    xq, s_x = _quant_act(x)
    kh = qc["kernel_q"].shape[2]
    pad = (kh - 1) // 2
    b, _, _, c = xq.shape
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    patches = xp.unfold(1, kh, stride).unfold(2, kh, stride)  # [B, Ho, Wo, C, kh, kw]
    ho, wo = patches.shape[1], patches.shape[2]
    a = patches.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, kh * kh * c)
    w = qc["w_mat"]
    m = a.shape[0]
    a = F.pad(a, (0, w.shape[0] - a.shape[1], 0, PAD_ROWS - m if m < MIN_ROWS else 0))
    acc = INT_MM(a.contiguous(), w)[:m]
    return acc.view(b, ho, wo, -1), s_x


def _qconv(x: torch.Tensor, qc: Dict, stride: int, relu: bool) -> torch.Tensor:
    """int8 conv + folded BN affine (+ ReLU) → float32 NHWC."""
    acc, s_x = qconv_accumulators(x, qc, stride)
    y = acc.float() * (s_x * qc["out_scale"]) + qc["bias"]
    return torch.relu(y) if relu else y


@torch.no_grad()
def quantized_backbone_apply(qtree: Dict, x: torch.Tensor,
                             backbone: str = "resnet18") -> torch.Tensor:
    """x [B, C, H, W] (the port's layout) → un-pooled features
    [B, H/32, W/32, F] float32 (NHWC), int8 convs throughout."""
    block, stages = RESNET_SPECS[backbone]
    y = _qconv(x.float().permute(0, 2, 3, 1), qtree["stem"], 2, relu=True)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    li = 0
    for stage_idx, n_blocks in enumerate(stages):
        stride = 1 if stage_idx == 0 else 2
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            entry = qtree["layers"][li]
            li += 1
            identity = y
            if block == "basic":
                out = _qconv(y, entry["convs"][0], s, relu=True)
                out = _qconv(out, entry["convs"][1], 1, relu=False)
            else:
                out = _qconv(y, entry["convs"][0], 1, relu=True)
                out = _qconv(out, entry["convs"][1], s, relu=True)
                out = _qconv(out, entry["convs"][2], 1, relu=False)
            if "downsample" in entry:
                identity = _qconv(y, entry["downsample"], s, relu=False)
            y = torch.relu(out + identity)
    return y


# ---------------------------------------------------------------------------
# Quantized ensemble
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedEnsemble:
    """Shared-backbone ensemble with an int8 backbone and float heads,
    built from a ``MultiHeadEnsemble`` whose backbone is shared (the
    reference-merged layout, the dominant serving configuration)."""

    qbackbone: Dict
    head_layers: List[tuple]        # ensemble.multihead.stack_heads, in head_dtype
    class_names: List[str]
    backbone: str = "resnet18"
    head_dtype: torch.dtype = torch.float32
    generic_head: bool = False

    @property
    def num_heads(self) -> int:
        return len(self.class_names) - 1 + int(self.generic_head)


def quantize_ensemble(ens, device: Any = "cuda") -> QuantizedEnsemble:
    """A shared-backbone ``MultiHeadEnsemble`` → its int8 ensemble on
    ``device``. Raises ValueError for a dense or trunk-shared ensemble (the
    reference: quantize per head)."""
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import stack_heads

    if not ens.shared_backbone:
        raise ValueError(
            "quantize_ensemble requires a shared-backbone ensemble "
            "(reference-merged layout); dense ensembles: quantize per head")
    device = _resolve(device)
    heads = [(w.to(device), b.to(device), relu) for w, b, relu in stack_heads(ens.heads, ens.dtype)]
    return QuantizedEnsemble(quantize_backbone(ens.backbones[0], device), heads,
                             list(ens.class_names), backbone=ens.backbone_name,
                             head_dtype=ens.dtype, generic_head=ens.generic_head)


@torch.no_grad()
def quantized_ensemble_forward(qens: QuantizedEnsemble, x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] → [B, N+1] ensemble logits (int8 backbone, the
    stacked float heads)."""
    from synthetic_audio_detection_tpu_torch.ensemble.multihead import _aggregate, heads_forward

    feats = quantized_backbone_apply(qens.qbackbone, x, qens.backbone)
    pooled = feats.mean(dim=(1, 2)).to(qens.head_dtype)
    return _aggregate(heads_forward(qens.head_layers, pooled.expand(qens.num_heads, -1, -1)))
