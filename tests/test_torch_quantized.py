"""The port's int8 PTQ backbone (``models/quantized.py``) against the JAX
package's (``models/quantized.py``) on the CPU, on the same float weights
(the JAX package's init, carried by checkpoints/from_jax.py) and the same
input: the quantized tree (codes exact, scales and biases to float32
rounding), the stem's int32 accumulators (exact), the ensemble's logits
(argmax equal; within TOL_LOGITS), and tests/test_quantized.py's contract
against the port's own float path.

TOL_LOGITS: both packages compute every conv exactly in int32 from the
same codes and the same activation scale; they differ only in the float32
rounding of the folded affine, the pooling and the heads (the port folds
each head's BatchNorm into its Linear), and in the rare activation code
such a rounding moves across a .5 boundary. 1e-4 absolute + 1e-4 relative
(measured: 6e-7 on these inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_audio_detection_tpu.ensemble.multihead import build_ensemble as jax_build
from synthetic_audio_detection_tpu.models import quantized as JQ
from synthetic_audio_detection_tpu.models.classifier import BinaryClassifier, init_classifier
from synthetic_audio_detection_tpu_torch.checkpoints.from_jax import ensemble_from_variables
from synthetic_audio_detection_tpu_torch.ensemble.multihead import (
    build_ensemble,
    ensemble_per_head_logits,
    _aggregate,
)
from synthetic_audio_detection_tpu_torch.models import quantized as TQ

NAMES = ["S0", "S1", "S2", "Real"]
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ensembles():
    """A shared-backbone 3-head ensemble in both packages (the JAX
    package's tests/test_quantized.py recipe) and its two quantizations."""
    model = BinaryClassifier(backbone="resnet18")
    base = init_classifier(model, jax.random.PRNGKey(0), input_size=64)
    vds = []
    for i in range(3):
        v = init_classifier(model, jax.random.PRNGKey(10 + i), input_size=64)
        v["params"]["base"] = base["params"]["base"]
        v["batch_stats"]["base"] = base["batch_stats"]["base"]
        vds.append(v)
    jens = jax_build(model, vds, NAMES)
    pens = ensemble_from_variables(jax.tree_util.tree_map(np.asarray, jens.variables), NAMES)
    assert pens.shared_backbone
    return jens, JQ.quantize_ensemble(jens), pens, TQ.quantize_ensemble(pens, device="cpu")


def _inputs(batch=4, seed=0):
    x = np.random.default_rng(seed).standard_normal((batch, 64, 64, 3)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def _convs(tree):
    yield tree["stem"]
    for layer in tree["layers"]:
        yield from layer["convs"]
        if "downsample" in layer:
            yield layer["downsample"]


def test_quantized_tree_matches_jax(ensembles):
    _, jq, _, tq = ensembles
    pairs = list(zip(_convs(jq.qbackbone), _convs(tq.qbackbone)))
    assert len(pairs) == 20  # ResNet-18: the stem, 16 3x3 convs, 3 downsamples
    for j, t in pairs:
        # HWIO → the port's OIHW: the same codes
        np.testing.assert_array_equal(np.asarray(j["kernel_q"]).transpose(3, 2, 0, 1),
                                      t["kernel_q"].numpy())
        for k in ("out_scale", "bias"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=2.0 ** -23, atol=0)
        # the GEMM operand: the codes in (kh, kw, ci) order, zero rows to a multiple of 8
        w = t["w_mat"].numpy()
        k = np.asarray(j["kernel_q"]).reshape(-1, w.shape[1])
        assert w.shape[0] % 8 == 0 and w.shape[0] - k.shape[0] < 8
        np.testing.assert_array_equal(w[:k.shape[0]], k)
        assert not w[k.shape[0]:].any()
    assert tq.qbackbone["stem"]["w_mat"].shape == (152, 64)  # 7·7·3 = 147 padded


def test_stem_accumulators_match_jax_exactly(ensembles):
    _, jq, _, tq = ensembles
    x, xt = _inputs()
    acc, s_x = TQ.qconv_accumulators(xt.permute(0, 2, 3, 1), tq.qbackbone["stem"], 2)
    xq, js_x = JQ._quant_act(jnp.asarray(x))
    want = jax.lax.conv_general_dilated(
        xq, jq.qbackbone["stem"]["kernel_q"], (2, 2), [(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    assert float(s_x) == float(js_x)
    assert acc.dtype == torch.int32 and acc.shape == (4, 32, 32, 64)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch", [4, 1])
def test_quantized_forward_matches_jax(ensembles, batch):
    """Batch 1 puts layer4's product at M = 4 rows, padded to 32 for
    ``_int_mm``."""
    _, jq, _, tq = ensembles
    x, xt = _inputs(batch, seed=batch)
    want = np.asarray(JQ.quantized_ensemble_forward(jq, jnp.asarray(x)))
    TQ.INT_MM.launches = 0
    got = TQ.quantized_ensemble_forward(tq, xt).numpy()
    assert TQ.INT_MM.launches == 20  # one product a conv
    assert got.shape == want.shape == (batch, len(NAMES))
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, **TOL_LOGITS)


def test_quantized_tracks_the_float_path(ensembles):
    """tests/test_quantized.py's contract, against the port's float32
    ensemble: correlation above 0.99, mean relative error under 0.15, the
    same argmax."""
    _, _, pens, tq = ensembles
    _, xt = _inputs()
    ref = _aggregate(ensemble_per_head_logits(pens, xt.contiguous())).numpy()
    got = TQ.quantized_ensemble_forward(tq, xt).numpy()
    assert got.shape == ref.shape
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.99
    assert (np.abs(got - ref) / (np.abs(ref).mean() + 1e-6)).mean() < 0.15
    np.testing.assert_array_equal(ref.argmax(1), got.argmax(1))


def test_quantize_rejects_dense_and_trunk_shared():
    torch.manual_seed(0)
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier as TC

    sds = [TC().state_dict() for _ in range(2)]
    with pytest.raises(ValueError, match="shared-backbone"):
        TQ.quantize_ensemble(build_ensemble(sds, ["A", "B", "Real"],
                                            detect_shared_backbone=False), device="cpu")
    trunk = [{k: (sds[0][k] if k.startswith("base.") and not k.startswith("base.layer4")
                  else v) for k, v in sd.items()} for sd in sds]
    ens = build_ensemble(trunk, ["A", "B", "Real"])
    assert ens.shared_trunk_stages == 1
    with pytest.raises(ValueError, match="shared-backbone"):
        TQ.quantize_ensemble(ens, device="cpu")


def test_quantize_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    torch.manual_seed(0)
    from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier as TC

    sd = TC().state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.quantize_ensemble(build_ensemble([sd, sd], ["A", "B", "Real"]))
