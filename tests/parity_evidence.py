"""The float64 evidence behind two of the parity bounds of
tests/parity_bounds.py: how far each package's float32 result lies from
the float64 evaluation of the function both compute, beside the bound.

- the bf16-DFT log-mel (tests/test_torch_melspec.py): the port's plain
  version and the reference's Pallas kernel (interpret mode) on the tone,
  the chirp and the white noise, on the dB plane and on z-scores;
- one train step (tests/test_torch_train_step.py), with the head in the
  loss and under the reference's quirk loss: the Adam moments of each
  package against the JAX package's step in float64;
- the bf16 fast backbone (tests/test_torch_conv.py): the three statistics
  of _assert_backbone_matches, each over its limit, for the port against
  JAX, for JAX's two conv routes against each other, and for the port
  with its BatchNorm folded into the bf16 weights (the fault the check
  was written for).

    python tests/parity_evidence.py        (on the CPU, about two minutes)
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import parity_bounds as PB  # noqa: E402


def log_mel():
    import jax.numpy as jnp

    import test_torch_melspec as M
    from synthetic_audio_detection_tpu.ops.pallas_melspec import fused_log_mel_factored

    print("log-mel, bf16 DFT operands: max |float32 − float64 truth|, and its worst ratio "
          "to the bound")
    for signal in M.SIGNALS:
        x = M._signal(signal)
        truth = PB.log_mel_truth(x, M.CFG)
        near = M._signal_cells(truth)
        sides = {"port": M._plain_bf16(x),
                 "reference": tuple(np.asarray(fused_log_mel_factored(
                     jnp.asarray(x), M.CFG, interpret=True, standardize=std))
                     for std in (False, True))}
        for name, (db, z) in sides.items():
            want, bound = truth.standardized(db)
            print(f"  {signal:5s} {name:9s} dB {np.abs(db - truth.db).max():.3e} "
                  f"({(np.abs(db - truth.db) / truth.db_bound).max():.3f} of the bound)  "
                  f"z {np.abs(z - truth.z).max():.3e} "
                  f"({(np.abs(z - want) / bound).max():.3f} of the bound); within "
                  f"{M.SIGNAL_DEPTH_DB:g} dB of the peak: "
                  f"dB {np.abs(db - truth.db)[near].max():.3e}, "
                  f"z {np.abs(z - truth.z)[near].max():.3e}")
        depth = truth.db.max(axis=(1, 2), keepdims=True) - truth.db
        bound = truth.standardized(sides["port"][0])[1]
        print(f"  {signal:5s} z bound: within 10 dB of the peak ≤ {bound[depth <= 10].max():.2e}, "
              f"within 54 dB ≤ {bound[depth <= 54].max():.2e}, anywhere ≤ {bound.max():.2e}")


def train_step():
    import flax.linen as fnn
    import jax
    import pytest

    import test_torch_train_step as M

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", M._NoDropout)
    torch.set_num_threads(2)
    side, f64_step = M.make_jax_side(), M.make_f64_step()
    js = side["state"]
    print("train step, Adam moments: max |float32 − float64 step| over the tensor's largest "
          "truth, port / JAX, and the port's ratio to the bound (parity_bounds."
          "assert_moments_within)")
    for quirk in (False, True):
        new_js, _ = side["quirk" if quirk else "step"](js, M._batch(), jax.random.PRNGKey(2))
        port = M._port_state(js)
        M._port_step(quirk)(port, M._torch_batch(M._batch()), torch.Generator().manual_seed(0))
        _, mu, nu = M._moments(new_js)
        _, tmu, tnu = M._moments(f64_step(js, M._batch(), quirk))
        rows = PB.assert_moments_within(port.moments(), (mu, nu), (tmu, tnu))
        case = "quirk" if quirk else "head "
        for kind in ("mu", "nu"):
            mine = [r for r in rows if r["moment"] == kind]
            r = max(mine, key=lambda r: r["ratio"])
            print(f"  {case} {kind}: {r['name']} port {r['port']:.2e} JAX {r['reference']:.2e}; "
                  f"{r['ratio']:.3f} of the bound (spread {r['spread']:.2f})")
            signal = [r for r in mine if r["top"] > 1e-3]
            print(f"  {case} {kind}: over the {len(signal)} tensors above 1e-3 of the model's "
                  f"largest, port ≤ {max(r['port'] for r in signal):.2e}, "
                  f"JAX ≤ {max(r['reference'] for r in signal):.2e}")
            if not quirk:
                r = next(r for r in mine if r["name"] == "head.2.weight")
                print(f"  head  {kind}: head.2.weight port {r['port']:.2e} "
                      f"JAX {r['reference']:.2e}")
    # the clip's global norm of the quirk step's gradients, as the port took
    # it before (torch's float32 2-norm) and takes it now (float64 sums)
    seen = []
    clip = M.TS.clip_by_global_norm_
    mp.setattr(M.TS, "clip_by_global_norm_",
               lambda g, *a, **kw: (seen.append([t.clone() for t in g]), clip(g, *a, **kw))[1])
    M._port_step(True)(M._port_state(js), M._torch_batch(M._batch()), None)
    exact = np.sqrt(sum(float((t.double() ** 2).sum()) for t in seen[0]))
    for name, norms in (("float32", torch._foreach_norm(seen[0])),
                        ("float64", M.TS.tensor_norms(seen[0]))):
        got = float(torch.linalg.vector_norm(torch.stack(norms)))
        print(f"  clip norm of the quirk step's {len(seen[0])} gradients, {name} sums: "
              f"{abs(got / exact - 1):.2e} relative off the exact")
    mp.undo()


def conv_backbone():
    import jax.numpy as jnp

    import test_torch_conv as M
    from synthetic_audio_detection_tpu_torch.models import fast_resnet as FR

    def stats(got, ref):  # _assert_backbone_matches' three, each over its limit
        d = np.abs(got - ref)
        return (d.mean() / np.abs(ref).mean() / 2e-3,
                (1 - (d <= 2.0 ** -5 * np.abs(ref) + 1e-3).mean()) / 2e-3,
                (1 - np.corrcoef(got.ravel(), ref.ravel())[0, 1]) / 1e-5)

    def folded(conv, bn, dtype, relu, sum_input_channels=False):
        alpha, beta = FR.bn_affine(bn)
        w = (conv.weight * alpha.view(-1, 1, 1, 1)).to(dtype).float()
        w = w.sum(dim=1, keepdim=True) if sum_input_channels else w
        return FR.PlainConv(w.contiguous(memory_format=torch.channels_last),
                            torch.ones_like(alpha).float(), beta.float(), conv.stride[0],
                            conv.padding[0], relu, dtype)

    print("bf16 fast backbone: mean |d|, share outside 2^-5·|ref| + 1e-3, 1 − corr, each "
          "over the test's limit")
    plain = FR.plain_conv_bn
    for seed in M.SEEDS:
        variables = M._seeded_jax_variables(seed)
        base = (variables["params"]["base"], variables["batch_stats"]["base"])
        net = M._port_backbone(variables)
        for side in M.SIDES:
            x = (np.random.default_rng(11 + seed).standard_normal((2, side, side, 3)) * 0.4
                 ).astype(np.float32)
            refs = [np.asarray(M.JF.fast_backbone_apply(*base, jnp.asarray(x), gemm_max_channels=g,
                                                        dtype=jnp.bfloat16)).astype(np.float64)
                    for g in (0, 512)]
            xt = torch.from_numpy(x).permute(0, 3, 1, 2)
            port = FR.FastResNet(net, torch.bfloat16, conv3x3_max_channels=512)(xt)
            FR.plain_conv_bn = folded
            try:
                fault = FR.FastResNet(net, torch.bfloat16, conv3x3_max_channels=0)(xt)
            finally:
                FR.plain_conv_bn = plain
            rows = {"port / JAX": port, "folded BN / JAX": fault}
            rows = {k: v.float().permute(0, 2, 3, 1).numpy().astype(np.float64)
                    for k, v in rows.items()}
            rows["JAX GEMM / JAX conv"] = refs[1]
            print(f"  seed {seed} {side}²: " + "; ".join(
                f"{k} " + " ".join(f"{r:.3f}" for r in stats(v, refs[0])) for k, v in rows.items()))


if __name__ == "__main__":
    log_mel()
    train_step()
    conv_backbone()
