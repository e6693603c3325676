"""Training one member of the dense ensemble: the submodel trainer's
phase-2 step (layer3 unfrozen, the gradient stopped at stage 3, bf16
autocast, the log-mel kernel's dB mode, SpecAugment and the random
resized crop on, int16 transport), closed loop, one step after another.

The rows are a seeded pool of ``pool_rows`` int16 4-s windows held in
memory as ``pool_rows / 2`` two-segment files with balanced labels.
The port's own ``WaveformBatcher`` shuffles and batches them (its file
loading replaced by a lookup in the pool, so nothing is read from disk)
and the trainer's ``device_batches`` hands them to the card (pinned
memory, int16). Set-up builds the step, its model and optimizer state
once, and drives ``setup_steps`` steps through the same call and feed; the
window continues with that object. The reference follows those first
steps.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import correct, generate, serving, trace
from portbench.reference import train as ref_train
from portbench.reference import weights as ref_weights

STEP_DRAWS = 4
FAULTS = ("half", "unchanged")


def broken(step, fault: str):
    """A step with a planted fault, for the check's own test: ``half``
    steps on the first half of the rows (the mean over them), ``unchanged``
    runs the step and puts the parameters, moments and count back."""
    def run(state, batch, generator):
        if fault == "half":
            h = batch["audio"].shape[0] // 2
            return step(state, {k: v[:h] for k, v in batch.items()}, generator)
        kept = state.params + state.mu + state.nu
        saved, count = [t.detach().clone() for t in kept], state.count.clone()
        m = step(state, batch, generator)
        with torch.no_grad():
            for t, old in zip(kept, saved):
                t.copy_(old)
        state.count = count
        return m
    return run


def pool_batcher(pool: np.ndarray, labels: np.ndarray, batch_files: int, seed: int):
    """The port's ``WaveformBatcher`` over in-memory files: file f is pool
    rows 2f and 2f + 1. ``log`` records each batch's files in the order
    they were made."""
    from synthetic_audio_detection_tpu_torch.data.dataset import WaveformBatcher

    class PoolBatcher(WaveformBatcher):
        def _make_batch(self, chunk, ex):
            files = [int(path) for path, _ in chunk]
            self.log.append(files)
            rows = np.array([[2 * f, 2 * f + 1] for f in files]).reshape(-1)
            return {"audio": pool[rows], "label": np.repeat([lab for _, lab in chunk], 2).astype(np.int32)}

    b = PoolBatcher([(str(f), int(labels[f])) for f in range(len(labels))], batch_files,
                    shuffle=True, workers=1, seed=seed)
    b.log = []
    return b


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, tracer, fault=None):
        self.cfg, self.traffic, self.seed, self.device, self.tracer = cfg, traffic, seed, device, tracer
        if fault not in (None,) + FAULTS:
            raise ValueError(f"no fault {fault!r} for a training cell; choose from {FAULTS}")
        self.fault = fault

    def _port(self):
        from synthetic_audio_detection_tpu_torch.models.classifier import BinaryClassifier
        from synthetic_audio_detection_tpu_torch.train import steps
        from synthetic_audio_detection_tpu_torch.utils.config import SpecAugmentConfig, TrainConfig

        m, tr = self.cfg["model"], self.cfg["train"]
        _, spec, _ = serving.port_configs(self.cfg)
        spec = type(spec)(**{**spec.__dict__, "mel_norm": tr["mel_norm"]})
        w = ref_weights.draw(m, self.seed, self.device)
        member = tr["member"]
        with torch.device(self.device):
            model = BinaryClassifier(m["arch"], m["in_channels"], m["outputs"])
        serving.load_strict(model.base, w["backbones"][member])
        serving.load_strict(model.head, w["heads"][member])
        del w
        if torch.device(self.device).type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        tcfg = TrainConfig(batch_size=tr["batch_files"], lr=tr["lr"], weight_decay=tr["weight_decay"],
                           grad_clip_norm=tr["grad_clip_norm"], compute_dtype=tr["compute_dtype"],
                           mel_dft=tr["mel_dft"], transport_dtype=tr["transport_dtype"])
        augment = SpecAugmentConfig(freq_mask_param=tr["freq_mask_param"],
                                    time_mask_param=tr["time_mask_param"])
        state = steps.create_train_state(model, tcfg)
        steps.unfreeze_layer3(state)
        step = steps.make_train_step(tcfg, spec, augment, self.cfg["audio"]["sample_rate"],
                                     stop_grad_stage=tr["stop_grad_stage"], dft_mode=tr["mel_dft"],
                                     compute_dtype=getattr(torch, tr["compute_dtype"]))
        return state, step

    def _feed(self):
        from synthetic_audio_detection_tpu_torch.train.trainer import device_batches

        epoch = 0
        while True:
            self._epoch = device_batches(self.batcher, epoch, self.cfg["train"]["rows"],
                                         self.cfg["train"]["transport_dtype"], torch.device(self.device))
            yield from self._epoch
            epoch += 1

    def setup(self) -> None:
        a, t, tr = self.cfg["audio"], self.traffic, self.cfg["train"]
        if tr["rows"] != 2 * tr["batch_files"]:
            raise ValueError("a step's rows are its files' two segments")
        T = int(a["window_seconds"] * a["sample_rate"])
        self.pool = generate.pcm16(generate.window_pool(t["pool_rows"], T, a["sample_rate"],
                                                        self.seed, self.device))
        self.labels = np.arange(t["pool_rows"] // 2) % 2
        self.batcher = pool_batcher(self.pool, self.labels, tr["batch_files"], self.seed)
        trace.reset_peak(self.device)
        self.state, self.step = self._port()
        if self.fault is not None:
            self.step = broken(self.step, self.fault)
        self.generator = torch.Generator(self.device).manual_seed(
            ref_weights.substream(self.seed, STEP_DRAWS))
        self.batches = self._feed()
        losses = []
        for i in range(t["setup_steps"]):
            m = self.step(self.state, next(self.batches), self.generator)
            losses.append(m["loss"])
            if i == 0:
                self.mu1 = {n: mu.detach().to("cpu", copy=True) for n, mu, k in
                            zip(self.state.names, self.state.mu, self.state.mask) if k}
        self.p3 = {n: p.detach().to("cpu", torch.float32, copy=True) for n, p, k in
                   zip(self.state.names, self.state.params, self.state.mask) if k}
        self.losses = [float(x) for x in losses]
        trace.sync(self.device)

    def window(self, seconds: float) -> Dict:
        rows = self.cfg["train"]["rows"]
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with self.tracer.span("step"):
                self.step(self.state, next(self.batches), self.generator)
            n += 1
        trace.sync(self.device)
        self.steps = n
        return {"window_s": time.perf_counter() - t0, "attempted": n, "failed": 0,
                "steps": n, "rows": n * rows}

    def context(self) -> Dict:
        return {"steps": self.steps}

    def release(self) -> None:
        for _ in self._epoch:  # let the batcher's producer thread finish its epoch
            pass
        del self.state, self.step, self.batches, self._epoch
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: Dict, control=None) -> Dict:
        """The reference follows the set-up steps from the seed's weights,
        on the same pool rows (the batcher's log) and the same draws."""
        tr, m = self.cfg["train"], self.cfg["model"]
        w = ref_weights.draw(m, self.seed, self.device)
        base, head = w["backbones"][tr["member"]], w["heads"][tr["member"]]
        p0 = ref_train.leaves(base, head)
        batches = []
        for files in self.batcher.log[:self.traffic["setup_steps"]]:
            rows = np.array([[2 * f, 2 * f + 1] for f in files]).reshape(-1)
            batches.append((torch.from_numpy(self.pool[rows]).to(self.device),
                            torch.from_numpy(np.repeat(self.labels[files], 2)).to(self.device)))
        g = torch.Generator(self.device).manual_seed(ref_weights.substream(self.seed, STEP_DRAWS))
        ref = ref_train.steps(self.cfg, base, head, batches, g)
        names = list(ref["params"])
        ref_change = [float((ref["params"][k] - p0[k]).norm()) for k in names]
        ref_grad = [ref["grad_norms"][k] for k in names]
        if control is None:
            port_losses = self.losses
            port_grads = {k: self.mu1[k].to(self.device) / (1 - ref_train.B1) for k in names}
            port_change = [float((self.p3[k].to(self.device) - p0[k]).norm()) for k in names]
        else:
            g = torch.Generator(self.device).manual_seed(ref_weights.substream(self.seed, STEP_DRAWS))
            low = ref_train.steps(self.cfg, base, head, batches, g, q=control)
            port_losses, port_grads = low["losses"], low["grads"]
            port_change = [float((low["params"][k] - p0[k]).norm()) for k in names]
        port_grad = [float(port_grads[k].norm()) for k in names]
        grad_diff = [float((port_grads[k] - ref["grads"][k]).norm()) for k in names]
        return correct.training(port_losses, ref["losses"], port_grad, ref_grad, port_change,
                                ref_change, limits, names, grad_diff)
