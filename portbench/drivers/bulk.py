"""Bulk scanning of long recordings: one closed-loop client sends clip
after clip to ``InferencePipeline.analyze_windows``, as the CLI and the
study tools do for a folder of recordings.

The clips are views into a pool of seeded windows (traffic
``pool_windows``), ``clip_lengths`` of them spread evenly over
[``min_windows``, ``max_windows``] and the same for every seed; set-up
slices each with the port's ``slice_waveform``. The seed draws the audio,
each clip's start in the pool and the order, a fresh permutation of the
clips each cycle. Set-up warms the one bucket the clips use (the batch
size). The window runs whole clips until ``seconds`` have passed; a rate
is taken over every clip completed and the time until the last one
completed.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import generate, serving, trace
from portbench.reference import serve as ref_serve


class Driver:
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, tracer, fault=None):
        self.cfg, self.traffic, self.seed, self.device, self.tracer = cfg, traffic, seed, device, tracer
        self.fault = fault

    def setup(self) -> None:
        from synthetic_audio_detection_tpu_torch.infer.pipeline import slice_waveform

        a, t = self.cfg["audio"], self.traffic
        self.T = int(a["window_seconds"] * a["sample_rate"])
        self.pool = generate.window_pool(t["pool_windows"], self.T, a["sample_rate"], self.seed,
                                         self.device)
        self.lengths = generate.even_lengths(t["min_windows"], t["max_windows"], t["clip_lengths"])
        self.starts = generate.clip_offsets(self.lengths, self.pool.shape[0], self.seed)
        self.pipe = serving.build_pipeline(self.cfg, self.seed, self.device)
        self.clips = [slice_waveform(self.pool[s:s + n].reshape(-1), self.pipe.audio)
                      for s, n in zip(self.starts, self.lengths)]
        trace.reset_peak(self.device)
        self.probe = serving.Probe(self.pipe, self.tracer, self.fault)
        warm = self.clips[int(np.argmax(self.lengths))][0][:self.cfg["serve"]["batch_size"]]
        for _ in range(2):
            self.pipe.logits_for_windows(warm)
        trace.sync(self.device)
        self.failed = 0

    def window(self, seconds: float) -> Dict:
        order = generate.cycle_order(len(self.clips), self.seed)
        self.probe.reset()
        self.done, failed = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = next(order)
            windows, stamps = self.clips[k]
            self.probe.request = len(self.done) + failed
            try:
                result = self.pipe.analyze_windows(windows, stamps)
            except Exception as e:  # noqa: BLE001 - an answer that never comes is counted
                print(f"clip {k}: {type(e).__name__}: {e}", flush=True)
                failed += 1
                continue
            self.done.append((k, self.probe.request, result))
        window_s = time.perf_counter() - t0
        self.failed += failed
        useful = sum(len(self.clips[k][1]) for k, _, _ in self.done)
        return {"window_s": window_s, "attempted": len(self.done) + failed, "failed": failed,
                "useful_windows": useful, "requests": len(self.done)}

    def context(self) -> Dict:
        return {"rows": list(self.probe.rows), "forwards": len(self.probe.rows)}

    def release(self) -> None:
        self.served = {rid: np.asarray(self.probe.served[rid]) for _, rid, _ in self.done}
        self.probe.remove()
        del self.pipe, self.probe
        trace.sync(self.device)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: Dict, control=None) -> Dict:
        """Sample ``check_windows`` windows of the completed clips; the reference slices
        their clips again from the pool, checks every sampled clip's
        segment times and computes the sampled windows' logits."""
        index = [(j, i) for j, (k, _, _) in enumerate(self.done) for i in range(len(self.clips[k][1]))]
        pick = [index[p] for p in serving.sample(len(index), self.traffic["check_windows"], self.seed)]
        served, labels, windows, stamp_errors, seen, checked = [], [], [], 0, {}, set()
        for j, i in pick:
            k, rid, result = self.done[j]
            if k not in seen:
                s, L = self.starts[k], self.lengths[k]
                seen[k] = ref_serve.windows_of(self.pool[s:s + L].reshape(-1), self.cfg["audio"])
            if j not in checked:
                checked.add(j)
                got = [(g["start_sec"], g["end_sec"]) for g in result["segments"]]
                stamp_errors += int(got != seen[k][1])
            served.append(self.served[rid][i])
            labels.append(result["segments"][i]["label"])
            windows.append(seen[k][0][i])
        return serving.reference_check(self.cfg, self.seed, self.device, np.stack(served), labels,
                                       np.stack(windows), stamp_errors, self.failed, limits, control)
