"""The port's parity tests under every CPU setting that moves either side's
float32 summation order.

The parity files are the tests/test_torch_*.py files that import the JAX
package. Each is run once under each setting below, in a pytest process of
its own (the settings are read when jax and torch load). Both packages
compute in float32, whose sums depend on their order: XLA's CPU backend
picks its vector width from the instruction set, oneDNN picks its kernels
from it, ATen picks the vector width of its own reductions (sum, mean,
norm) from it, and torch's intra-op threads split a reduction into
partial sums.
A check that passes under one setting and fails under another holds the
port to one CPU's rounding, not to the reference's function.

    python tests/parity_sweep.py                    # all seven settings, 4 workers
    python tests/parity_sweep.py -s default -s omp1 -n 2 -f test_torch_melspec.py
    python tests/parity_sweep.py --out sweep.json   # keep the ratios

Besides pass and fail, the sweep reports each tolerance assertion's worst
ratio of difference to tolerance (1.0 is the edge): np.testing.assert_allclose,
torch.testing.assert_close, pytest.approx and parity_bounds.assert_within
are wrapped while the tests run (this file is also the pytest plugin that
does it). Assertions written as a bare `assert ... <= ...` are not read.
With --out it also keeps, for the float64-derived checks, each checked
value's and each reference's largest distance from its float64 truth,
relative to the truth's largest magnitude.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

SETTINGS = {
    "default": {},
    "xla-avx2": {"XLA_FLAGS": "--xla_cpu_max_isa=AVX2"},
    "xla-sse4_2": {"XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2"},
    "onednn-avx2": {"ONEDNN_MAX_CPU_ISA": "AVX2"},
    "aten-avx2": {"ATEN_CPU_CAPABILITY": "avx2"},
    "aten-default": {"ATEN_CPU_CAPABILITY": "default"},
    "omp1": {"OMP_NUM_THREADS": "1"},
}
RECORD_DIR = "PARITY_SWEEP_RECORD_DIR"
_IMPORTS_JAX_PACKAGE = re.compile(r"(from|import) synthetic_audio_detection_tpu(\.|\s)")


def parity_files(root=ROOT):
    out = []
    for path in sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py"))):
        with open(path) as f:
            if _IMPORTS_JAX_PACKAGE.search(f.read()):
                out.append(os.path.relpath(path, root))
    return out


# --- the pytest plugin: record each tolerance assertion's worst ratio ------

_records: dict = {}
_distances: dict = {}  # test|call site → the largest relative distance seen


def _call_site():
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename
        if os.path.basename(name).startswith("test_"):
            return f"{os.path.relpath(name, ROOT)}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


def _record(ratio, check, *args, **kwargs):
    """Run ``check`` and keep its ratio under the test and the call site;
    an assertion that raises inside a test that passes (a mutation that
    a check must reject) is kept apart."""
    test = os.environ.get("PYTEST_CURRENT_TEST", "?").rsplit(" (", 1)[0]
    key = f"{test}|{_call_site()}"
    try:
        out = check(*args, **kwargs)
    except AssertionError:
        key += "|raised"
        raise
    finally:
        if ratio is not None and not math.isnan(ratio):
            _records[key] = max(_records.get(key, 0.0), ratio)
    return out


def _distance(kind, got, want):
    """Keep |got − want| over the largest |want| under the test, the call
    site and ``kind``: 'checked' for a value held to its float64 truth,
    'reference' for the reference's own float32 error that sets a bound."""
    import numpy as np

    test = os.environ.get("PYTEST_CURRENT_TEST", "?").rsplit(" (", 1)[0]
    key = f"{test}|{_call_site()}|{kind}"
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.size:
        d = float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-300))
        _distances[key] = max(_distances.get(key, 0.0), d)


def _ratio(actual, desired, rtol, atol):
    import numpy as np

    a = np.asarray(actual, dtype=np.float64)
    b = np.asarray(desired, dtype=np.float64)
    d = np.abs(a - b)
    tol = np.asarray(atol, np.float64) + rtol * np.abs(b)
    d, tol = np.broadcast_arrays(d, tol)
    both_nan = np.isnan(a) & np.isnan(b) if a.shape == b.shape else np.zeros(d.shape, bool)
    ok = ~both_nan & ~np.isnan(d)
    d, tol = d[ok], tol[ok]
    if d.size == 0:
        return 0.0
    exact = tol == 0
    worst = float((d[~exact] / tol[~exact]).max()) if (~exact).any() else 0.0
    return math.inf if (d[exact] > 0).any() else worst


def _torch_default_tol(t):
    import torch

    return {torch.float16: (1e-3, 1e-5), torch.bfloat16: (1.6e-2, 1e-5),
            torch.float32: (1.3e-6, 1e-5), torch.float64: (1e-7, 1e-7)}.get(t.dtype, (0.0, 0.0))


def _torch_ratio(actual, expected, rtol, atol):
    import torch

    if isinstance(actual, dict):
        return max((_torch_ratio(actual[k], expected[k], rtol, atol) for k in actual), default=0.0)
    if isinstance(actual, (list, tuple)):
        return max((_torch_ratio(a, e, rtol, atol) for a, e in zip(actual, expected)),
                   default=0.0)
    a = torch.as_tensor(actual)
    e = torch.as_tensor(expected)
    r, t = (rtol, atol) if rtol is not None else _torch_default_tol(a)
    return _ratio(a.detach().cpu().double().numpy(), e.detach().cpu().double().numpy(), r, t)


class _RecordingApprox:
    def __init__(self, inner, expected, rel, abs_):
        self._inner, self._expected, self._rel, self._abs = inner, expected, rel, abs_

    def __eq__(self, other):
        if isinstance(self._expected, (int, float)) and isinstance(other, (int, float)):
            rel, abs_ = self._rel, self._abs
            if rel is None and abs_ is None:
                rel, abs_ = 1e-6, 1e-12
            rel = 0.0 if rel is None else rel
            abs_ = 1e-12 if abs_ is None else abs_
            tol = max(rel * abs(self._expected), abs_)
            _record(_ratio(other, self._expected, 0.0, tol), lambda: None)
        return self._inner == other

    def __ne__(self, other):
        return not self == other

    def __repr__(self):
        return repr(self._inner)


def pytest_configure(config):
    import numpy as np
    import pytest
    import torch

    import parity_bounds

    allclose, close, approx = np.testing.assert_allclose, torch.testing.assert_close, pytest.approx
    within, reference_bound = parity_bounds.assert_within, parity_bounds.reference_error_bound

    def safe_ratio(f, *args):
        try:
            return f(*args)
        except (TypeError, ValueError, RuntimeError):
            return None

    def assert_allclose(actual, desired, rtol=1e-7, atol=0, *args, **kwargs):
        return _record(safe_ratio(_ratio, actual, desired, rtol, atol), allclose,
                       actual, desired, rtol, atol, *args, **kwargs)

    def assert_close(actual, expected, *args, rtol=None, atol=None, **kwargs):
        return _record(safe_ratio(_torch_ratio, actual, expected, rtol, atol), close,
                       actual, expected, *args, rtol=rtol, atol=atol, **kwargs)

    def recording_approx(expected, rel=None, abs=None, nan_ok=False):  # noqa: A002
        return _RecordingApprox(approx(expected, rel=rel, abs=abs, nan_ok=nan_ok), expected,
                                rel, abs)

    def assert_within(got, want, bound, *args, **kwargs):
        _distance("checked", got, want)
        return _record(safe_ratio(_ratio, got, want, 0.0, bound), within,
                       got, want, bound, *args, **kwargs)

    def reference_error_bound(ref, truth, *args, **kwargs):
        _distance("reference", ref, truth)
        return reference_bound(ref, truth, *args, **kwargs)

    np.testing.assert_allclose = assert_allclose
    torch.testing.assert_close = assert_close
    pytest.approx = recording_approx
    parity_bounds.assert_within = assert_within
    parity_bounds.reference_error_bound = reference_error_bound


def pytest_unconfigure(config):
    out = os.environ.get(RECORD_DIR)
    name = os.environ.get("PYTEST_XDIST_WORKER", "main")
    for ext, table in (("json", _records), ("dist", _distances)):
        if out and table:
            with open(os.path.join(out, f"{name}-{os.getpid()}.{ext}"), "w") as f:
                json.dump(table, f)


# --- the sweep ----------------------------------------------------------------

def run_setting(name, files, workers, extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **SETTINGS[name])
    env["PYTHONPATH"] = os.pathsep.join([HERE, ROOT] + [p for p in
                                         env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory() as rec, tempfile.TemporaryDirectory() as tmp:
        env[RECORD_DIR] = rec
        xml = os.path.join(tmp, "junit.xml")
        cmd = [sys.executable, "-m", "pytest", *files, "-q", "-m", "not slow",
               "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "parity_sweep",
               f"--junitxml={xml}"]
        if workers > 1:
            cmd += ["-p", "xdist", "-n", str(workers), "--dist", "loadfile"]
        proc = subprocess.run(cmd + list(extra), cwd=ROOT, env=env, capture_output=True,
                              text=True)
        failed = re.findall(r"^(?:FAILED|ERROR) (\S+)", proc.stdout, re.M)
        passed = re.search(r"(\d+) passed", proc.stdout)
        ratios = {}
        for path in glob.glob(os.path.join(rec, "*.json")):
            with open(path) as f:
                for k, v in json.load(f).items():
                    test = k.split("|")[0]
                    if k.endswith("|raised") and test not in failed:
                        continue  # a check that rejected what it must reject
                    ratios[k] = max(ratios.get(k, 0.0), v)
        distances = {}
        for path in glob.glob(os.path.join(rec, "*.dist")):
            with open(path) as f:
                for k, v in json.load(f).items():
                    distances[k] = max(distances.get(k, 0.0), v)
    return {"rc": proc.returncode, "passed": int(passed.group(1)) if passed else 0,
            "failed": failed, "ratios": ratios, "distances": distances,
            "tail": proc.stdout[-2000:]}


def summarize(results):
    """Per file: the settings under which a test failed, and the worst
    ratio of difference to tolerance under any setting."""
    rows = {}
    for name, res in results.items():
        for test in res["failed"]:
            rows.setdefault(test.split("::")[0], [set(), 0.0])[0].add(name)
        for key, ratio in res["ratios"].items():
            row = rows.setdefault(key.split("::")[0], [set(), 0.0])
            row[1] = max(row[1], ratio)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-s", "--setting", action="append", choices=sorted(SETTINGS),
                    help="a setting to run (repeatable; default: all of them)")
    ap.add_argument("-f", "--file", action="append",
                    help="run only this parity file (repeatable; default: all of them)")
    ap.add_argument("-n", "--workers", type=int, default=4)
    ap.add_argument("--out", help="write every setting's results, ratios included, as JSON")
    ap.add_argument("--top", type=int, default=15, help="assertions to list by worst ratio")
    ap.add_argument("pytest_args", nargs="*", help="passed on to pytest (after --)")
    args = ap.parse_args(argv)
    files = parity_files()
    if args.file:
        files = [f for f in files if any(f.endswith(os.path.basename(g)) for g in args.file)]
    results = {}
    for name in args.setting or list(SETTINGS):
        res = results[name] = run_setting(name, files, args.workers, args.pytest_args)
        print(f"{name:12s} rc={res['rc']} passed={res['passed']} failed={len(res['failed'])}",
              flush=True)
        for test in res["failed"]:
            print(f"    FAILED {test}")
    print(f"\n{len(files)} parity files; worst ratio of difference to tolerance, any setting:")
    for path, (bad, worst) in sorted(summarize(results).items()):
        print(f"  {path:45s} {worst:9.3g}  " + (f"failed under {','.join(sorted(bad))}"
                                                if bad else ""))
    worst = {}
    for res in results.values():
        for k, v in res["ratios"].items():
            worst[k] = max(worst.get(k, 0.0), v)
    print("\nassertions nearest their tolerance:")
    for k, v in sorted(worst.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {v:9.3g}  {k}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return int(any(res["rc"] for res in results.values()))


if __name__ == "__main__":
    sys.exit(main())
