"""The study-campaign drivers (``synthetic_audio_detection_tpu_torch/tools/``:
``campaign`` and the seven ports of the repository's ``tools/*.sh``).

Each unchanged shell script runs with ``LC_ALL=C`` and a stub ``python``
first on ``PATH``; each port driver runs with the same stub as its steps'
interpreter (``campaign.INTERPRETER``). The stub logs its argv, writes the
files that later steps read and prints canned JSON, so both sides must give
the same steps in the same order (JAX modules mapped to the port's,
``--device`` dropped), the same files, logs, summary text and exit codes.
Then the time bound of ``campaign.step``, and one tiny chain for real on
the CPU: both modes of ``train_study_ensemble`` and a one-holdout
``generalization_study`` at 64²."""

import json
import os
import re
import shutil
import stat
import subprocess
import sys
import time

import numpy as np
import pytest

from synthetic_audio_detection_tpu_torch.tools import campaign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "synthetic_audio_detection_tpu_torch"
DRIVERS = ("train_study_ensemble", "generalization_study", "logo_calibration_followup",
           "round5_addhead_study", "round4_campaign", "round5_campaign", "round5_phase2")
# the repository tools that the scripts run by path, and their ports
TOOLS = {"tools/accuracy_study.py": "tools.accuracy_study",
         "tools/calibrate_ensemble.py": "tools.calibrate_ensemble",
         "tools/decision_ab.py": "tools.decision_ab",
         "tools/stablehlo_drive.py": "tools.artifact_drive",
         "benchmarks/stage_decomp.py": "tools.profile_serving"}

STUB = r'''
"""A stand-in for the interpreter of a campaign's steps: logs its argv,
writes the files that later steps read, prints canned JSON, and fails
where STUB_FAIL ([[substring, ...], exit code]) matches every substring."""
import json, os, sys

args = sys.argv[1:]
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps(args) + "\n")
if args[0] == "-":  # a heredoc: the interpreter runs it, with its site-packages
    os.execv(sys.executable, [sys.executable, *args])
tool, rest = ((args[1].rsplit(".", 1)[-1], args[2:]) if args[0] == "-m"
              else (os.path.basename(args[0])[:-len(".py")], args[1:]))
# a JAX tool by its port's name, so both sides' logs read alike
tool = {"stablehlo_drive": "artifact_drive", "stage_decomp": "profile_serving"}.get(tool, tool)
print(f"stub {tool}", file=sys.stderr)
fail = json.loads(os.environ.get("STUB_FAIL") or "null")
if fail and all(any(s in a for a in args) for s in fail[0]):
    sys.exit(fail[1])


def opt(name):
    return rest[rest.index(name) + 1]


def score(*parts):
    return sum(map(ord, "".join(parts))) % 89 / 89


def touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"stub {tool}\n")


if tool == "ensemble_trainer":
    for ext in ("", ".merged.ckpt", ".merged.pth"):
        touch(os.path.join(opt("--checkpoint-dir"), "joint_model.ckpt" + ext))
elif tool == "submodel_trainer":
    touch(os.path.join(opt("--checkpoint-dir"), "best_model.ckpt"))
elif tool == "model_merger":
    touch(opt("--output-path"))
elif tool == "add_head":
    touch(opt("--output"))
elif tool == "calibrate_ensemble":
    touch(opt("--output"))
    name = os.path.basename(opt("--output"))
    print(json.dumps({"calibration": {"threshold": score(name)}, "output": name}))
elif tool == "accuracy_study":
    data, model = opt("--data-dir"), os.path.basename(opt("--merged-model"))
    gv = str("--generic-verdict" in rest)
    names = sorted(n for n in os.listdir(data)
                   if os.path.isdir(os.path.join(data, n)) and not n.startswith("."))
    print(json.dumps({"per_class": {n: {"n": 4, "binary": score(n, model, gv)} for n in names},
                      "binary_auc": score(model, "auc"), "binary_eer": score(model, "eer")}))
elif tool == "decision_ab":
    import shutil, zipfile

    if "--from-logits" in rest:
        print(json.dumps({"from_logits": sorted(zipfile.ZipFile(opt("--from-logits")).namelist())}))
    else:
        out = opt("--output")
        shutil.copyfile(os.environ["STUB_LOGITS"], out + ".logits.npz")
        touch(out)
        print(json.dumps({"ab": os.path.basename(out)}))
elif tool == "carve_eval_split":
    for side in ("--out-cal", "--out-eval"):
        touch(os.path.join(opt(side), "Real", "a.wav"))
    print(json.dumps({"Real": {"cal": 1, "eval": 1}}))
elif tool == "artifact_drive":
    print(json.dumps({"ok": True}))
else:
    print(f"stub {tool} ran")
'''


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    """The stub, as an executable named ``python`` in a folder of its own."""
    folder = tmp_path_factory.mktemp("stub_bin")
    path = folder / "python"
    path.write_text(f"#!{sys.executable} -S\n" + STUB)  # no site: 3x quicker to start
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    # the logits cache that the stub's decision_ab writes, seeded
    rng = np.random.default_rng(0)
    np.savez_compressed(
        folder / "logits.npz", fit_logits=rng.standard_normal((6, 3)).astype(np.float32),
        fit_class_idx=np.array([0, 1, 2, 0, 1, 2]),
        test_logits=rng.standard_normal((5, 3)).astype(np.float32),
        test_file_class=np.array(["SynthA", "Real"]), test_file_count=np.array([2, 3]),
        class_names=np.array(["SynthA", "SynthB", "Real"]), real_name=np.array("Real"),
        generic_head=np.array(False))
    yield str(path)
    shutil.rmtree(folder, ignore_errors=True)


def _env(**extra):
    """The repository on the path, one BLAS thread, two intra-op threads."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP", "STUB_FAIL", "OUT", "TAG", "EXTRA")}
    env["PYTHONPATH"] = REPO
    env["OPENBLAS_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra)
    return env


def _corpus(root):
    """dataset/{train,test}: Real and five classes in an order that differs
    from a locale's (README.txt is a file, as ``ls`` lists it; .cache is
    skipped)."""
    for side in ("train", "test"):
        for cls in ("Real", "SynthA", "SynthB", "SynthD", "SynthF", "synthc", ".cache"):
            os.makedirs(os.path.join(root, "dataset", side, cls))
            with open(os.path.join(root, "dataset", side, cls, "a.wav"), "w") as f:
                f.write("wav")
        with open(os.path.join(root, "dataset", side, "README.txt"), "w") as f:
            f.write("notes")


def _stub_run(stub, log, argv, env, cwd):
    env = dict(env, STUB_LOG=log, STUB_LOGITS=os.path.join(os.path.dirname(stub), "logits.npz"))
    return subprocess.run(argv, env=env, cwd=cwd, capture_output=True, text=True, timeout=120)


def _run_both(stub, tmp_path, name, args, knobs=None, prepare=None):
    """The script and the driver on two copies of the corpus, under the
    stub. → {side: (exit code, stdout, stderr, argv list, root)}."""
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side / "corpus")
        _corpus(root)
        if prepare:
            prepare(root, stub, str(tmp_path / side / "prep.log"))
        log = str(tmp_path / side / "argv.log")
        env = _env(LC_ALL="C",
                   **{k: v.replace("<root>", root) for k, v in (knobs or {}).items()})
        argv_tail = [a.replace("<root>", root) for a in args]
        if side == "jax":
            env["PATH"] = os.path.dirname(stub) + os.pathsep + env.get("PATH", "")
            cmd = ["bash", os.path.join(REPO, "tools", f"{name}.sh"), root, *argv_tail]
        else:
            cmd = [sys.executable, "-c",
                   "import importlib, sys\n"
                   "from synthetic_audio_detection_tpu_torch.tools import campaign\n"
                   "campaign.INTERPRETER = [sys.argv[1]]\n"
                   "mod = importlib.import_module("
                   "'synthetic_audio_detection_tpu_torch.tools.' + sys.argv[2])\n"
                   "sys.exit(mod.main(sys.argv[3:]))\n",
                   stub, name, root, *argv_tail]
        res = _stub_run(stub, log, cmd, env, str(tmp_path / side))
        calls = []
        if os.path.exists(log):
            with open(log) as f:
                calls = [json.loads(line) for line in f]
        out[side] = (res.returncode, res.stdout, res.stderr, calls, root)
    return out


def _mapped(argv):
    """A JAX step's argv with the modules and tools mapped to the port's."""
    if argv[0] == "-m":
        return ["-m", argv[1].replace("synthetic_audio_detection_tpu.", PORT + "."), *argv[2:]]
    if argv[0] == "tools/carve_eval_split.py":
        return [campaign.CARVE_EVAL_SPLIT, *argv[1:]]
    return ["-m", f"{PORT}.{TOOLS[argv[0]]}", *argv[1:]]


def _no_device(argv):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--device":
            skip = True
        else:
            out.append(a)
    return out


TIMES = re.compile(r"\b\d\d:\d\d:\d\d\b")


def _norm(text, root):
    return TIMES.sub("HH:MM:SS", text.replace(root, "<root>"))


def _snapshot(root):
    """Every file and link under ``root``: text normalised (root, times),
    symlink targets likewise, .npz files by their arrays."""
    snap = {}
    for d, dirs, files in os.walk(root):
        for n in dirs + files:
            p = os.path.join(d, n)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                snap[rel] = "link:" + _norm(os.readlink(p), root)
            elif n.endswith(".npz"):
                with np.load(p) as z:
                    snap[rel] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}
            elif os.path.isfile(p):
                with open(p, "rb") as f:
                    snap[rel] = _norm(f.read().decode(), root)
    return snap


def _assert_same(both):
    """The same exit code, steps, stdout and files; → the port's steps."""
    rc_j, out_j, err_j, calls_j, root_j = both["jax"]
    rc_p, out_p, err_p, calls_p, root_p = both["port"]
    assert rc_p == rc_j, (rc_j, err_j[-2000:], rc_p, err_p[-2000:])
    want = [[_norm(a, root_j) for a in _mapped(c)] for c in calls_j if c[0] != "-"]
    got = [[_norm(a, root_p) for a in _no_device(c)] for c in calls_p]
    assert got == want
    assert _norm(out_p, root_p) == _norm(out_j, root_j)
    assert _snapshot(root_p) == _snapshot(root_j)
    return calls_p


def _joint_artifact(root, *names):
    for g in names:
        os.makedirs(os.path.join(root, f"logo_{g}"))
        with open(os.path.join(root, f"logo_{g}", "joint_model.ckpt.merged.ckpt"), "w") as f:
            f.write("artifact")


def _round4_cache(root, stub, log):
    """The SynthD artifact and the round-4 A/B's logits cache, as the stub
    writes it."""
    _joint_artifact(root, "SynthD")
    _stub_run(stub, log, [stub, "-m", f"{PORT}.tools.decision_ab", "--output",
                          os.path.join(root, "logo_SynthD_decision_ab.json")], _env(), None)


def _baselines(tag, holdouts):
    def prepare(root, stub, log):
        _joint_artifact(root, *(g + tag for g in holdouts))
        for g in holdouts:
            with open(os.path.join(root, f"logo_{g}{tag}_full.json"), "w") as f:
                json.dump({"per_class": {c: {"binary": 0.1 * i} for i, c in
                                         enumerate(["Real", "SynthA", "SynthB", "SynthD",
                                                    "SynthF"])}}, f)
    return prepare


CASES = {
    "ensemble_sequential_hard_neg": ("train_study_ensemble", [], {"HARD_NEG": "1"}, None, 0),
    "ensemble_sequential_knobs": ("train_study_ensemble", [],
                                  {"EPOCHS": "2", "INPUT_SIZE": "256", "BATCH": "16",
                                   "SEED": "3", "BF16": "0", "WORKERS": "2",
                                   "OUT": "<root>/out"}, None, 0),
    "ensemble_joint": ("train_study_ensemble", [], {"JOINT": "1", "PER_HEAD_STAGES": "1"},
                       None, 0),
    "ensemble_failing_head": ("train_study_ensemble", [],
                              {"STUB_FAIL": json.dumps([["submodel_trainer", "heads/SynthB"], 5])},
                              None, 5),
    "logo_defaults": ("generalization_study", [], {"TAG": "_t",
                                                  "EXTRA": " --no-hard-negatives  --wave-augment"},
                      None, 0),
    "logo_one_holdout": ("generalization_study", ["SynthB"], {"EPOCHS": "1", "SIZE": "64",
                                                              "SEED": "5", "BATCH": "8"}, None, 0),
    "logo_failing_eval": ("generalization_study", ["SynthA", "SynthD"],
                          {"STUB_FAIL": json.dumps([["accuracy_study", "logo_SynthD_eval"], 4])},
                          None, 4),
    "calibration_defaults": ("logo_calibration_followup", [], {}, _baselines("", ["SynthA",
                                                                                  "SynthD",
                                                                                  "SynthF"]), 0),
    "calibration_empty_tag": ("logo_calibration_followup", [""], {"SIZE": "64", "BATCH": "8"},
                              _baselines("", ["SynthA", "SynthD", "SynthF"]), 0),
    "calibration_tag_holdout": ("logo_calibration_followup", ["_t", "SynthB"], {},
                                _baselines("_t", ["SynthB"]), 0),
    "addhead": ("round5_addhead_study", [], {}, lambda r, s, log: _joint_artifact(r, "SynthD"),
                0),
    "addhead_failing": ("round5_addhead_study", [], {"STUB_FAIL": json.dumps([["add_head"], 4])},
                        lambda r, s, log: _joint_artifact(r, "SynthD"), 1),
    "round4_failing_unseen_eval": ("round4_campaign", [],
                                   {"STUB_FAIL": json.dumps([["accuracy_study",
                                                              "logo_SynthD_eval"], 3])},
                                   None, 0),
    "round4_logdir_failing_train": ("round4_campaign", ["<root>/logs4"],
                                    {"STUB_FAIL": json.dumps([["ensemble_trainer",
                                                               "logo_SynthF_waug"], 2])},
                                    None, 0),
    "round5": ("round5_campaign", [], {}, lambda r, s, log: _joint_artifact(r, "SynthD"), 0),
    "round5_no_artifact": ("round5_campaign", ["<root>/logs5"], {}, None, 0),
    "phase2": ("round5_phase2", [], {}, _round4_cache, 0),
    "phase2_failing": ("round5_phase2", [], {"STUB_FAIL": json.dumps([["decision_ab",
                                                                        "test_cal"], 9])},
                       _round4_cache, 1),
    "phase2_no_artifact": ("round5_phase2", [], {}, None, 1),
    "phase2_no_cache": ("round5_phase2", [], {},
                        lambda r, s, log: _joint_artifact(r, "SynthD"), 1),
}


def _round4_skips_the_ab_of_a_failed_arm(both, calls):
    steps = [c[1].rsplit(".", 1)[-1] for c in calls]
    # SynthD's unseen eval failed, so its A/B did not run; SynthF's and SynthA's did
    assert steps.count("decision_ab") == 2 and steps.count("ensemble_trainer") == 5
    assert steps[-4:] == ["ensemble_trainer", "accuracy_study", "accuracy_study", "decision_ab"]
    assert "profile_serving" in steps and "artifact_drive" in steps
    with open(os.path.join(both["port"][4], "campaign_logs", "campaign.log")) as f:
        log = f.read()
    assert "=== eval_SynthD_unseen rc=3" in log and "=== ab_SynthF rc=0" in log
    assert re.search(r"=== campaign done \w{3} \w{3} [ \d]\d \d\d:\d\d:\d\d UTC \d{4}\n$", log)


def _phase2_synthesizes_the_cache(both, calls):
    root = both["port"][4]
    with np.load(f"{root}/calsplit_trainfit.synth.npz") as z, \
            np.load(f"{root}/logo_SynthD_decision_ab.json.logits.npz") as old:
        assert np.array_equal(z["fit_logits"], old["fit_logits"]) and not bool(z["generic_head"])
    with open(f"{root}/campaign_logs/ab_trainfit.log") as f:
        log = f.read()
    assert log.startswith("synthesized train-fit/eval-half cache\n") and "from_logits" in log


def _phase2_names_the_missing_cache(both, calls):
    root = both["port"][4]
    assert both["port"][1] == f"no round-4 cache {root}/logo_SynthD_decision_ab.json.logits.npz\n"
    assert calls == []


def _the_failing_head_ends_the_run(both, calls):
    assert [c[1].rsplit(".", 1)[-1] for c in calls] == ["submodel_trainer"] * 3
    assert calls[-1][calls[-1].index("--Class1") + 1] == "SynthB"


CHECKS = {"round4_failing_unseen_eval": _round4_skips_the_ab_of_a_failed_arm,
          "phase2": _phase2_synthesizes_the_cache,
          "phase2_no_cache": _phase2_names_the_missing_cache,
          "ensemble_failing_head": _the_failing_head_ends_the_run}


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_gives_the_scripts_steps_files_and_exit_code(stub, tmp_path, case):
    name, args, knobs, prepare, rc = CASES[case]
    device = "cuda" if case.startswith("round4") else "cpu"  # the default, and the knob
    both = _run_both(stub, tmp_path, name, args, {"DEVICE": device, **knobs}, prepare)
    calls = _assert_same(both)
    assert both["port"][0] == rc
    # no step of the port names the JAX package, nor a repository tool
    # other than the one that imports neither package
    for argv in calls:
        assert not any("synthetic_audio_detection_tpu." in a for a in argv), argv
        assert not any(a.endswith(".py") and a != campaign.CARVE_EVAL_SPLIT for a in argv), argv
        if argv[0] == "-m":
            assert argv[1].startswith(PORT + ".") and argv[-2:] == ["--device", device], argv
    if case in CHECKS:
        CHECKS[case](both, calls)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_the_cases_cover_every_script():
    assert {c[0] for c in CASES.values()} == set(DRIVERS)
    assert set(CHECKS) <= set(CASES)


def test_classes_follow_ls_under_the_c_locale(tmp_path):
    _corpus(str(tmp_path))
    got = campaign.classes(str(tmp_path / "dataset" / "test"))
    ls = subprocess.run(["bash", "-c", f"ls {tmp_path}/dataset/test | grep -v '^Real$'"],
                        env=dict(os.environ, LC_ALL="C"), capture_output=True, text=True)
    assert got == ls.stdout.split() == ["README.txt", "SynthA", "SynthB", "SynthD", "SynthF",
                                        "synthc"]


def test_unseen_tree_links_absolute_folders(tmp_path):
    _corpus(str(tmp_path))
    ev = str(tmp_path / "ev")
    os.makedirs(os.path.join(ev, "stale"))
    rel = os.path.relpath(str(tmp_path / "dataset" / "test"))
    assert campaign.unseen_tree(rel, "SynthB", ev)
    assert sorted(os.listdir(ev)) == ["Real", "SynthB"]
    assert os.readlink(os.path.join(ev, "SynthB")) == str(tmp_path / "dataset" / "test" / "SynthB")
    assert not campaign.unseen_tree(str(tmp_path / "dataset" / "test"), "Nope", ev)
    assert os.listdir(ev) == ["Real"]


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_step_past_its_bound_is_killed_with_its_group(tmp_path):
    """A child that sleeps and spawns a sleeping grandchild: the step
    returns 124 within a few seconds, logs rc=124, and leaves neither."""
    pids = tmp_path / "pids"
    code = ("import subprocess, sys, time\n"
            "g = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
            f"open({str(pids)!r}, 'w').write(f'{{__import__(\"os\").getpid()}} {{g.pid}}')\n"
            "print('started', flush=True)\n"
            "time.sleep(120)\n")
    log = str(tmp_path / "campaign.log")
    t0 = time.monotonic()
    rc = campaign.step("sleeper", 1, [sys.executable, "-c", code], str(tmp_path), log)
    took = time.monotonic() - t0
    assert rc == 124 and took < 8, (rc, took)
    lines = open(log).read().splitlines()
    assert re.fullmatch(r"=== sleeper start \d\d:\d\d:\d\d", lines[0])
    assert re.fullmatch(r"=== sleeper rc=124 \d\d:\d\d:\d\d", lines[1])
    assert open(tmp_path / "sleeper.log").read() == "started\n"
    child, grandchild = map(int, pids.read_text().split())
    deadline = time.monotonic() + 5
    while not (_gone(child) and _gone(grandchild)) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _gone(child) and _gone(grandchild)


def test_step_exit_codes_follow_the_shell(tmp_path):
    log = str(tmp_path / "campaign.log")
    assert campaign.step("ok", 30, [sys.executable, "-c", "print('x')"], str(tmp_path), log) == 0
    assert campaign.step("three", 30, [sys.executable, "-c", "raise SystemExit(3)"],
                         str(tmp_path), log) == 3
    assert campaign.step("killed", 30, [sys.executable, "-c",
                                        "import os, signal; os.kill(os.getpid(), signal.SIGTERM)"],
                         str(tmp_path), log) == 128 + 15
    assert campaign.stepj("j", 30, str(tmp_path / "o.json"),
                          [sys.executable, "-c", "import sys; print('{}'); print('e', file=sys.stderr)"],
                          str(tmp_path), log) == 0
    assert open(tmp_path / "o.json").read() == "{}\n" and open(tmp_path / "j.log").read() == "e\n"
    assert campaign.command("tools/x.py", 1)[-2:] == ["tools/x.py", "1"]
    assert campaign.command("cli.add_head")[-2:] == ["-m", f"{PORT}.cli.add_head"]


def test_the_no_jax_checks_walk_the_drivers():
    """tests/test_torch_no_jax.py walks the package (its tools/ with
    pkgutil, every source file statically): the drivers are among its
    modules, and none imports JAX or the JAX package."""
    import pkgutil

    from tests.test_torch_no_jax import FORBIDDEN, REFERENCE, _imports

    names = {m.name for m in pkgutil.iter_modules([os.path.join(REPO, PORT, "tools")])}
    for driver in DRIVERS + ("campaign",):
        assert driver in names
        path = os.path.join(REPO, PORT, "tools", f"{driver}.py")
        assert all(m.split(".")[0] not in FORBIDDEN + (REFERENCE,) for m in _imports(path))


# ---------------------------------------------------------------------------
# One tiny chain for real, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """dataset/{train,test}/{Real,SynA,SynB} (tests/torch_release.py's tone
    clips), then, side by side: train_study_ensemble sequentially with
    HARD_NEG=1, the same with JOINT=1 into OUT, and generalization_study
    holding out SynA. → (root, {run: (exit code, stdout, stderr)})."""
    from tests.torch_release import tiny_tree

    base = tmp_path_factory.mktemp("campaign_chain")
    root = base / "corpus"
    for side in ("train", "test"):
        tiny_tree(root / "dataset" / side, extra=())
    knobs = dict(DEVICE="cpu", EPOCHS="1", INPUT_SIZE="64", SIZE="64", BATCH="8", BF16="0",
                 WORKERS="1")
    runs = {"sequential": ("train_study_ensemble", [], {"HARD_NEG": "1"}),
            "joint": ("train_study_ensemble", [], {"JOINT": "1", "OUT": str(root / "joint")}),
            "logo": ("generalization_study", ["SynA"], {})}
    procs = {k: subprocess.Popen([sys.executable, "-m", f"{PORT}.tools.{name}", str(root), *args],
                                 env=_env(**knobs, **extra), cwd=str(base),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, (name, args, extra) in runs.items()}
    results = {}
    try:
        for k, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            results[k] = (proc.returncode, out, err)
        yield str(root), results
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(base, ignore_errors=True)  # about 1 GB of checkpoints


def _study(text):
    study = json.loads(text)
    assert study["per_class"].keys() == {"Real", "SynA", "SynB"}
    assert all(np.isfinite(v["binary"]) for v in study["per_class"].values())
    return study


@pytest.mark.parametrize("run", ["sequential", "joint"])
def test_tiny_chain_trains_merges_and_studies(chain, run):
    from synthetic_audio_detection_tpu_torch.checkpoints import serialization

    root, results = chain
    rc, out, err = results[run]
    assert rc == 0, err[-3000:]
    e = os.path.join(root, "ensemble" if run == "sequential" else "joint")
    assert serialization.load_merged(os.path.join(e, "merged.pth")).class_names == \
        ["SynA", "SynB", "Real"]
    with open(os.path.join(e, "study.json")) as f:
        text = f.read()
    _study(text)
    assert text in out and out.endswith(f"=== done: {e}\n")  # the tee
    if run == "sequential":
        assert open(os.path.join(e, "recipe.csv")).read() == (
            "model_filename,synthetic_class,real_class\n"
            "heads/SynA/best_model.ckpt,SynA,Real\nheads/SynB/best_model.ckpt,SynB,Real\n")
        assert "=== heads: SynA\nSynB (epochs=1 input=64 batch=8 hard_neg=1)" in out
    else:
        assert os.path.isfile(os.path.join(e, "joint", "joint_model.ckpt.merged.ckpt"))


def test_tiny_logo_study_writes_its_row(chain):
    root, results = chain
    rc, out, err = results["logo"]
    assert rc == 0, err[-3000:]
    full = _study(open(os.path.join(root, "logo_SynA_full.json")).read())
    unseen = json.loads(open(os.path.join(root, "logo_SynA_unseen.json")).read())
    assert unseen["per_class"].keys() == {"Real", "SynA"}
    assert os.readlink(os.path.join(root, "logo_SynA_eval", "SynA")) == \
        os.path.join(root, "dataset", "test", "SynA")
    pc = full["per_class"]
    row = (f"| SynA | {pc['SynA']['binary']:.3f} | {pc['SynB']['binary']:.3f} | "
           f"{pc['Real']['binary']:.3f} | {unseen['binary_auc']:.3f} | "
           f"{unseen['binary_eer']:.3f} |")
    assert out.endswith("=== summary\n| holdout | unseen TPR | seen TPR (mean) | Real TNR | "
                        "unseen AUC | unseen EER |\n|---|---|---|---|---|---|\n" + row + "\n")
    assert "=== holdout SynA: train joint ensemble on: SynB \n" in out
