"""Dataset ETL: rename → convert → segment → split → leakage audit (the
port's copy of the reference package's ``data/etl.py``).

The reference's offline filesystem pipeline, honoring its persistence
contracts:

- **Filename contract**: ``<16-hex-sha256>[_<aug>_<param>]_Segment_<NNN>.wav``
  (file_renamer.py:15-21, audio_segmenter.py:24, audio_augmneter.py:194-200).
- **Dataset tree contract**: ``out/{train,test}/<Class>/*.wav``
  (dataset_manager.py:100-103).
- Leakage rule: all segments of one source file (same hash prefix) must land
  on one side of the split (file_manager.py:62-71).

Differences from the reference (deliberate fixes, SURVEY.md §4 anti-patterns):
errors are *reported*, not silently swallowed (dataset_manager.py:70-74,
audio_segmenter.py:53-57 swallow exceptions); conversion/segmentation are
ffmpeg-free for WAV input (own reader + polyphase resampler), with ffmpeg used
only when present AND the input is a non-WAV container.

NumPy only, and nothing here imports torch (nor does ``audio/wavio``,
``audio/decode`` or ``audio/dsp``): the ETL runs on the host, in CLI
processes that need no CUDA context.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import os
import random
import shutil
import subprocess
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from synthetic_audio_detection_tpu_torch.audio import wavio
from synthetic_audio_detection_tpu_torch.audio.decode import have_ffmpeg
from synthetic_audio_detection_tpu_torch.audio.dsp import resample_poly_np

AUDIO_EXTENSIONS = (".mp3", ".wav", ".ogg", ".flac", ".aac", ".wma", ".opus")
TARGET_SR = 32_000
SEGMENT_SECONDS = 4


# ---------------------------------------------------------------------------
# 1) file renamer (file_renamer.py:15-44)
# ---------------------------------------------------------------------------

def hash_file(path: str, n_chars: int = 16) -> str:
    """First 16 hex chars of the file's SHA-256 (the provenance key;
    file_renamer.py:15-21 — its docstring says 6, the code takes 16)."""
    hasher = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            hasher.update(chunk)
    return hasher.hexdigest()[:n_chars]


def rename_files(input_dir: str, recursive: bool = False) -> List[Tuple[str, str]]:
    """Rename audio files in place to ``<hash><ext>``; returns (old, new) pairs."""
    renamed = []
    if recursive:
        walker: Iterable[Tuple[str, List[str]]] = (
            (root, files) for root, _, files in os.walk(input_dir)
        )
    else:
        walker = [(input_dir, os.listdir(input_dir))]
    for root, files in walker:
        for filename in files:
            if not filename.lower().endswith(AUDIO_EXTENSIONS):
                continue
            src = os.path.join(root, filename)
            if not os.path.isfile(src):
                continue
            ext = os.path.splitext(filename)[1]
            dst = os.path.join(root, f"{hash_file(src)}{ext}")
            if src != dst:
                os.rename(src, dst)
                renamed.append((src, dst))
    return renamed


# ---------------------------------------------------------------------------
# 2) audio converter (audio_convert.py:15-55)
# ---------------------------------------------------------------------------

def convert_audio_file(
    input_path: str, output_path: str, target_sr: int = TARGET_SR
) -> Optional[str]:
    """Normalize one file to ``target_sr`` mono 16-bit WAV.

    WAV input: native decode → channel-mean downmix → polyphase resample.
    Non-WAV containers: delegated to ffmpeg when available (the reference's
    only decode path, audio_convert.py:26-34); error otherwise.
    Returns an error string or None on success.
    """
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    ext = os.path.splitext(input_path)[1].lower()
    try:
        if ext == ".wav":
            wf, sr = wavio.read_wav(input_path)
            mono = wf.mean(axis=0)
            if sr != target_sr:
                mono = resample_poly_np(mono, sr, target_sr)
            wavio.write_wav(output_path, mono, target_sr, subtype="PCM_16")
            return None
        if have_ffmpeg():
            cmd = [
                "ffmpeg", "-loglevel", "error", "-y", "-i", input_path,
                "-ar", str(target_sr), "-ac", "1", "-sample_fmt", "s16",
                output_path,
            ]
            res = subprocess.run(cmd, capture_output=True, text=True)
            return None if res.returncode == 0 else res.stderr.strip()
        return f"{input_path}: non-WAV input requires ffmpeg (not installed)"
    except Exception as e:  # noqa: BLE001 - per-file isolation, reported not raised
        return f"{input_path}: {e}"


def convert_directory(
    input_dir: str, output_dir: str, target_sr: int = TARGET_SR, workers: int = 0
) -> List[str]:
    """Convert every audio file; returns error strings (empty = clean)."""
    files = [
        f for f in sorted(os.listdir(input_dir))
        if f.lower().endswith(AUDIO_EXTENSIONS)
    ]
    os.makedirs(output_dir, exist_ok=True)
    tasks = [
        (
            os.path.join(input_dir, f),
            os.path.join(output_dir, os.path.splitext(f)[0] + ".wav"),
        )
        for f in files
    ]
    errors: List[str] = []
    workers = workers or os.cpu_count() or 1
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        for err in ex.map(lambda t: convert_audio_file(*t, target_sr), tasks):
            if err:
                errors.append(err)
    return errors


# ---------------------------------------------------------------------------
# 3) audio segmenter (audio_segmenter.py:15-58)
# ---------------------------------------------------------------------------

def split_audio(
    input_path: str,
    output_dir: str,
    target_sr: int = TARGET_SR,
    segment_seconds: int = SEGMENT_SECONDS,
) -> List[str]:
    """One file → ``{base}_Segment_%03d.wav`` 4 s mono chunks (the exact
    naming contract of audio_segmenter.py:24; stereo downmix 0.5/0.5 mirrors
    its ffmpeg pan filter). The trailing partial segment is kept (ffmpeg
    ``-f segment`` behavior). Returns written paths."""
    base = os.path.splitext(os.path.basename(input_path))[0]
    os.makedirs(output_dir, exist_ok=True)
    wf, sr = wavio.read_wav(input_path)
    mono = wf.mean(axis=0)
    if sr != target_sr:
        mono = resample_poly_np(mono, sr, target_sr)
    seg_len = target_sr * segment_seconds
    out_paths = []
    n_segments = (len(mono) + seg_len - 1) // seg_len
    for i in range(n_segments):
        chunk = mono[i * seg_len : (i + 1) * seg_len]
        if chunk.size == 0:
            break
        path = os.path.join(output_dir, f"{base}_Segment_{i:03d}.wav")
        wavio.write_wav(path, chunk, target_sr, subtype="PCM_16")
        out_paths.append(path)
    return out_paths


def segment_directory(
    input_path: str, output_dir: str, workers: int = 0
) -> Tuple[int, List[str]]:
    """Segment a file or a directory of WAVs. Returns (files_done, errors)."""
    if os.path.isfile(input_path):
        files = [input_path]
    else:
        files = [
            os.path.join(input_path, f)
            for f in sorted(os.listdir(input_path))
            if f.lower().endswith(".wav")
        ]
    errors: List[str] = []
    done = 0
    workers = workers or os.cpu_count() or 1

    def work(path):
        try:
            split_audio(path, output_dir)
            return None
        except Exception as e:  # noqa: BLE001 - reported, not swallowed
            return f"{path}: {e}"

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        for err in ex.map(work, files):
            if err:
                errors.append(err)
            else:
                done += 1
    return done, errors


# ---------------------------------------------------------------------------
# 4) dataset manager: train/test split (dataset_manager.py:77-115)
# ---------------------------------------------------------------------------

@dataclass
class SplitReport:
    per_class: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)


def split_dataset(
    input_dir: str,
    output_dir: str,
    split_ratio: float = 0.5,
    threads: int = 1,
    seed: Optional[int] = None,
    group_aware: bool = True,
) -> SplitReport:
    """Move each class folder's WAVs into ``output/{train,test}/<class>/``.

    The reference samples *files* uniformly (dataset_manager.py:93-97), which
    puts segments of one source recording on both sides — the very leakage
    file_manager.py then has to repair. ``group_aware=True`` (default) samples
    *source groups* (hash prefix before the first '_') instead, achieving
    per-class ratios without leakage in one pass; ``group_aware=False``
    reproduces the reference's file-level behavior exactly.
    """
    classes = [
        d for d in sorted(os.listdir(input_dir))
        if os.path.isdir(os.path.join(input_dir, d))
    ]
    report = SplitReport()

    def process_class(cls: str):
        # Per-class RNG derived from (seed, class): seeded splits stay
        # deterministic regardless of thread scheduling (random.Random is not
        # thread-safe and call interleaving varies across runs).
        rng = random.Random(None if seed is None else f"{seed}/{cls}")
        cls_dir = os.path.join(input_dir, cls)
        files = sorted(
            f for f in os.listdir(cls_dir) if f.lower().endswith(".wav")
        )
        if group_aware:
            groups = defaultdict(list)
            for f in files:
                groups[extract_group_key(f)].append(f)
            keys = sorted(groups)
            rng.shuffle(keys)
            # greedy fill toward the file-count target
            target = round(split_ratio * len(files))
            train_files: List[str] = []
            chosen: List[str] = []
            for k in keys:
                if len(train_files) >= target:
                    break
                train_files.extend(groups[k])
                chosen.append(k)
            if len(chosen) == len(keys) > 1 and 0 < split_ratio < 1:
                # tiny-corpus guard: the greedy overshoot would drain every
                # group into train, leaving test/<cls> empty — hold the last
                # group back so both sides exist whenever there are >= 2
                train_files = [
                    f for f in train_files if f not in set(groups[chosen[-1]])
                ]
            train_set = set(train_files)
        else:
            n_train = round(split_ratio * len(files))
            train_set = set(rng.sample(files, n_train))

        moved = {"train": 0, "test": 0}
        for f in files:
            side = "train" if f in train_set else "test"
            dst_dir = os.path.join(output_dir, side, cls)
            os.makedirs(dst_dir, exist_ok=True)
            try:
                shutil.move(os.path.join(cls_dir, f), os.path.join(dst_dir, f))
                moved[side] += 1
            except Exception as e:  # noqa: BLE001
                report.errors.append(f"{cls}/{f}: {e}")
        report.per_class[cls] = (moved["train"], moved["test"])

    if threads > 1:
        with cf.ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(process_class, classes))
    else:
        for cls in classes:
            process_class(cls)
    return report


# ---------------------------------------------------------------------------
# 5) file manager: leakage audit (file_manager.py:62-161)
# ---------------------------------------------------------------------------

def extract_group_key(filename: str) -> str:
    """Filename prefix before the first '_' — the source-file hash
    (file_manager.py:62-71)."""
    base = os.path.splitext(filename)[0]
    return base.split("_", 1)[0]


def files_by_group(folder: str) -> Dict[str, List[str]]:
    groups: Dict[str, List[str]] = defaultdict(list)
    if not os.path.isdir(folder):
        return groups
    for f in os.listdir(folder):
        if f.lower().endswith(".wav"):
            groups[extract_group_key(f)].append(f)
    return groups


@dataclass
class OverlapReport:
    # class → group key → (train_count, test_count)
    overlaps: Dict[str, Dict[str, Tuple[int, int]]] = field(default_factory=dict)
    moved: int = 0
    deleted: int = 0
    errors: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not any(self.overlaps.values())


def check_overlap(
    dataset_dir: str, fix: bool = False
) -> OverlapReport:
    """For every class present in train or test, find source groups with files
    on both sides; with fix=True move the minority side into the majority
    (deleting on filename collision) — file_manager.py:88-161 semantics."""
    train_root = os.path.join(dataset_dir, "train")
    test_root = os.path.join(dataset_dir, "test")
    classes = sorted(
        {d for r in (train_root, test_root) if os.path.isdir(r)
         for d in os.listdir(r) if os.path.isdir(os.path.join(r, d))}
    )
    report = OverlapReport()
    for cls in classes:
        tr_dir = os.path.join(train_root, cls)
        te_dir = os.path.join(test_root, cls)
        tr = files_by_group(tr_dir)
        te = files_by_group(te_dir)
        cls_overlaps = {}
        for key in sorted(set(tr) & set(te)):
            n_tr, n_te = len(tr[key]), len(te[key])
            cls_overlaps[key] = (n_tr, n_te)
            if fix:
                # minority moves into majority; ties move test → train
                if n_tr >= n_te:
                    src_dir, dst_dir, names = te_dir, tr_dir, te[key]
                else:
                    src_dir, dst_dir, names = tr_dir, te_dir, tr[key]
                for name in names:
                    src = os.path.join(src_dir, name)
                    dst = os.path.join(dst_dir, name)
                    try:
                        if os.path.exists(dst):
                            os.remove(src)
                            report.deleted += 1
                        else:
                            shutil.move(src, dst)
                            report.moved += 1
                    except Exception as e:  # noqa: BLE001
                        report.errors.append(f"{cls}/{name}: {e}")
        report.overlaps[cls] = cls_overlaps
    return report
