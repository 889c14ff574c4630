"""Cholec80 dataset indexing — annotations to arrayized manifests.

Rebuilds the reference's offline prep (get_path_labels.py): parse
``phase_annotations/video<NN>-phase.txt`` (25-fps rows ``frame\\tPhaseName``),
``tool_annotations/video<NN>-tool.txt`` (rows every 25 frames, 7 binary
columns), and anticipation GT; subsample to 1 fps (every 25th frame);
build per-frame records ``[img_path, phase, 7xtool, 7xanticipation]`` and the
two split schemes:

- stage1: train videos 0-31, val 40-47, test 40-79 (32/8/40)
- stage2: train videos 0-39, val 40-47, test 40-79 (40/8⊂40/40)
  (the val ⊂ test quirk is intentional, get_path_labels.py:207-219)

Labels are one [N, 15] float array per split (col 0 phase, 1:8 tools,
8:15 anticipation — the layout tecno.py:207-208 indexes into). The
reference's 9-element pickle is import/exportable for artifact parity.

The port's own copy of ``surgical_tpu/data/cholec80.py`` (numpy only; the
port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from surgical_tpu_torch.core.config import PHASE_NAMES
from surgical_tpu_torch.data.anticipation import anticipation_gt, phases_to_one_hot

PHASE_TO_ID = {name: i for i, name in enumerate(PHASE_NAMES)}
DOWNSAMPLE = 25

# M2CAI16 workflow-challenge variant: 8 phases, no tool annotations
# (get_path_labels.py M2CAI16 branch; M2caiSegmapDataset uses label cols 1:9)
M2CAI_PHASE_NAMES = (
    "TrocarPlacement",
    "Preparation",
    "CalotTriangleDissection",
    "ClippingCutting",
    "GallbladderDissection",
    "GallbladderPackaging",
    "CleaningCoagulation",
    "GallbladderRetraction",
)
M2CAI_PHASE_TO_ID = {name: i for i, name in enumerate(M2CAI_PHASE_NAMES)}


@dataclass
class VideoIndex:
    video_id: int  # 1-based
    img_paths: list[str]  # one per 1-fps frame
    labels: np.ndarray  # [T, 15]: phase, 7 tools, 7 anticipation

    @property
    def num_frames(self) -> int:
        return len(self.img_paths)


@dataclass
class Split:
    paths: list[str]
    labels: np.ndarray  # [N, 15]
    num_each: list[int]
    # actual video numbers of this split, in order — prediction artifacts are
    # named video<NN>-phase.txt after THESE ids (trans_SV_output.py:304-321),
    # which only coincide with a 41-offset for the Cholec80 val/test splits
    video_ids: list[int] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.video_ids is None:
            self.video_ids = list(range(1, len(self.num_each) + 1))

    @property
    def starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.num_each)[:-1]]).astype(np.int64)


def parse_phase_file(path: str, phase_to_id: dict | None = None) -> np.ndarray:
    """25-fps per-frame phase ids (header row skipped). Pass
    ``M2CAI_PHASE_TO_ID`` for the M2CAI16 variant."""
    phase_to_id = phase_to_id or PHASE_TO_ID
    phases = []
    with open(path) as f:
        next(f)
        for line in f:
            parts = line.split()
            if not parts:
                continue
            phases.append(phase_to_id[parts[1]])
    return np.asarray(phases, dtype=np.int64)


def parse_tool_file(path: str) -> np.ndarray:
    """[K, 7] binary tool presences (rows already at 25-frame stride)."""
    rows = []
    with open(path) as f:
        next(f)
        for line in f:
            parts = line.split()
            if not parts:
                continue
            rows.append([int(x) for x in parts[1:8]])
    return np.asarray(rows, dtype=np.int64)


def index_video(
    video_id: int,
    img_dir: str,
    phase_file: str,
    tool_file: str | None,
    horizon: float = 5.0,
    phase_to_id: dict | None = None,
    with_tools: bool = True,
) -> VideoIndex:
    """Build the 1-fps record array for one video. Anticipation GT is computed
    on the FULL 25-fps timeline then subsampled, matching the reference's
    pipeline (generate_phase_anticipation.py writes full-rate files that
    get_path_labels.py:151-165 subsamples).

    with_tools=False (M2CAI16) drops the 7 tool columns entirely, giving the
    reference's [phase, P x ant] row layout (get_path_labels.py M2CAI branch;
    M2caiSegmapDataset indexes ant at cols 1:9)."""
    phase_to_id = phase_to_id or PHASE_TO_ID
    num_phases = len(phase_to_id)
    phases_25fps = parse_phase_file(phase_file, phase_to_id)
    ant_25fps = anticipation_gt(
        phases_to_one_hot(phases_25fps, num_phases), horizon=horizon
    )

    sub = np.arange(0, len(phases_25fps), DOWNSAMPLE)
    phases = phases_25fps[sub]
    ant = ant_25fps[sub]

    cols = [phases[:, None].astype(np.float64)]
    if with_tools:
        if tool_file is not None:
            tools = parse_tool_file(tool_file)
            # tool rows are already one per 25-frame step; pad/trim to match
            K = len(sub)
            if len(tools) < K:
                tools = np.concatenate([tools, np.repeat(tools[-1:], K - len(tools), 0)])
            tools = tools[:K]
        else:
            tools = np.zeros((len(sub), 7), dtype=np.int64)
        cols.append(tools.astype(np.float64))
    cols.append(ant)

    labels = np.concatenate(cols, axis=1)
    img_paths = [os.path.join(img_dir, f"{f}.jpg") for f in sub]
    return VideoIndex(video_id, img_paths, labels)


def index_dataset(
    root: str, num_videos: int = 80, horizon: float = 5.0,
    dataset: str = "cholec80",
) -> list[VideoIndex]:
    """root layout (reference README): cutMargin/<1..80>/<frame>.jpg,
    phase_annotations/video<NN>-phase.txt, tool_annotations/video<NN>-tool.txt.

    dataset="m2cai16": 8-phase vocabulary, no tool annotations, labels
    [T, 9] = [phase, 8 x anticipation] (get_path_labels.py:77-88,250-317).
    """
    m2cai = dataset == "m2cai16"
    phase_to_id = M2CAI_PHASE_TO_ID if m2cai else PHASE_TO_ID
    videos = []
    for v in range(1, num_videos + 1):
        img_dir = os.path.join(root, "cutMargin", str(v))
        phase_file = os.path.join(root, "phase_annotations", f"video{v:02d}-phase.txt")
        tool_file = os.path.join(root, "tool_annotations", f"video{v:02d}-tool.txt")
        videos.append(
            index_video(
                v,
                img_dir,
                phase_file,
                tool_file if (not m2cai and os.path.exists(tool_file)) else None,
                horizon,
                phase_to_id=phase_to_id,
                with_tools=not m2cai,
            )
        )
    return videos


def _collect(videos: Sequence[VideoIndex], width: int = 15) -> Split:
    paths, labels, num_each, ids = [], [], [], []
    for v in videos:
        paths.extend(v.img_paths)
        labels.append(v.labels)
        num_each.append(v.num_frames)
        ids.append(v.video_id)
    return Split(paths, np.concatenate(labels) if labels else np.zeros((0, width)),
                 num_each, ids)


def make_splits(videos: Sequence[VideoIndex], scheme: str = "stage2"):
    """Returns (train, val, test) Splits per the reference schemes.

    - stage1 / stage2: Cholec80 32- / 40-video train, val 41-48 ⊂ test 41-80.
    - m2cai: 27 train / val 28-34 ⊂ test 28-41 — the 27_7_14 split recorded
      in the reference's pickle name (get_path_labels.py:283-296,317; the
      val/test loops are commented out there, the filename and the same
      val ⊂ test pattern as Cholec80 pin the intent).
    - m2cai_all: all 41 videos in train, empty val/test — the branch as it
      literally executes.
    """
    width = videos[0].labels.shape[1] if videos else 15
    if scheme in ("stage1", "stage2"):
        n_train = {"stage1": 32, "stage2": 40}[scheme]
        train = _collect(videos[:n_train], width)
        val = _collect(videos[40:48], width)
        test = _collect(videos[40:80], width)
    elif scheme == "m2cai":
        train = _collect(videos[:27], width)
        val = _collect(videos[27:34], width)
        test = _collect(videos[27:41], width)
    elif scheme == "m2cai_all":
        train = _collect(videos[:41], width)
        val = _collect([], width)
        test = _collect([], width)
    elif scheme == "smoke":
        # synthetic pipeline drives only: proportional split of however many
        # videos exist (the reference schemes hardcode 80-/41-video corpora)
        n = len(videos)
        a, b = max(1, n // 2), max(1, n // 4)
        train = _collect(videos[:a], width)
        val = _collect(videos[a : a + b], width)
        test = _collect(videos[a + b :], width)
    else:
        raise ValueError(f"unknown split scheme {scheme!r}")
    return train, val, test


# -- reference 9-element pickle interop --------------------------------------

def to_reference_pickle(train: Split, val: Split, test: Split, path: str) -> None:
    payload = [
        train.paths, val.paths,
        [list(r) for r in train.labels], [list(r) for r in val.labels],
        train.num_each, val.num_each,
        test.paths, [list(r) for r in test.labels], test.num_each,
    ]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def from_reference_pickle(path: str):
    with open(path, "rb") as f:
        p = pickle.load(f)
    train = Split(p[0], np.asarray(p[2], dtype=np.float64), list(p[4]))
    val = Split(p[1], np.asarray(p[3], dtype=np.float64), list(p[5]))
    test = Split(p[6], np.asarray(p[7], dtype=np.float64), list(p[8]))
    return train, val, test
