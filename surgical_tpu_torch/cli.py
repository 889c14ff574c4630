"""Command-line interface of the port: the serving verbs of
``surgical_tpu/cli.py`` over the same work-dir layout.

    python -m surgical_tpu_torch.cli predict --work work/ --split test --model mamba
    python -m surgical_tpu_torch.cli predict --work work/ --split test --online
    python -m surgical_tpu_torch.cli evaluate --gt data/cholec80/gt-phase --pred work/output/Test

A work dir holds ``index/<split>_{labels,num_each,video_ids}.npy``,
``lfb/<split>/`` (a ``FeatureStore``), and the port's checkpoint stores
``ckpt/temporal`` and ``ckpt/refiner`` (``core/checkpoint.py``; the JAX
package's orbax stores are not read). ``predict`` restores each store's best
step by ``val_acc`` and writes ``output/<Split>/video<NN>-phase.txt``. Every
video runs at its true length. The verbs run on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _work_paths(work: str) -> dict:
    return {
        "index": os.path.join(work, "index"),
        "lfb": os.path.join(work, "lfb"),
        "ckpt_temporal": os.path.join(work, "ckpt", "temporal"),
        "ckpt_refiner": os.path.join(work, "ckpt", "refiner"),
        "output": os.path.join(work, "output"),
    }


def _load_split(work: str, name: str):
    from surgical_tpu_torch.data.feature_store import FeatureStore
    from surgical_tpu_torch.train.temporal import VideoDataset

    idx = _work_paths(work)["index"]
    labels = np.load(os.path.join(idx, f"{name}_labels.npy"))
    num_each = np.load(os.path.join(idx, f"{name}_num_each.npy"))
    store = FeatureStore.open(os.path.join(_work_paths(work)["lfb"], name))
    starts = np.concatenate([[0], np.cumsum(num_each)[:-1]])
    # Cholec80 rows: [phase, 7 tools, 7 ant] (ant at 8:15, tecno.py:207-208);
    # M2CAI16 rows: [phase, 8 ant] (ant at 1:9, M2caiSegmapDataset)
    ant = labels[:, 8:15] if labels.shape[1] == 15 else labels[:, 1:]
    return VideoDataset(
        features=store,
        labels_phase=labels[:, 0].astype(np.int32),
        labels_ant=ant.astype(np.float32),
        lengths=np.asarray(num_each),
        starts=starts,
    )


def _split_video_ids(work: str, split: str, num_videos: int) -> list[int]:
    """Video numbers of a split, from the index manifest; the 41-offset
    fallback holds for Cholec80 val/test (get_path_labels.py:207-219)."""
    p = os.path.join(_work_paths(work)["index"], f"{split}_video_ids.npy")
    if os.path.exists(p):
        ids = np.load(p).tolist()
        assert len(ids) == num_videos, (len(ids), num_videos)
        return [int(v) for v in ids]
    return list(range(41, 41 + num_videos))


def _temporal_model(kind: str, device, f_dim: int = 2048):
    """The temporal model at the JAX CLI's default configuration."""
    from surgical_tpu_torch.core.config import MambaConfig, MSTCNConfig
    from surgical_tpu_torch.models.mamba import CausalMambaModel
    from surgical_tpu_torch.models.mstcn import MultiStageTCN

    if kind == "mamba":
        return CausalMambaModel(MambaConfig(f_dim=f_dim), device=device)
    return MultiStageTCN(MSTCNConfig(f_dim=f_dim), device=device)


def _restore_best(directory: str, model, device):
    from surgical_tpu_torch.core.checkpoint import CheckpointStore

    store = CheckpointStore(directory)
    step = store.best_step("val_acc")
    if step is None:
        raise FileNotFoundError(f"no checkpoint with a val_acc metric in {directory}")
    return store.restore(step, model, device)


def cmd_predict(args) -> int:
    from surgical_tpu_torch.core.config import RefinerConfig
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.train.refiner import predict_and_write

    device = resolve_device(args.device)
    paths = _work_paths(args.work)
    ds = _load_split(args.work, args.split)
    f_dim = ds.features.dim
    temporal = _restore_best(paths["ckpt_temporal"],
                             _temporal_model(args.model, device, f_dim), device)
    refiner = _restore_best(paths["ckpt_refiner"],
                            RefinementTransformer(RefinerConfig(f_dim=f_dim), device=device),
                            device)

    predict_fn = None
    if args.online:
        # the streaming pipeline (serving/online.py), one frame at a time
        from surgical_tpu_torch.serving.online import (OnlineMamba, OnlineMSTCN,
                                                       OnlineRefiner, run_pipeline)

        t_on = (OnlineMamba if args.model == "mamba" else OnlineMSTCN)(temporal)
        r_on = OnlineRefiner(refiner)
        predict_fn = lambda lfb: run_pipeline(t_on, r_on, lfb)

    video_ids = _split_video_ids(args.work, args.split, ds.num_videos)
    out_dir = os.path.join(paths["output"], args.split.capitalize())
    metrics, _, _ = predict_and_write(temporal, refiner, ds, out_dir, video_ids,
                                      predict_fn=predict_fn)
    print(json.dumps(metrics, indent=2, default=float))
    return 0


def cmd_evaluate(args) -> int:
    from surgical_tpu_torch.core.config import PHASE_NAMES
    from surgical_tpu_torch.eval.predictions import read_phase_txt, video_txt_name
    from surgical_tpu_torch.eval.relaxed import evaluate_videos

    gts, preds, missing = [], [], []
    for vid in range(args.first, args.last + 1):
        g = os.path.join(args.gt, video_txt_name(vid))
        p = os.path.join(args.pred, video_txt_name(vid))
        if not (os.path.exists(g) and os.path.exists(p)):
            # a silently shrunk mean would hide a failed prediction write
            missing.append((vid, "gt" if not os.path.exists(g) else "pred"))
            continue
        gts.append(read_phase_txt(g))
        preds.append(read_phase_txt(p))
    for vid, kind in missing:
        print(f"MISSING {kind} txt for video {vid:02d}", file=sys.stderr)
    if not gts:
        print("no evaluable videos in range", file=sys.stderr)
        return 1
    res = evaluate_videos(gts, preds)
    print(f"{'Phase':<26} {'Jaccard':>14} {'Precision':>14} {'Recall':>14}")
    for i, name in enumerate(PHASE_NAMES):
        print(f"{name:<26} {res.phase_mean_jacc[i]:6.2f}±{res.phase_std_jacc[i]:5.2f} "
              f"{res.phase_mean_prec[i]:6.2f}±{res.phase_std_prec[i]:5.2f} "
              f"{res.phase_mean_rec[i]:6.2f}±{res.phase_std_rec[i]:5.2f}")
    print(f"Mean Accuracy:  {res.mean_acc:.2f} ± {res.std_acc:.2f}")
    print(f"Mean Jaccard:   {res.mean_jacc:.2f} ± {res.std_jacc:.2f}")
    print(f"Mean Precision: {res.mean_prec:.2f} ± {res.std_prec:.2f}")
    print(f"Mean Recall:    {res.mean_rec:.2f} ± {res.std_rec:.2f}")
    if missing:
        print(f"evaluate: {len(missing)} of {args.last - args.first + 1} "
              "expected videos were missing (listed above) — metrics cover "
              "the remainder only", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="surgical_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("predict")
    sp.add_argument("--work", required=True)
    sp.add_argument("--split", choices=["val", "test"], default="test")
    sp.add_argument("--model", choices=["mstcn", "mamba"], default="mstcn")
    sp.add_argument("--online", action="store_true",
                    help="run the streaming pipeline (serving/online.py) frame by "
                         "frame instead of the offline composition")
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser("evaluate")
    sp.add_argument("--gt", required=True)
    sp.add_argument("--pred", required=True)
    sp.add_argument("--first", type=int, default=41)
    sp.add_argument("--last", type=int, default=80)
    sp.set_defaults(fn=cmd_evaluate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
