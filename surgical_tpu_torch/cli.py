"""Command-line interface of the port: the backbone-training and serving
verbs of ``surgical_tpu/cli.py`` over the same work-dir layout.

    python -m surgical_tpu_torch.cli train-backbone --work work/ --fused
    python -m surgical_tpu_torch.cli predict --work work/ --split test --model mamba
    python -m surgical_tpu_torch.cli predict --work work/ --split test --online
    python -m surgical_tpu_torch.cli evaluate --gt data/cholec80/gt-phase --pred work/output/Test

A work dir holds ``index/<split>_{labels,num_each,video_ids}.npy`` and
``index/<split>_paths.json``, ``lfb/<split>/`` (a ``FeatureStore``), and the
port's checkpoint stores ``ckpt/backbone``, ``ckpt/temporal`` and
``ckpt/refiner`` (``core/checkpoint.py``; the JAX package's orbax stores
are not read). ``train-backbone`` trains the frozen-trunk backbone on the
fused train kernels (``--fused``; the flax training graph is not ported)
and saves one step per epoch with its val/test metrics, the model's
parameters and BatchNorm statistics, and the optimizer state.
``predict`` restores each store's best step by ``val_acc`` and writes
``output/<Split>/video<NN>-phase.txt``. Every video runs at its true
length. The verbs run on the card unless ``--device`` names another
device.
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


def _clip_datasets(work: str, with_flow: bool) -> dict:
    from surgical_tpu_torch.data.datasets import ClipDataset

    idx = _work_paths(work)["index"]
    datasets = {}
    for name in ("train", "val", "test"):
        with open(os.path.join(idx, f"{name}_paths.json")) as f:
            paths = json.load(f)
        labels = np.load(os.path.join(idx, f"{name}_labels.npy"))
        ant_cols = (8, 15) if labels.shape[1] == 15 else (1, labels.shape[1])
        datasets[name] = ClipDataset(paths, labels, with_flow=with_flow, ant_cols=ant_cols)
    return datasets


def _backbone(args, device):
    """MiT-EVP + head from --variant / --no-flow (the JAX CLI's presets)."""
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
    from surgical_tpu_torch.models.mit_evp import MiTEVP

    cfg = BackboneConfig.preset(args.variant, with_flow=not args.no_flow)
    head = HeadConfig(embedding_dim=32, hidden=16) if args.variant == "tiny" else HeadConfig()
    return MiTEVP(cfg, head, device=device)


def cmd_train_backbone(args) -> int:
    """Stage-1 backbone training / stage-2 finetune (train_evp.py /
    finetune_evp.py): per epoch, train (mid-epoch validation every
    ``val_every`` steps on fresh random val batches), evaluate val and test,
    save a step with the metrics. ``--init-from`` is the finetune hand-off
    (best-by-val step of another store, fresh optimizer); ``--resume``
    continues from the latest step with the optimizer state."""
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.core.config import OptimConfig, TrainConfig
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.data.datasets import ClipSampler, clip_start_indices, prefetch_batches
    from surgical_tpu_torch.models.convert import load_mit_trunk, load_torch_pth
    from surgical_tpu_torch.train.backbone import BackboneTrainer, EarlyStop
    from surgical_tpu_torch.utils.logging import MetricsLogger

    device = resolve_device(args.device)
    model = _backbone(args, device)
    datasets = _clip_datasets(args.work, with_flow=not args.no_flow)
    # no gradient clipping in the reference backbone stage
    trainer = BackboneTrainer(
        model, TrainConfig(optim=OptimConfig(name=args.optimizer, lr=args.lr, weight_decay=0.0,
                                             grad_clip_norm=None)),
        use_fused=args.fused)
    opt = trainer.init()
    store = CheckpointStore(os.path.join(args.work, "ckpt", "backbone"))
    start_epoch = 0
    if args.resume and store.latest_step() is not None:
        step = store.latest_step()
        store.restore(step, model, device)
        opt.load_state_dict(store.restore_aux(step)["optimizer"])
        start_epoch = step + 1
        print(f"resumed full train state from epoch {step}")
    elif args.init_from:
        src = CheckpointStore(args.init_from)
        step = src.best_step("val_acc")
        step = step if step is not None else src.latest_step()
        src.restore(step, model, device)
        print(f"initialized from {args.init_from} step {step} (fresh optimizer)")
    elif args.pretrained_evp:
        model.load_state_dict(load_torch_pth(args.pretrained_evp), strict=True)
        print(f"loaded full EVP weights from {args.pretrained_evp}")
    elif args.pretrained:
        keys = load_mit_trunk(model, load_torch_pth(args.pretrained))
        print(f"loaded {len(keys)} trunk tensors from {args.pretrained}")
    logger = MetricsLogger(os.path.join(args.work, "logs", "backbone"))
    early = EarlyStop(args.early_stop_loss) if args.early_stop_loss else None

    idx_dir = _work_paths(args.work)["index"]
    num_each = {name: np.load(os.path.join(idx_dir, f"{name}_num_each.npy"))
                for name in ("train", "val", "test")}
    train_ds = datasets["train"]
    n_frames = len(train_ds)

    def midval_batches(epoch: int):
        """Fresh random val batches each epoch, as the reference draws from
        a shuffled val loader at every mid-epoch validation."""
        if args.midval_batches <= 0 or not len(datasets["val"]):
            return None
        take = np.random.default_rng([17, epoch]).permutation(len(datasets["val"]))[
            :args.midval_batches * args.batch_size]
        return list(prefetch_batches(datasets["val"], take, args.batch_size))

    def eval_batches(ds):
        return prefetch_batches(ds, np.arange(len(ds)), args.batch_size)

    for epoch in range(start_epoch, args.epochs):
        lengths = num_each["train"].tolist() if len(num_each["train"]) else [n_frames]
        idx = ClipSampler(1, clip_start_indices(1, lengths)).indices(epoch=epoch, shuffle=True)
        tm = trainer.train_epoch(prefetch_batches(train_ds, idx, args.batch_size), epoch,
                                 val_batches=midval_batches(epoch), logger=logger)
        vm = trainer.evaluate(eval_batches(datasets["val"]), num_each=num_each["val"])
        sm = trainer.evaluate(eval_batches(datasets["test"]), num_each=num_each["test"])
        metrics = {
            **{f"train_{k}" if not k.startswith("train") else k: v for k, v in tm.items()},
            **{f"val_{k}": v for k, v in vm.items()},
            **{f"test_{k}": v for k, v in sm.items()},
        }
        logger.log(epoch, metrics)
        store.save(epoch, model.state_dict(), metrics=metrics,
                   config={k: getattr(args, k) for k in ("variant", "scheme", "batch_size",
                                                         "lr", "optimizer")},
                   aux={"optimizer": opt.state_dict()})
        print(f"epoch {epoch}: loss={tm['train_loss']:.2f} acc={tm['train_acc']:.4f} "
              f"val_acc={vm.get('acc', float('nan')):.4f} "
              f"test_acc={sm.get('acc', float('nan')):.4f} "
              f"{tm['frames_per_s']:.0f} frames/s")
        if early is not None and early.update(tm["train_loss"] / max(n_frames, 1)):
            print(f"early stop: train loss below {args.early_stop_loss}")
            break
    logger.close()
    print("best epoch:", store.best_step("val_acc"))
    return 0


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

    sp = sub.add_parser("train-backbone")
    sp.add_argument("--work", required=True)
    sp.add_argument("--variant", default="b3")
    sp.add_argument("--scheme", choices=["stage1", "stage2"], default="stage1",
                    help="the work dir's split scheme, recorded in each step's manifest")
    sp.add_argument("--epochs", type=int, default=50)
    sp.add_argument("--batch-size", type=int, default=88)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--optimizer", default="sgd", choices=["sgd", "adam", "adamw"])
    sp.add_argument("--pretrained", default=None,
                    help="ImageNet SegFormer mit_b*.pth: its trunk keys load by name")
    sp.add_argument("--pretrained-evp", default=None,
                    help="reference stage-2 .pth (the full EVP model), loaded strictly")
    sp.add_argument("--early-stop-loss", type=float, default=None,
                    help="finetune mode: stop below this per-frame train loss")
    sp.add_argument("--no-flow", action="store_true")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint (model and optimizer state)")
    sp.add_argument("--init-from", default=None,
                    help="checkpoint store dir to initialize the model (parameters and "
                         "BatchNorm statistics) from: the stage-1 -> stage-2 hand-off")
    sp.add_argument("--midval-batches", type=int, default=2,
                    help="val batches for mid-epoch validation (0 disables)")
    sp.add_argument("--fused", action="store_true",
                    help="run the frozen trunk on the fused train kernels (forward and "
                         "backward); required, as the flax training graph is not ported")
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    sp.set_defaults(fn=cmd_train_backbone)

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
