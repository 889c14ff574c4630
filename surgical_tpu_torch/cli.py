"""Command-line interface of the port: the data, extraction, training,
serving and self-check verbs of ``surgical_tpu/cli.py`` over the same
work-dir layout.

    python -m surgical_tpu_torch.cli prepare-data --root data/cholec80 --out work/
    python -m surgical_tpu_torch.cli cache-frames --work work/
    python -m surgical_tpu_torch.cli extract-features --work work/ --frame-cache work/frame_cache
    python -m surgical_tpu_torch.cli extract-features --work work/ --weight-quant int8
    python -m torch.distributed.run --nproc-per-node 4 -m surgical_tpu_torch.cli \
        extract-features --work work/ --frame-cache work/frame_cache
    python -m surgical_tpu_torch.cli export-serving --work work/ --out serving/ [--fused]
    python -m surgical_tpu_torch.cli train-backbone --work work/
    python -m surgical_tpu_torch.cli train-backbone --work work/ --fused
    python -m surgical_tpu_torch.cli train-temporal --work work/ --model mamba
    python -m surgical_tpu_torch.cli train-refiner --work work/ --model mamba
    python -m surgical_tpu_torch.cli predict --work work/ --split test --model mamba
    python -m surgical_tpu_torch.cli predict --work work/ --split test --online
    python -m surgical_tpu_torch.cli train-temporal --work work/ --model jamba
    python -m surgical_tpu_torch.cli evaluate --gt data/cholec80/gt-phase --pred work/output/Test
    python -m surgical_tpu_torch.cli reference-parity --root data/cholec80 --work work/ \
        --evp evp.pth --temporal tecno.pth --refiner trans.pth --online
    python -m surgical_tpu_torch.cli precompute-flow --root data/cholec80 \
        --torch-checkpoint raft-things.pth [--batch-size 32]
    python -m surgical_tpu_torch.cli selfcheck
    python -m surgical_tpu_torch.cli selfcheck --full

A work dir holds ``index/<split>_{labels,num_each,video_ids}.npy`` and
``index/<split>_paths.json`` (``prepare-data``), ``frame_cache/<split>/``
(``cache-frames``), ``lfb/<split>/`` (a ``FeatureStore``,
``extract-features``), and the port's checkpoint stores ``ckpt/backbone``,
``ckpt/temporal`` and ``ckpt/refiner`` (``core/checkpoint.py``; the JAX
package's orbax stores are not read). ``train-backbone`` trains the
frozen-trunk backbone on the flax graph (``MiTEVP.graph_forward``, any
``--variant`` and ``--no-flow``), or with ``--fused`` on the fused train
kernels, evaluates on the flax graph in eval mode, and saves one step per
epoch with its val/test metrics, the model's parameters and BatchNorm
statistics, and the optimizer state. ``train-temporal`` and ``train-refiner`` train the temporal
model (MS-TCN or Mamba, the Mamba's scan on its forward and backward
kernels) and then the refiner on the frozen temporal model, one step per
epoch with the JAX manifest's metrics and the optimizer state (and the
plateau controller's) for ``--resume``; ``--model jamba`` is AI21-Jamba2-3B's
hybrid Mamba / attention stack (``models/jamba.py``) at its published widths.
``extract-features`` runs the backbone
of a reference ``.pth`` or of ``ckpt/backbone`` over every split: the serving
graph on the kernels (``models/mit_fused.py``) for a preset size, the flax
graph for ``--variant tiny`` on the card, the serving graph's plain versions
on the CPU; with ``--weight-quant int8`` the weights are held as int8 and
dequantized per batch. ``export-serving`` writes that backbone's serving
graph as a ``torch.export`` artifact (``serving/export.py``). ``precompute-flow`` runs RAFT (``models/raft.py``) over a data
root's 1-fps frames into ``raft_flow_npy/``, where ``ClipDataset`` and
``cache-frames`` read flow: ``--batch-size`` pairs of a video per call, the
decoded uint8 frames on the wire, mapped and padded to multiples of 8 on the
card, under the spans ``flow.load``, ``flow.h2d``, ``flow.forward`` (inside it
``flow.encode``, per iteration ``flow.lookup`` and ``flow.update``,
``flow.upsample``), ``flow.drain`` and ``flow.save``. ``predict`` restores each
store's best step by ``val_acc`` and writes
``output/<Split>/video<NN>-phase.txt``. Every video runs at its true
length. ``reference-parity`` goes from a data root and the reference's
three ``.pth`` files to the quality table. ``selfcheck`` trains and scores
both temporal stages on synthetic separable features; ``selfcheck --full``
runs the seven verbs from synthetic images to the relaxed evaluation with
two learned-quality gates. The verbs run on the card unless ``--device``
names another device.

Under ``torch.distributed.run`` (``WORLD_SIZE`` > 1) ``extract-features``
runs data-parallel: every rank iterates the same batches, reads only its
slice of each from the source, runs it on its own card (``--device cuda``:
``cuda:LOCAL_RANK``; ranks that name ``cuda:0`` share one card) and
all-gathers the features; rank 0 writes the stores and the pickles and
prints. The group's backend is NCCL on the card and gloo on the CPU, or
``--dist-backend``. Every other verb refuses to run under a world of more
than one rank: the JAX package computes them replicated on every chip, and
ranks writing the same files would race.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

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


class TemporalKind(NamedTuple):
    """A temporal model's classes, as "module:Name" under surgical_tpu_torch."""

    model: str
    config: str
    online: str  # its streaming step (predict --online)


# The temporal models: --model's choices.
TEMPORAL_KINDS = {
    "mstcn": TemporalKind("models.mstcn:MultiStageTCN", "core.config:MSTCNConfig",
                          "serving.online:OnlineMSTCN"),
    "mamba": TemporalKind("models.mamba:CausalMambaModel", "core.config:MambaConfig",
                          "serving.online:OnlineMamba"),
    "jamba": TemporalKind("models.jamba:JambaTemporalModel", "core.config:JambaConfig",
                          "serving.online:OnlineJamba"),
}


def _temporal_part(kind: str, part: str):
    """The class ``part`` ("model", "config" or "online") of ``kind``, imported."""
    import importlib

    mod, _, name = getattr(TEMPORAL_KINDS[kind], part).partition(":")
    return getattr(importlib.import_module("surgical_tpu_torch." + mod), name)


def _temporal_model(kind: str, device, f_dim: int = 2048, seed: int = 0):
    """The temporal model at its configuration's defaults (the JAX CLI's for
    MS-TCN and Mamba, AI21-Jamba2-3B's for Jamba)."""
    cfg = _temporal_part(kind, "config")(f_dim=f_dim)
    return _temporal_part(kind, "model")(cfg, seed=seed, device=device)


def _best_step(store) -> int:
    step = store.best_step("val_acc")
    if step is None:
        raise FileNotFoundError(f"no checkpoint with a val_acc metric in {store.directory}")
    return step


def _restore_best(directory: str, model, device):
    from surgical_tpu_torch.core.checkpoint import CheckpointStore

    store = CheckpointStore(directory)
    return store.restore(_best_step(store), model, device)


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
    """MiT-EVP + head from --variant / --depths / --no-flow / --head-dim /
    --head-hidden (the JAX CLI's ``_build_model``)."""
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
    from surgical_tpu_torch.models.mit_evp import MiTEVP

    overrides = {"with_flow": not args.no_flow}
    if getattr(args, "depths", None):
        overrides["depths"] = tuple(int(d) for d in args.depths.split(","))
    cfg = BackboneConfig.preset(args.variant, **overrides)
    head = HeadConfig(embedding_dim=32, hidden=16) if args.variant == "tiny" else HeadConfig()
    head_dim, head_hidden = getattr(args, "head_dim", None), getattr(args, "head_hidden", None)
    if head_dim or head_hidden:
        head = HeadConfig(embedding_dim=head_dim or head.embedding_dim,
                          hidden=head_hidden or head.hidden)
    return MiTEVP(cfg, head, device=device)


def _restore_backbone(args, model, device):
    """The frozen backbone that extraction runs (the JAX CLI's
    ``_restore_backbone_variables``): the reference stage-2 ``.pth``
    (``--pretrained-evp``, loaded strictly), else the port's
    ``ckpt/backbone`` store at ``--step``, else its best step by
    ``val_acc``, else its latest step, with parameters and BatchNorm
    statistics. Returns the restored step (None for a ``.pth``, for no
    ``--work`` or an empty store, which leave the model's own
    initialization)."""
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.models.convert import load_torch_pth

    if args.pretrained_evp:
        model.load_state_dict(load_torch_pth(args.pretrained_evp), strict=True)
        print(f"loaded full EVP stage-2 weights from {args.pretrained_evp}")
        return None
    if not args.work:
        return None
    store = CheckpointStore(os.path.join(args.work, "ckpt", "backbone"))
    step = args.step if args.step >= 0 else store.best_step("val_acc")
    step = step if step is not None else store.latest_step()
    if step is None:
        print(f"no backbone checkpoint under {args.work}: the model keeps its "
              "initialization", file=sys.stderr)
        return None
    store.restore(step, model, device)
    print(f"restored backbone checkpoint step {step}")
    return step


def cmd_prepare_data(args) -> int:
    """Index a Cholec80 / M2CAI16 root into ``index/`` (get_path_labels.py):
    per split the label table, frames per video, video ids and frame paths;
    optionally the reference's 9-element pickle."""
    from surgical_tpu_torch.data.cholec80 import index_dataset, make_splits, to_reference_pickle

    videos = index_dataset(args.root, num_videos=args.num_videos,
                           horizon=args.horizon, dataset=args.dataset)
    train, val, test = make_splits(videos, scheme=args.scheme)
    out = _work_paths(args.out)["index"]
    os.makedirs(out, exist_ok=True)
    for name, split in (("train", train), ("val", val), ("test", test)):
        np.save(os.path.join(out, f"{name}_labels.npy"), split.labels)
        np.save(os.path.join(out, f"{name}_num_each.npy"), np.asarray(split.num_each))
        np.save(os.path.join(out, f"{name}_video_ids.npy"),
                np.asarray(split.video_ids, dtype=np.int64))
        with open(os.path.join(out, f"{name}_paths.json"), "w") as f:
            json.dump(split.paths, f)
    if args.reference_pickle:
        to_reference_pickle(train, val, test, args.reference_pickle)
    print(f"indexed {len(videos)} videos -> {out}")
    return 0


def cmd_cache_frames(args) -> int:
    """Decode each split once into a packed memmap ``FrameCache`` (the
    reference's disk-cache idea, data_process.py:327-393), so extraction
    reads frames at page-cache speed. Resumable."""
    from surgical_tpu_torch.data.datasets import FrameCache

    datasets = _clip_datasets(args.work, with_flow=not args.no_flow)
    splits = [s.strip() for s in args.splits.split(",") if s.strip()] or list(datasets)
    out_root = args.out or os.path.join(args.work, "frame_cache")
    for name in splits:
        d = os.path.join(out_root, name)
        fc = FrameCache.build(datasets[name], d, batch_size=args.batch_size)
        print(f"{name}: {len(fc)} frames cached -> {d}")
    return 0


def cmd_extract_features(args) -> int:
    """LFB extraction (generate_evp_LFB.py): the frozen backbone over each
    split into ``lfb/<split>/`` FeatureStores, with ``--reference-pickles``
    also ``lfb/evp_LFB_<split>.pkl``. Batches run one after another through
    ``make_raw_feature_fn`` (the serving graph on the kernels); a split with
    a frame cache under ``--frame-cache`` is read from it. ``--chain-depth``
    is accepted for the JAX CLI's command lines and has no effect: there is
    no dispatch chain to build. An error raises; nothing is retried."""
    import torch.distributed as dist

    from surgical_tpu_torch.data.datasets import FrameCache, RankSlice, prefetch_batches
    from surgical_tpu_torch.kernels import mit_block
    from surgical_tpu_torch.parallel.mesh import init_from_env
    from surgical_tpu_torch.train.extract import extract_to_store, make_raw_feature_fn

    rank, world, device = init_from_env(args.device, args.dist_backend)
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} does not divide over {world} ranks")
    say = print if rank == 0 else (lambda *a, **k: None)
    model = _backbone(args, device)
    _restore_backbone(args, model, device)
    datasets = _clip_datasets(args.work, with_flow=not args.no_flow)
    wanted = [s.strip() for s in args.splits.split(",") if s.strip()] or list(datasets)
    if args.frame_cache:
        for name in list(datasets):
            d = os.path.join(args.frame_cache, name)
            if not FrameCache.exists(d):
                continue
            fc = FrameCache(d)
            # the cache must carry the modalities and size this run's model
            # takes: a flow-less cache under a flow model would skip the
            # flow fusion and write other features
            if not args.no_flow and not fc.meta["with_flow"]:
                raise SystemExit(f"{d}: cache was built --no-flow but this run's model uses "
                                 "flow fusion; rebuild the cache with flow or pass --no-flow")
            if fc.meta["resize"] != datasets[name].resize:
                raise SystemExit(f"{d}: cache resize={fc.meta['resize']} != run "
                                 f"resize={datasets[name].resize}; rebuild the cache")
            datasets[name] = fc
            say(f"{name}: serving frames from cache {d}")
    fn = make_raw_feature_fn(model, weight_quant=args.weight_quant,
                             group=dist.group.WORLD if world > 1 else None)
    idx = _work_paths(args.work)["index"]
    for name, ds in datasets.items():
        if name not in wanted:
            continue
        num_each = np.load(os.path.join(idx, f"{name}_num_each.npy"))
        source = RankSlice(ds, args.batch_size, rank, world)
        batches = ((i, s, f) for (i, s, f, _p, _a)
                   in prefetch_batches(source, np.arange(len(ds)), args.batch_size))
        before = mit_block.launch_counts()
        fstore, stats = extract_to_store(
            fn, batches, num_each.tolist(), feature_dim=model.head_cfg.embedding_dim,
            batch_size=args.batch_size, directory=os.path.join(_work_paths(args.work)["lfb"], name),
            meta={"split": name})
        say(f"{name}: {stats['frames']} frames at {stats['fps']:.0f} fps")
        if world > 1:
            launches = [None] * world
            dist.all_gather_object(launches, {k: n - before[k] for k, n
                                              in mit_block.launch_counts().items()})
            say(f"{name}: kernel launches per rank {json.dumps(launches)}")
        if args.reference_pickles and fstore is not None:
            fstore.to_reference_pickle(os.path.join(args.work, "lfb", f"evp_LFB_{name}.pkl"))
    if world > 1:
        dist.destroy_process_group()
    return 0


def cmd_export_serving(args) -> int:
    """Deployment export (the JAX CLI's ``export-serving``): the frozen
    serving graph, the wire-format dequant and the MiT-EVP forward with the
    weights that ``extract-features`` would restore, as a ``torch.export``
    artifact that ``serving/export.py::load_artifact`` runs without the
    model code. ``--fused`` exports the fused graph with the Hopper kernels
    as custom ops (bound to the card); the default is the flax graph."""
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.serving.export import export_feature_extractor, save_artifact

    device = resolve_device(args.device)
    model = _backbone(args, device)
    # the restore path of extract-features: an artifact carries exactly the
    # weights extraction would use
    step = _restore_backbone(args, model, device)
    if step is None and not args.pretrained_evp:
        if args.work:
            raise SystemExit(f"no backbone checkpoint under {args.work}")
        print("WARNING: exporting with RANDOM init (no --work / --pretrained-evp)",
              file=sys.stderr)
    exported = export_feature_extractor(
        model, args.batch_size, size=args.size, with_flow=not args.no_flow,
        features=not args.logits, use_fused=args.fused)
    save_artifact(args.out, exported, meta={
        "variant": args.variant, "checkpoint_step": step,
        "pretrained_evp": args.pretrained_evp, "size": args.size,
        "batch_size": args.batch_size, "with_flow": not args.no_flow,
        "output": "logits" if args.logits else "features", "fused": bool(args.fused)})
    with open(os.path.join(args.out, "manifest.json")) as f:
        platforms = json.load(f)["platforms"]
    print(f"wrote serving artifact to {args.out} (platforms={platforms})")
    return 0


def cmd_train_backbone(args) -> int:
    """Stage-1 backbone training / stage-2 finetune (train_evp.py /
    finetune_evp.py): per epoch, train (mid-epoch validation every
    ``val_every`` steps on fresh random val batches), evaluate val and test,
    save a step with the metrics. The step runs the flax graph, or the fused
    train kernels with ``--fused``. ``--init-from`` is the finetune hand-off
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


def cmd_train_temporal(args) -> int:
    """tecno.py: train the temporal model on the train split's LFB, evaluate
    val and test after every epoch, step the plateau controller on val
    accuracy, save one step per epoch (metrics, the optimizer state as aux,
    the plateau state in the manifest's extra). ``--resume`` continues from
    the latest step: parameters, optimizer moments, lr and plateau state."""
    import dataclasses

    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.core.config import OptimConfig, TrainConfig
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.train.temporal import TemporalTrainer

    device = resolve_device(args.device)
    optim = OptimConfig() if args.lr is None else dataclasses.replace(OptimConfig(), lr=args.lr)
    cfg = TrainConfig(max_epochs=args.epochs, optim=optim)
    train_ds, val_ds, test_ds = (_load_split(args.work, s) for s in ("train", "val", "test"))
    model = _temporal_model(args.model, device, train_ds.features.dim, seed=cfg.seed)
    trainer = TemporalTrainer(model, cfg)
    opt = trainer.init()
    store = CheckpointStore(_work_paths(args.work)["ckpt_temporal"])
    start_epoch = 0
    if args.resume and store.latest_step() is not None:
        step = store.latest_step()
        store.restore(step, model, device)
        opt.load_state_dict(store.restore_aux(step)["optimizer"])
        plateau = store.manifest(step).get("extra", {}).get("plateau") or {}
        trainer.plateau.best = plateau.get("best")
        trainer.plateau.bad_epochs = plateau.get("bad_epochs", 0)
        start_epoch = step + 1
        print(f"resumed from epoch {step}")
    seed = cfg.seed + 1
    for epoch in range(start_epoch, args.epochs):
        tm = trainer.train_epoch(opt, train_ds, seed, epoch)
        vm, _ = trainer.evaluate(val_ds)
        sm, _ = trainer.evaluate(test_ds)
        lr = trainer.plateau_step(opt, vm["acc_frame"])
        store.save(epoch, model.state_dict(), metrics={
            "val_acc": vm["acc_frame"], "test_acc": sm["acc_frame"], "val_inMAE": vm["inMAE"],
            "lr": lr, **{f"train_{k}": v for k, v in tm.items()},
        }, config={"model": args.model}, aux={"optimizer": opt.state_dict()}, extra={
            "plateau": {"best": trainer.plateau.best, "bad_epochs": trainer.plateau.bad_epochs},
        })
        print(f"epoch {epoch}: train_loss={tm['train_loss']:.4f} "
              f"val_acc={vm['acc_frame']:.4f} test_acc={sm['acc_frame']:.4f} "
              f"val MAE {vm['inMAE']:.3f}/{vm['pMAE']:.3f}/{vm['eMAE']:.3f}")
    print("best epoch:", store.best_step("val_acc"))
    return 0


def cmd_train_refiner(args) -> int:
    """tecno_trans.py: train the refiner on the frozen temporal model of
    ``--temporal-epoch`` (default: its best step by val accuracy), Adam at
    5e-4 without weight decay, one video per step; save one step per epoch
    with val accuracy and the optimizer state. ``--resume`` continues from
    the latest refiner step."""
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.core.config import OptimConfig, RefinerConfig, TrainConfig
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.train.refiner import RefinerTrainer

    device = resolve_device(args.device)
    train_ds, val_ds = _load_split(args.work, "train"), _load_split(args.work, "val")
    f_dim = train_ds.features.dim
    tstore = CheckpointStore(_work_paths(args.work)["ckpt_temporal"])
    step = args.temporal_epoch if args.temporal_epoch >= 0 else _best_step(tstore)
    temporal = tstore.restore(step, _temporal_model(args.model, device, f_dim), device)
    print(f"temporal model: epoch {step}")
    lr = args.lr if args.lr is not None else 5e-4
    cfg = TrainConfig(optim=OptimConfig(name="adam", lr=lr, weight_decay=0.0))
    refiner = RefinementTransformer(RefinerConfig(f_dim=f_dim), seed=1, device=device)
    trainer = RefinerTrainer(temporal, refiner, cfg)
    opt = trainer.init()
    store = CheckpointStore(_work_paths(args.work)["ckpt_refiner"])
    start_epoch = 0
    if args.resume and store.latest_step() is not None:
        step = store.latest_step()
        store.restore(step, refiner, device)
        opt.load_state_dict(store.restore_aux(step)["optimizer"])
        start_epoch = step + 1
        print(f"resumed refiner train state from epoch {step}")
    for epoch in range(start_epoch, args.epochs):
        tm = trainer.train_epoch(opt, train_ds, epoch)
        vm, _, _ = trainer.evaluate(val_ds)
        store.save(epoch, refiner.state_dict(),
                   metrics={"val_acc": vm["acc_frame"], **{f"train_{k}": v for k, v in tm.items()}},
                   config={"model": args.model}, aux={"optimizer": opt.state_dict()})
        print(f"epoch {epoch}: train_loss={tm['train_loss']:.4f} val_acc={vm['acc_frame']:.4f}")
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
        from surgical_tpu_torch.serving.online import OnlineRefiner, run_pipeline

        t_on = _temporal_part(args.model, "online")(temporal)
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
        if args.vis:
            from surgical_tpu_torch.eval.visualize import plot_ribbon

            os.makedirs(args.vis, exist_ok=True)
            m = min(len(gts[-1]), len(preds[-1]))
            plot_ribbon(gts[-1][:m], preds[-1][:m], f"video{vid:02d}",
                        os.path.join(args.vis, f"video{vid:02d}_vis.png"))
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


def cmd_reference_parity(args) -> int:
    """From the reference's data layout (``cutMargin/`` +
    ``phase_annotations/``, with segmaps and flow) and its three trained
    ``.pth`` files -- the stage-2 EVP backbone, ``MultiStageModel_S``
    (trans_SV_output.py:196-201) and the refiner ``Transformer``
    (:205-211) -- run index -> LFB extraction -> MS-TCN -> refiner ->
    predict -> relaxed evaluation and print the BASELINE.md quality table.
    The index and the val/test stores are reused when present; the temporal
    and refiner dims are read off their checkpoints. ``--online`` also
    streams the test split and reports its agreement with the offline
    predictions."""
    from surgical_tpu_torch.core.config import MSTCNConfig, RefinerConfig
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.eval.relaxed import evaluate_videos
    from surgical_tpu_torch.models.convert import (infer_mstcn_dims, infer_refiner_dims,
                                                   load_torch_pth)
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.serving.online import OnlineMSTCN, OnlineRefiner, run_pipeline
    from surgical_tpu_torch.train.refiner import predict_and_write

    device = resolve_device(args.device)
    paths = _work_paths(args.work)
    if not os.path.exists(os.path.join(paths["index"], "test_labels.npy")):
        if main(["prepare-data", "--root", args.root, "--out", args.work,
                 "--num-videos", str(args.num_videos), "--scheme", args.scheme]) != 0:
            raise RuntimeError("prepare-data failed")

    # LFB extraction with the reference EVP weights; existing stores are
    # reused unless --force-extract
    need = [s for s in ("val", "test")
            if args.force_extract or not os.path.exists(os.path.join(paths["lfb"], s,
                                                                     "manifest.json"))]
    if need:
        cmd = ["extract-features", "--work", args.work, "--variant", args.variant,
               "--pretrained-evp", args.evp, "--splits", ",".join(need),
               "--batch-size", str(args.batch_size), "--device", args.device]
        if args.no_flow:
            cmd.append("--no-flow")
        for flag, val in (("--depths", args.depths), ("--head-dim", args.head_dim),
                          ("--head-hidden", args.head_hidden)):
            if val:
                cmd += [flag, str(val)]
        if main(cmd) != 0:
            raise RuntimeError("extract-features failed")
    else:
        print("reusing existing LFB stores (pass --force-extract to redo)")

    tsd = load_torch_pth(args.temporal)
    td = infer_mstcn_dims(tsd)
    print(f"temporal checkpoint: {td}")
    temporal = MultiStageTCN(MSTCNConfig(dropout=0.0, **td), device=device)
    temporal.load_state_dict(tsd, strict=True)
    rsd = load_torch_pth(args.refiner)
    rd = infer_refiner_dims(rsd)
    print(f"refiner checkpoint: {rd}")
    refiner = RefinementTransformer(RefinerConfig(len_q=args.len_q, **rd), device=device)
    refiner.load_state_dict(rsd, strict=True)

    report = {}
    for split in ("val", "test"):
        ds = _load_split(args.work, split)
        vids = _split_video_ids(args.work, split, ds.num_videos)
        out_dir = os.path.join(paths["output"], split.capitalize())
        metrics, preds, _ = predict_and_write(temporal, refiner, ds, out_dir, vids)
        gts = [ds.labels_phase[s:s + n] for s, n in zip(ds.starts, ds.lengths)]
        res = evaluate_videos(gts, preds)
        report[split] = {
            **{k: float(v) for k, v in metrics.items() if np.isscalar(v)},
            "relaxed_acc": res.mean_acc, "relaxed_acc_std": res.std_acc,
            "relaxed_jacc": res.mean_jacc, "relaxed_jacc_std": res.std_jacc,
            "relaxed_prec": res.mean_prec, "relaxed_prec_std": res.std_prec,
            "relaxed_rec": res.mean_rec, "relaxed_rec_std": res.std_rec,
        }
        if split == "test" and args.online:
            t_on, r_on = OnlineMSTCN(temporal), OnlineRefiner(refiner)
            _, preds_on, _ = predict_and_write(
                temporal, refiner, ds, out_dir + "Online", vids,
                predict_fn=lambda lfb: run_pipeline(t_on, r_on, lfb))
            # every video, at its length, on both sides (no silent zip)
            if [p.shape for p in preds_on] != [p.shape for p in preds]:
                raise AssertionError(f"online predictions {[p.shape for p in preds_on]} != "
                                     f"offline {[p.shape for p in preds]}")
            agree = float(np.mean(np.concatenate([a == b for a, b in zip(preds, preds_on)])))
            report["online_offline_agreement"] = agree
            print(f"streaming (--online) vs offline prediction agreement under the "
                  f"reference weights: {agree:.4f}")

    out_path = os.path.join(args.work, "reference_parity.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print("\n== reference-parity quality table (compare BASELINE.md) ==")
    print(f"{'split':<6} {'acc_frame':>9} {'acc_video':>9} "
          f"{'inMAE':>7} {'pMAE':>7} {'eMAE':>7}")
    for split in ("val", "test"):
        m = report[split]
        print(f"{split:<6} {m['acc_frame']:9.4f} {m['acc_video']:9.4f} "
              f"{m['inMAE']:7.4f} {m['pMAE']:7.4f} {m['eMAE']:7.4f}")
    m = report["test"]
    print(f"relaxed (test): Acc {m['relaxed_acc']:.2f}±{m['relaxed_acc_std']:.2f}  "
          f"Jacc {m['relaxed_jacc']:.2f}±{m['relaxed_jacc_std']:.2f}  "
          f"Prec {m['relaxed_prec']:.2f}±{m['relaxed_prec_std']:.2f}  "
          f"Rec {m['relaxed_rec']:.2f}±{m['relaxed_rec_std']:.2f}")
    print(f"report -> {out_path}")
    return 0


def cmd_precompute_flow(args) -> int:
    """Optical-flow precompute (RAFT.py, surgical_tpu/cli.py:814-869):
    RAFT flow between 1-fps frame n and n+25 of every video under
    ``<root>/cutMargin/<v>/<n>.jpg`` into ``<root>/raft_flow_npy/<v>/<n>.npy``
    (``flow/precompute.py``: resumable, atomic, per-pair error-continue, one
    ``video <v>: {stats}`` line per video in
    ``<root>/flow_precompute_log.txt``). Weights: an upstream-layout
    ``--torch-checkpoint`` .pth (``raft-things.pth``), else the latest step of
    a port ``--checkpoint`` store, else the seeded initialization. RAFT runs
    in fp32 with TF32 off (``models/raft.py``), ``--batch-size`` pairs of a
    video per call: the decoded uint8 frames go to the card as they are and
    are mapped and padded there."""
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.data.datasets import load_image
    from surgical_tpu_torch.flow.precompute import FlowPrecomputeDriver
    from surgical_tpu_torch.models.convert import load_torch_pth
    from surgical_tpu_torch.models.raft import RAFT, make_flow_fn

    device = resolve_device(args.device)
    model = RAFT(iters=args.iters, device=device)
    if args.torch_checkpoint:
        model.load_state_dict(load_torch_pth(args.torch_checkpoint), strict=True)
    elif args.checkpoint:
        store = CheckpointStore(args.checkpoint)
        step = store.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {args.checkpoint}")
        store.restore(step, model, device)
    else:
        print("precompute-flow: no checkpoint given: RAFT runs its seeded initialization",
              file=sys.stderr)
    driver = FlowPrecomputeDriver(
        make_flow_fn(model), os.path.join(args.root, "raft_flow_npy"),
        log_path=os.path.join(args.root, "flow_precompute_log.txt"), batch_size=args.batch_size)
    img_root = os.path.join(args.root, "cutMargin")
    for video in sorted(os.listdir(img_root), key=lambda s: int(s) if s.isdigit() else 0):
        vdir = os.path.join(img_root, video)
        if not os.path.isdir(vdir):
            continue
        frames = sorted(int(f[:-4]) for f in os.listdir(vdir) if f.endswith(".jpg"))
        driver.run_video(video, frames,
                         lambda n, vdir=vdir: load_image(os.path.join(vdir, f"{n}.jpg")))
        print(f"video {video}: {driver.stats}")
    return 0


def _write_synthetic_corpus(root: str, num_videos: int = 4, frames: int = 8) -> None:
    """Synthetic Cholec80-layout corpus on disk: cutMargin jpgs, segmap jpgs
    (path-substitution layout), phase annotation txts. Phase blocks are
    painted into the images so a tiny backbone can actually learn them. A
    copy of the JAX CLI's writer (surgical_tpu/cli.py:871-899)."""
    from PIL import Image

    from surgical_tpu_torch.core.config import PHASE_NAMES

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "phase_annotations"), exist_ok=True)
    for v in range(1, num_videos + 1):
        img_dir = os.path.join(root, "cutMargin", str(v))
        seg_dir = os.path.join(root, "ss_Bimasks_pos_ep10", str(v))
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(seg_dir, exist_ok=True)
        phases_25 = np.repeat(np.arange(7), -(-frames * 25 // 7))[: frames * 25]
        with open(os.path.join(root, "phase_annotations", f"video{v:02d}-phase.txt"), "w") as f:
            f.write("Frame\tPhase\n")
            for i, p in enumerate(phases_25):
                f.write(f"{i}\t{PHASE_NAMES[p]}\n")
        for n in range(0, frames * 25, 25):
            p = int(phases_25[n])
            img = rng.integers(0, 80, (64, 64, 3), dtype=np.uint8)
            img[:, : 8 * (p + 1)] = 200  # phase-coded bright band
            Image.fromarray(img).save(os.path.join(img_dir, f"{n}.jpg"))
            seg = np.zeros((64, 64, 3), np.uint8)
            seg[: 8 * (p + 1)] = 255
            Image.fromarray(seg).save(os.path.join(seg_dir, f"{n}.jpg"))


def cmd_selfcheck_full(args) -> int:
    """Whole-pipeline drive over synthetic images through the CLI's verbs,
    as the JAX CLI's ``selfcheck --full`` (surgical_tpu/cli.py:901-1003):
    prepare-data -> train-backbone (tiny, flax graph, no flow) ->
    extract-features -> train-temporal -> train-refiner -> predict ->
    evaluate, each on ``--device``, then its two learned-quality gates: the
    backbone's best val accuracy and its last epoch's train accuracy above
    0.25 (chance is 1/7), and the predicted txts' frame accuracy at least
    0.75. Returns 0 when every verb succeeded and both gates hold."""
    import tempfile
    import time

    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.eval.predictions import read_phase_txt, video_txt_name, write_phase_txt

    dev = ["--device", args.device]

    def run(*argv) -> None:
        print(f"selfcheck --full: {argv[0]}", flush=True)
        t0 = time.perf_counter()
        if main(list(argv)) != 0:
            raise RuntimeError(f"selfcheck --full: {argv[0]} failed")
        print(f"selfcheck --full: {argv[0]} done in {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory() as td:
        root, work = os.path.join(td, "cholec80"), os.path.join(td, "work")
        # 21 frames per video = 3 per phase, as the JAX selfcheck --full
        _write_synthetic_corpus(root, num_videos=4, frames=21)
        run("prepare-data", "--root", root, "--out", work, "--num-videos", "4",
            "--scheme", "smoke")
        run("train-backbone", "--work", work, "--variant", "tiny", "--epochs", "4",
            "--batch-size", "8", "--lr", "0.02", "--no-flow", "--midval-batches", "1", *dev)
        run("extract-features", "--work", work, "--variant", "tiny", "--batch-size", "8",
            "--no-flow", *dev)
        run("train-temporal", "--work", work, "--epochs", "40", "--lr", "0.005", *dev)
        run("train-refiner", "--work", work, "--epochs", "15", "--lr", "0.005", *dev)
        run("predict", "--work", work, "--split", "test", *dev)

        # ground-truth txts from the index -> relaxed evaluation
        idx = _work_paths(work)["index"]
        labels = np.load(os.path.join(idx, "test_labels.npy"))
        num_each = np.load(os.path.join(idx, "test_num_each.npy"))
        video_ids = _split_video_ids(work, "test", len(num_each))
        gt_dir = os.path.join(td, "gt-phase")
        os.makedirs(gt_dir, exist_ok=True)
        off = 0
        for vid, n in zip(video_ids, num_each):
            write_phase_txt(os.path.join(gt_dir, video_txt_name(vid)),
                            labels[off:off + n, 0].astype(int))
            off += n
        pred_dir = os.path.join(_work_paths(work)["output"], "Test")
        run("evaluate", "--gt", gt_dir, "--pred", pred_dir,
            "--first", str(min(video_ids)), "--last", str(max(video_ids)))

        # the JAX selfcheck's learned-quality gates, with its margins: the
        # backbone's best val accuracy (1 video of 21 frames) and last train
        # accuracy (84 frames) above 0.25, chance being 1/7; the predicted
        # txts' frame accuracy at least 0.75
        bstore = CheckpointStore(os.path.join(work, "ckpt", "backbone"))
        steps = bstore.steps()
        bb = max(bstore.manifest(s)["metrics"]["val_acc"] for s in steps)
        bt = bstore.manifest(steps[-1])["metrics"]["train_acc"]
        correct = total = off = 0
        for vid, n in zip(video_ids, num_each):
            pred = read_phase_txt(os.path.join(pred_dir, video_txt_name(vid)))
            gt = labels[off:off + n, 0].astype(int)
            correct += int(np.sum(pred[:int(n)] == gt))
            total += int(n)
            off += int(n)
        acc = correct / total
        gates = {"backbone": bb > 0.25 and bt > 0.25, "pipeline": acc >= 0.75}
        print(f"selfcheck --full gate backbone: best val_acc {bb:.3f}, final train_acc "
              f"{bt:.3f} (both > 0.25): {'pass' if gates['backbone'] else 'FAIL'}")
        print(f"selfcheck --full gate pipeline: test frame acc {acc:.3f} (>= 0.75): "
              f"{'pass' if gates['pipeline'] else 'FAIL'}")
        if not all(gates.values()):
            print("SELFCHECK-FULL FAILED: a learned-quality gate did not hold", file=sys.stderr)
            return 1
        print(f"SELFCHECK-FULL OK: all 7 stages composed; learned gates: backbone val_acc="
              f"{bb:.3f}, pipeline frame acc={acc:.3f}")
        return 0


def cmd_selfcheck(args) -> int:
    """Synthetic end-to-end check of the temporal stages, as the JAX CLI's
    ``selfcheck``: separable features (label + 0.1 noise) of 3 videos,
    MS-TCN (2 stages x 4 layers, f_maps 16, dropout 0.1) trained 20 epochs
    at lr 1e-2, the refiner (f_maps 16) 10 epochs at Adam 5e-3, relaxed
    evaluation; passes when the refined frame accuracy exceeds 0.5.
    ``--full`` runs the whole pipeline from images (``cmd_selfcheck_full``)."""
    import tempfile

    from surgical_tpu_torch.core.config import MSTCNConfig, OptimConfig, RefinerConfig, TrainConfig
    from surgical_tpu_torch.core.device import resolve_device
    from surgical_tpu_torch.data.feature_store import FeatureStore
    from surgical_tpu_torch.eval.relaxed import evaluate_videos
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.train.refiner import RefinerTrainer
    from surgical_tpu_torch.train.temporal import TemporalTrainer, VideoDataset

    if args.full:
        return cmd_selfcheck_full(args)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    lengths = [60, 80, 70]
    n, f_dim = sum(lengths), 32
    labels = np.concatenate([np.repeat(np.arange(7), -(-L // 7))[:L] for L in lengths]
                            ).astype(np.int32)
    feats = rng.standard_normal((n, f_dim)).astype(np.float32) * 0.1 + labels[:, None]
    ant = rng.uniform(0, 1, (n, 7)).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        store = FeatureStore.create(os.path.join(td, "lfb"), feats, lengths)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        ds = VideoDataset(store, labels, ant, np.asarray(lengths), starts)

        cfg = TrainConfig(bucket_sizes=(128,), optim=OptimConfig(lr=1e-2))
        model = MultiStageTCN(MSTCNConfig(stages=2, layers=4, f_maps=16, f_dim=f_dim,
                                          dropout=0.1), device=device)
        trainer = TemporalTrainer(model, cfg)
        opt = trainer.init()
        for epoch in range(20):
            m = trainer.train_epoch(opt, ds, 1, epoch)
        ev, _ = trainer.evaluate(ds)
        print(f"temporal: loss={m['train_loss']:.3f} acc={ev['acc_frame']:.3f}")

        rtrainer = RefinerTrainer(
            model, RefinementTransformer(RefinerConfig(f_maps=16, f_dim=f_dim), seed=2,
                                         device=device),
            TrainConfig(bucket_sizes=(128,),
                        optim=OptimConfig(name="adam", lr=5e-3, weight_decay=0.0)))
        ropt = rtrainer.init()
        for epoch in range(10):
            rm = rtrainer.train_epoch(ropt, ds, epoch)
        rev, preds, _ = rtrainer.evaluate(ds)
        print(f"refiner: loss={rm['train_loss']:.3f} acc={rev['acc_frame']:.3f}")

        gts = [labels[s:s + L] for s, L in zip(starts, lengths)]
        res = evaluate_videos(gts, preds)
        print(f"relaxed acc={res.mean_acc:.2f} jacc={res.mean_jacc:.2f}")
        ok = rev["acc_frame"] > 0.5
        print("SELFCHECK", "OK" if ok else "WEAK")
        return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="surgical_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    schemes = ["stage1", "stage2", "m2cai", "m2cai_all", "smoke"]

    def backbone_flags(sp):
        sp.add_argument("--variant", default="b3")
        sp.add_argument("--no-flow", action="store_true")
        sp.add_argument("--depths", default=None,
                        help="override backbone depths, e.g. '2,1,1,1' (matching a "
                             "non-preset checkpoint)")
        sp.add_argument("--head-dim", type=int, default=None)
        sp.add_argument("--head-hidden", type=int, default=None)
        sp.add_argument("--batch-size", type=int, default=200)
        sp.add_argument("--chain-depth", type=int, default=16,
                        help="accepted for the JAX CLI's command lines; no effect (the port "
                             "dispatches per batch)")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")

    sp = sub.add_parser("prepare-data")
    sp.add_argument("--root", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--num-videos", type=int, default=80)
    sp.add_argument("--horizon", type=float, default=5.0)
    sp.add_argument("--dataset", choices=["cholec80", "m2cai16"], default="cholec80")
    sp.add_argument("--scheme", choices=schemes, default="stage2")
    sp.add_argument("--reference-pickle", default=None)
    sp.set_defaults(fn=cmd_prepare_data)

    sp = sub.add_parser("cache-frames",
                        help="pre-decode frames into packed memmap caches")
    sp.add_argument("--work", required=True)
    sp.add_argument("--out", default=None, help="cache root (default <work>/frame_cache)")
    sp.add_argument("--splits", default="")
    sp.add_argument("--batch-size", type=int, default=256)
    sp.add_argument("--no-flow", action="store_true")
    sp.set_defaults(fn=cmd_cache_frames)

    sp = sub.add_parser("extract-features")
    sp.add_argument("--work", required=True)
    backbone_flags(sp)
    sp.add_argument("--step", type=int, default=-1,
                    help="backbone checkpoint step (-1 = best by val_acc, else latest)")
    sp.add_argument("--pretrained-evp", default=None,
                    help="reference stage-2 .pth to extract with, loaded strictly")
    sp.add_argument("--reference-pickles", action="store_true")
    sp.add_argument("--splits", default="",
                    help="comma list of splits to extract (default: all)")
    sp.add_argument("--frame-cache", default=None,
                    help="frame-cache root (cache-frames output); splits with a cache are "
                         "read from it")
    sp.add_argument("--weight-quant", default=None, choices=["int8"],
                    help="opt-in int8 weights for the backbone (serving/quant.py), "
                         "dequantized to bf16 at each batch; not bit-compatible with the "
                         "reference's fp16 features. Its speed and drift on the H100 are in "
                         "PERF.md")
    sp.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process group backend under torch.distributed.run (default: nccl "
                         "on the card, gloo on the CPU); gloo lets ranks share one card")
    sp.set_defaults(fn=cmd_extract_features)

    sp = sub.add_parser(
        "export-serving",
        help="write the frozen serving graph (weights in the program) as a torch.export "
             "artifact")
    sp.add_argument("--out", required=True)
    sp.add_argument("--work", default=None)
    sp.add_argument("--variant", default="b3")
    sp.add_argument("--batch-size", type=int, default=200)
    sp.add_argument("--size", type=int, default=250)
    sp.add_argument("--step", type=int, default=-1)
    sp.add_argument("--pretrained-evp", default=None)
    sp.add_argument("--no-flow", action="store_true")
    sp.add_argument("--logits", action="store_true",
                    help="export (phase, anticipation) logits instead of LFB features")
    sp.add_argument("--fused", action="store_true",
                    help="export the fused graph with the Hopper kernels as custom ops (needs "
                         "surgical_tpu_torch.kernels.ops and the card at load time; default: "
                         "the portable flax graph)")
    sp.add_argument("--depths", default=None)
    sp.add_argument("--head-dim", type=int, default=None)
    sp.add_argument("--head-hidden", type=int, default=None)
    sp.add_argument("--device", default="cuda",
                    help="torch device to export on (default: the card)")
    sp.set_defaults(fn=cmd_export_serving)

    sp = sub.add_parser("reference-parity",
                        help="quality drive from the reference's data and .pth files to the "
                             "BASELINE quality table")
    sp.add_argument("--root", required=True,
                    help="data root with cutMargin/ + phase_annotations/ "
                         "(+ ss_Bimasks_pos_ep10/, raft_flow_npy/)")
    sp.add_argument("--work", required=True)
    sp.add_argument("--evp", required=True, help="stage-2 EVP .pth")
    sp.add_argument("--temporal", required=True, help="MultiStageModel_S .pth")
    sp.add_argument("--refiner", required=True, help="refiner Transformer .pth")
    backbone_flags(sp)
    sp.add_argument("--num-videos", type=int, default=80)
    sp.add_argument("--scheme", choices=schemes, default="stage2")
    sp.add_argument("--len-q", type=int, default=30,
                    help="refiner sliding window (trans_SV_output.py:157)")
    sp.add_argument("--force-extract", action="store_true")
    sp.add_argument("--online", action="store_true",
                    help="also stream the test split and report the online/offline "
                         "agreement")
    sp.set_defaults(fn=cmd_reference_parity)

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
                         "backward) instead of the flax graph; the default prompt "
                         "configuration only")
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    sp.set_defaults(fn=cmd_train_backbone)

    sp = sub.add_parser("train-temporal")
    sp.add_argument("--work", required=True)
    sp.add_argument("--model", choices=sorted(TEMPORAL_KINDS), default="mstcn")
    sp.add_argument("--epochs", type=int, default=25)
    sp.add_argument("--lr", type=float, default=None,
                    help="override the optimizer lr (default: OptimConfig)")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in the work dir")
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    sp.set_defaults(fn=cmd_train_temporal)

    sp = sub.add_parser("train-refiner")
    sp.add_argument("--work", required=True)
    sp.add_argument("--model", choices=sorted(TEMPORAL_KINDS), default="mstcn")
    sp.add_argument("--epochs", type=int, default=10)
    sp.add_argument("--lr", type=float, default=None,
                    help="override the optimizer lr (default 5e-4, tecno_trans.py:198-205)")
    sp.add_argument("--temporal-epoch", type=int, default=-1,
                    help="temporal checkpoint step (-1 = best by val_acc)")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the latest refiner checkpoint (parameters and "
                         "optimizer state)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    sp.set_defaults(fn=cmd_train_refiner)

    sp = sub.add_parser("predict")
    sp.add_argument("--work", required=True)
    sp.add_argument("--split", choices=["val", "test"], default="test")
    sp.add_argument("--model", choices=sorted(TEMPORAL_KINDS), default="mstcn")
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
    sp.add_argument("--vis", default=None, help="directory for GT/pred ribbon PNGs")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("precompute-flow", help="RAFT optical flow over a data root's frames")
    sp.add_argument("--root", required=True, help="dataset root with cutMargin/")
    sp.add_argument("--iters", type=int, default=20)
    sp.add_argument("--batch-size", type=int, default=32,
                    help="frame pairs of a video per RAFT call")
    sp.add_argument("--checkpoint", default=None, help="RAFT checkpoint store dir (the port's)")
    sp.add_argument("--torch-checkpoint", default=None,
                    help="upstream raft-things.pth to load (RAFT.py:36)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    sp.set_defaults(fn=cmd_precompute_flow)

    sp = sub.add_parser("selfcheck", help="synthetic end-to-end check of the temporal stages")
    sp.add_argument("--full", action="store_true",
                    help="the whole pipeline from synthetic images through the seven verbs, "
                         "with learned-quality gates")
    sp.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    sp.set_defaults(fn=cmd_selfcheck)

    args = p.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and args.cmd != "extract-features":
        raise SystemExit(f"{args.cmd} runs in one process (WORLD_SIZE={world}): only "
                         "extract-features runs over several ranks; the JAX package computes "
                         "the other verbs replicated, and ranks writing the same files would race")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
