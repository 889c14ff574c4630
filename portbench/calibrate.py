"""Readings for the limits of a cell's output check, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 21 22 23] [--seconds 10]

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the check) and prints every number the check compares. For
each control seed it does the same with the control in the program's
place: the reference computed one precision below the configuration's
(fp8 products for bf16, TF32 for fp32), which has to come out not correct.
The limit of each number is set between the sound runs' largest reading
and the control's smallest. With ``--fault half`` the program's training
step runs with half of each batch left out and its loss scaled as a mean
over the rest (planted in the program's trainer from here); with ``--fault
unchanged`` the step returns its state unchanged: the training cell's
upper readings. The benchmark's own runs do not run this.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
from harness import env  # noqa: E402

env.pin(ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from harness import core, files  # noqa: E402


def plant_half_batch() -> None:
    """Half of each training batch left out, the loss doubled as a mean
    over the rest would scale it."""
    backbone = files.resolve("surgical_tpu_torch.train.backbone:BackboneTrainer").__module__
    mod = sys.modules[backbone]
    train_step, loss = mod.BackboneTrainer.train_step, mod.backbone_loss

    def half(self, img, seg, flow, labels, ant, epoch=0, step=0, aug_params=None, masks=None):
        h = len(labels) // 2
        aug = type(aug_params)(*(t[:h] for t in aug_params))
        m = {"droppath": [(a[:h], b[:h]) for a, b in masks["droppath"]],
             "dropout": masks["dropout"][:h]}
        return train_step(self, img[:h], seg[:h], flow[:h], labels[:h], ant[:h], epoch, step,
                          aug, m)

    mod.BackboneTrainer.train_step = half
    mod.backbone_loss = lambda *a: tuple(2 * t for t in loss(*a))


def plant_unchanged() -> None:
    """A training step that returns its state unchanged: the loss and
    gradients are computed, no update and no BatchNorm statistics."""
    cls = files.resolve("surgical_tpu_torch.train.backbone:BackboneTrainer")

    def unchanged(self, img, seg, flow, labels, ant, epoch=0, step=0, aug_params=None,
                  masks=None):
        return self.loss_and_grad(img, seg, flow, labels, ant, epoch, step, aug_params, masks)[0]

    cls.train_step = unchanged


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=("half", "unchanged"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"calibrate: {core.smi_line()}", file=sys.stderr)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    wl = files.workload(args.workload)
    conf = files.config(wl["config"])
    if args.fault:
        {"half": plant_half_batch, "unchanged": plant_unchanged}[args.fault]()
    readings = {"program": {}, "control": {}}
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            ctx = core.Context(seed, dev, conf, wl, control=control)
            t = time.perf_counter()
            res = core.run_cell(ctx, args.seconds, t)
            row = {n: v for n, v, _ in res["checks"]}
            readings["control" if control else "program"][seed] = row
            print(json.dumps({"seed": seed, "control": control, "units": res["units"],
                              "correct": res["correct"], "checks": row,
                              "setup_s": res["setup_s"], "check_s": res["check_s"]}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    summary = {}
    for side in ("program", "control"):
        for row in readings[side].values():
            for n, v in row.items():
                s = summary.setdefault(n, {"program_max": None, "control_min": None})
                key = "program_max" if side == "program" else "control_min"
                better = max if side == "program" else min
                s[key] = v if s[key] is None else better(s[key], v)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
