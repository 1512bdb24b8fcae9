"""The real-data dress rehearsal: raw nuScenes tables -> converter -> train
-> validate -> NDS ``metrics_summary.json``, in one command.

The port of ``centerfusiondetect3d_tpu/tools.py`` (its ``rehearse`` mode)::

    python -m centerfusiondetect3d_tpu_torch.tools rehearse [--dataroot DIR]
        [--out DIR] [--epochs N] [--load CKPT.pt] [--cfg X.yaml]
        [--train-split S] [--val-split S] [--device cuda|cpu] [KEY VALUE ...]

Without ``--dataroot`` it writes the synthetic raw tables
(``data/synthetic.py:make_synthetic_raw_tables``) under ``--out``; with it,
it converts the tables found there (``data/convert_nuscenes.py``) unless a
split's annotations exist already. Then it trains ``--epochs`` epochs at
the flagship composition (DLA-34 with DeformConv nodes, frustum middle
fusion, radar), validating after the last, or validates alone with
``--epochs 0``, and reads NDS back from the summary that scoring wrote.
It runs on the CUDA card unless ``--device`` names another device.

The JAX CLI's ``to-torch`` and ``to-native`` modes convert orbax
checkpoints to and from the reference ``.pt``. The port's only checkpoint
format is that ``.pt`` (``training/checkpoint.py``), so they have nothing
to convert: they exit with a message that says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

NO_COUNTERPART = (
    "{mode}: the port's checkpoints are reference .pt files already "
    "(training/checkpoint.py); there is no orbax checkpoint to convert. "
    "Pass a .pt to MODEL.LOAD_DIR or to rehearse --load.")


def _parse(argv):
    p = argparse.ArgumentParser(
        "python -m centerfusiondetect3d_tpu_torch.tools",
        description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["to-torch", "to-native", "rehearse"])
    p.add_argument("src", nargs="?", default=None,
                   help="to-torch / to-native: the checkpoint to convert")
    p.add_argument("--out", default=None, help="rehearse: run directory")
    p.add_argument("--cfg", default=None, help="yaml config (rehearse)")
    p.add_argument("--dataroot", default=None,
                   help="rehearse: raw nuScenes root (tables under "
                        "v1.0-*/); default generates synthetic tables")
    p.add_argument("--load", default=None,
                   help="rehearse: a .pt checkpoint to load before "
                        "training or validating")
    p.add_argument("--epochs", type=int, default=2,
                   help="rehearse: training epochs before the val pass "
                        "(0 = eval only)")
    p.add_argument("--train-split", default="mini_train",
                   help="rehearse: converter/train split (real data: train)")
    p.add_argument("--val-split", default="mini_val",
                   help="rehearse: converter/val split (real data: val)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("opts", nargs="*", default=[],
                   help="dotted config overrides")
    # intermixed: the dotted overrides may follow the options (a plain
    # parse_args leaves them unrecognized on some Python 3.12 releases)
    args = p.parse_intermixed_args(argv)
    if args.mode == "rehearse" and args.src is not None:
        # rehearse takes no src: the optional positional took the first KEY
        # of the dotted overrides; give it back
        args.opts = [args.src] + list(args.opts)
        args.src = None
    return args


def rehearse(args) -> int:
    """Raw tables -> converter -> [checkpoint] -> train ``args.epochs``
    epochs -> validate -> NDS; 0 when the validation wrote its
    ``metrics_summary.json``, else 1."""
    from ..config import default_config, finalize_config, update_config
    from ..data.convert_nuscenes import export_split
    from ..data.dataset import get_dataset
    from ..runtime.fit import Trainer

    out_dir = args.out or os.path.join("output", "rehearsal")
    os.makedirs(out_dir, exist_ok=True)
    train_split, val_split = args.train_split, args.val_split

    root = args.dataroot
    synthetic = root is None
    if synthetic:
        from ..data.synthetic import make_synthetic_raw_tables

        root = os.path.join(out_dir, "synthetic_nuscenes")
        if not os.path.exists(os.path.join(root, "v1.0-mini")):
            make_synthetic_raw_tables(root, {train_split: 4, val_split: 3})
            print(f"[rehearse] wrote synthetic raw tables -> {root}")

    # the dataset reads DATASET.ROOT + "nuscenes/annotations/...": take a
    # dataroot that is the nuscenes directory as it is, else link it in
    # from the writable out_dir (never inside the dataroot, which may be
    # read-only)
    root = os.path.abspath(root)
    if os.path.basename(root.rstrip("/")) == "nuscenes":
        data_root = os.path.dirname(root.rstrip("/"))
    else:
        data_root = os.path.join(os.path.abspath(out_dir), "data")
        os.makedirs(data_root, exist_ok=True)
        link = os.path.join(data_root, "nuscenes")
        if not os.path.exists(link):
            os.symlink(root, link)

    for split in (train_split, val_split):
        if os.path.exists(os.path.join(root, "annotations", f"{split}.json")):
            print(f"[rehearse] converter output exists for {split}, skipping")
            continue
        print(f"[rehearse] converting split {split} ...")
        export_split(root, split, verbose=False)

    # the flagship composition at rehearsal scale; opts override it (e.g.
    # MODEL.INPUT_SIZE "(448, 800)" TRAIN.BATCH_SIZE 26 on real data)
    base_opts = [
        "DATASET.ROOT", repr(data_root.rstrip("/") + "/"),
        "DATASET.TRAIN_SPLIT", repr(train_split),
        "DATASET.VAL_SPLIT", repr(val_split),
        "MODEL.DLA.NODE", "DeformConv",
        "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'",
        "DATASET.RADAR_PC", "True",
        "TRAIN.EPOCHS", str(max(args.epochs, 0)),
        "TRAIN.VAL_INTERVALS", str(max(args.epochs, 1)),
        "TRAIN.SAVE_INTERVALS", str(max(args.epochs, 1)),
        "EVAL", str(args.epochs == 0),
    ]
    if synthetic:
        base_opts += [
            "MODEL.INPUT_SIZE", "(96, 160)",
            "DATASET.PILLAR_DIMS", "(1.5, 0.6, 0.6)",
            "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "2",
            "MODEL.K", "8", "MIXED_PRECISION", "False", "WORKERS", "1",
            "TRAIN.LR", "1e-4", "TRAIN.WARM_EPOCHS", "0",
        ]
    if args.load:
        base_opts += ["MODEL.LOAD_DIR", repr(args.load)]
    cfg = update_config(default_config(), args.cfg,
                        base_opts + list(args.opts) + ["OUTPUT_DIR",
                                                       repr(out_dir)])
    dataset_cls = get_dataset(cfg.DATASET.DATASET)
    cfg = finalize_config(cfg, dataset_cls.num_categories,
                          dataset_cls.default_resolution)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=1)

    dataset_val = dataset_cls(cfg, val_split, device=args.device)
    if args.epochs > 0:
        dataset_train = dataset_cls(cfg, train_split, device=args.device)
        trainer = Trainer(cfg, dataset_train, dataset_val, device=args.device)
        trainer.train()  # VAL_INTERVALS == EPOCHS: ends with a validation
    else:
        trainer = Trainer(cfg, None, dataset_val, device=args.device)
        trainer.val()

    summary_path = os.path.join(
        out_dir, f"nuscenes_eval_det_output_{val_split}", "range_all",
        "metrics_summary.json")
    if not os.path.exists(summary_path):
        print(f"[rehearse] FAILED: no {summary_path}")
        return 1
    with open(summary_path) as f:
        metrics = json.load(f)
    print(f"[rehearse] OK  NDS={metrics.get('nd_score', float('nan')):.4f} "
          f"mAP={metrics.get('mean_ap', float('nan')):.4f} "
          f"({'synthetic tables' if synthetic else root})")
    return 0


def main(argv=None) -> int:
    args = _parse(argv)
    if args.mode == "rehearse":
        return rehearse(args)
    print(NO_COUNTERPART.format(mode=args.mode), file=sys.stderr)
    return 2
