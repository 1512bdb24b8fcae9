"""Training / evaluation CLI of the port.

The port of ``centerfusiondetect3d_tpu/main.py`` (reference
``src/main.py:19-131``)::

    python -m centerfusiondetect3d_tpu_torch.main [--cfg configs/X.yaml]
        [--device cuda|cpu] [KEY VALUE ...]

config resolution (a YAML file where pyyaml is installed, then dotted
overrides; overrides alone need no YAML reader), dataset and model
construction, a parameter census by module group, then ``EVAL`` ->
``Trainer.val`` (``test`` for a ``test`` split), else ``Trainer.train``.
It runs on the CUDA card unless ``--device`` names another device; images
are decoded on the same device (``data/image_io.py``). The run writes into
``OUTPUT_DIR/NAME/<timestamp>`` (the JAX package's ``output/NAME/...``,
``OUTPUT_DIR`` defaulting to ``output``): ``config.json``, ``train.log``,
``ckpts/`` and the submission and ``nuscenes_eval_det_output_<split>/``
of each validation, the run's ``metrics.jsonl`` and ``run_state.json``
and, where matplotlib is installed, ``losses.png`` and ``history.json``
(``runtime/fit.py``). The JAX package's compilation cache has no
counterpart here.

Several processes, one a card (the port's launcher in place of the JAX
package's ``jax.distributed`` cluster environment)::

    python -m torch.distributed.run --nproc_per_node N
        -m centerfusiondetect3d_tpu_torch.main [--device cuda|cpu] ...

Launched so (``WORLD_SIZE`` set), ``main`` starts the process group
(``parallel.initialize``): NCCL with ``--device cuda`` (the default), each
rank on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``. Rank 0 names the
run directory and alone writes ``config.json``, the checkpoints,
``metrics.jsonl`` and the scores; each rank trains on its shard of every
epoch and validates its shard of the split (``runtime/fit.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .config import default_config, finalize_config, update_config
from .data.dataset import get_dataset
from .parallel import distributed as parallel
from .runtime.fit import Trainer
from .utils.observability import create_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CenterFusionDetect3D (PyTorch)")
    p.add_argument("--cfg", default=None, help="yaml config file")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("opts", nargs="*", default=[], help="KEY VALUE overrides")
    return p.parse_args(argv)


def param_census(model) -> dict:
    """Parameter counts by module group (reference main.py:67-96)."""
    groups = {"backbone": 0, "neck": 0, "head": 0, "other": 0}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if top == "base":
            groups["backbone"] += p.numel()
        elif top in ("dla_up", "ida_up"):
            groups["neck"] += p.numel()
        elif top.startswith("detectHead"):
            groups["head"] += p.numel()
        else:
            groups["other"] += p.numel()
    groups["total"] = sum(groups.values())
    return groups


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    if parallel.launched():
        cpu = (args.device is not None
               and torch.device(args.device).type == "cpu")
        parallel.initialize(backend="gloo" if cpu else None)
    config = update_config(default_config(), args.cfg, args.opts)
    dataset_cls = get_dataset(config.DATASET.DATASET)
    logger, out_dir = create_logger(config.OUTPUT_DIR, config.NAME)
    config.defrost()
    config.OUTPUT_DIR = out_dir
    config = finalize_config(config, dataset_cls.num_categories,
                             dataset_cls.default_resolution)
    if parallel.is_main_process():
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(config.to_dict(), f, indent=1)

    val_split = config.DATASET.VAL_SPLIT
    dataset_val = dataset_cls(config, val_split, device=args.device)
    dataset_train = (None if config.EVAL else
                     dataset_cls(config, config.DATASET.TRAIN_SPLIT,
                                 device=args.device))
    trainer = Trainer(config, dataset_train, dataset_val, device=args.device,
                      logger=logger)
    if torch.distributed.is_initialized():
        logger.info("process group: %s, rank %d of %d on %s",
                    torch.distributed.get_backend(), parallel.rank(),
                    parallel.world_size(), trainer.device)
    logger.info("param census: %s", param_census(trainer.model))
    if config.EVAL:
        if val_split == "test":
            trainer.test()
        else:
            trainer.val()
    else:
        trainer.train()
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        parallel.shutdown()
