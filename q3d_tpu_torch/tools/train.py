"""Training CLI (port of ``tools/train.py``): build the model and the
training data from a config, optionally load a checkpoint, and train with
``train_utils.train_model``, resuming from the newest checkpoint of the
run's directory.

    python -m q3d_tpu_torch.tools.train --cfg_file CFG [--batch_size B]
        [--epochs E] [--ckpt CKPT] [--fix_random_seed] [--extra_tag TAG]
        [--ckpt_save_interval N] [--max_ckpt_save_num N] [--device cpu]
        [--set KEY VALUE ...]

Checkpoints go to ``output/<cfg group>/<cfg name>/<extra_tag>/ckpt`` under
the repository root, as ``checkpoint_epoch_{n}.pth`` in pcdet's layout, so
``python -m q3d_tpu_torch.tools.test --ckpt`` reads them.  ``--ckpt`` takes
a pcdet ``.pth`` or the reference's native checkpoint.  ``--device``
defaults to the card (cuda, the kernels); ``cpu`` runs the plain versions.
"""

import argparse
import time
from pathlib import Path


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER,
                        help="override settings: KEY VALUE pairs")
    args = parser.parse_args(argv)

    from ..config import EDict, cfg_from_list, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(args.cfg_file, EDict())
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = "/".join(Path(args.cfg_file).parts[-3:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def main(argv=None):
    """Train as the command line (or ``argv``) asks -> (checkpoint
    directory, per-step history)."""
    args, cfg = parse_config(argv)
    from ..config import ROOT_DIR
    from ..datasets import build_dataloader
    from ..models import build_network
    from ..train_utils import train_model
    from ..utils import common_utils
    from ..utils.checkpoint import load_params_from_file

    if args.fix_random_seed:
        common_utils.set_random_seed(666)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    ckpt_dir = ROOT_DIR / "output" / cfg.EXP_GROUP_PATH / cfg.TAG \
        / args.extra_tag / "ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    logger = common_utils.create_logger()
    logger.info(f"device={args.device} batch_size={batch_size} "
                f"epochs={epochs} ckpt_dir={ckpt_dir}")

    train_set, train_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, training=True,
        logger=logger, seed=666 if args.fix_random_seed else None)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), train_set,
                          device=args.device)
    if args.ckpt is not None:
        load_params_from_file(model, args.ckpt, logger=logger)
    t0 = time.perf_counter()
    _, history = train_model(
        model, cfg.OPTIMIZATION, train_loader, ckpt_dir, total_epochs=epochs,
        device=args.device, logger=logger,
        ckpt_save_interval=args.ckpt_save_interval,
        max_ckpt_save_num=args.max_ckpt_save_num)
    wall = time.perf_counter() - t0
    logger.info(f"training finished: {len(history)} steps in {wall:.1f} s "
                f"({len(history) / max(wall, 1e-9):.2f} steps/s), last loss "
                f"{history[-1]['loss'] if history else float('nan'):.4f}")
    return ckpt_dir, history


if __name__ == "__main__":
    main()
